// A check of csrc/philox.cuh, the hash behind attention dropout's mask in
// K1/K2 (flash_attention.cu): the repo's Philox4x32-10 and curand's
// curand_Philox4x32_10 on the same counters and keys, side by side. Only
// this check includes curand; the kernels never call it.
//
// n counters (4 words each) and n keys (2 words each) in; the repo's words
// into `mine`, curand's into `theirs`, 4 words per counter.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

__global__ void philox_pair(const uint4* ctr, const uint2* key, uint4* mine,
                            uint4* theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  mine[i] = philox::philox4x32_10(ctr[i], key[i].x, key[i].y);
  theirs[i] = curand_Philox4x32_10(ctr[i], key[i]);
}

}  // namespace

extern "C" int philox_check_launch(const void* ctr, const void* key,
                                   void* mine, void* theirs, int n,
                                   void* stream) {
  if (n <= 0) return 0;
  philox_pair<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ctr), static_cast<const uint2*>(key),
      static_cast<uint4*>(mine), static_cast<uint4*>(theirs), n);
  return static_cast<int>(cudaGetLastError());
}
