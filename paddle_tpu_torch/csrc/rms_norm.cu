// K3: fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:
// rms_norm_fused -> _fwd -> _kernel (one VMEM pass per (block_t, H) tile).
//
// out[t, :] = cast(x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * w), all in f32.
//
// Bound on this card: bytes. The function reads x once and w once and
// writes out once, 2*T*H*itemsize + H*itemsize bytes, against about 4
// flops per element; at 3.35 TB/s the bytes dominate by far.
//
// Design for that bound: one CTA of 256 threads per row. Each thread
// loads its share of the row with 16-byte vector loads (8 bf16 or 4 f32,
// neighbouring threads on neighbouring addresses) and keeps it in
// registers, so x is read from device memory exactly once. The sum of
// squares is reduced in f32 with warp shuffles and one shared-memory
// step; then each thread scales its registers by rsqrt and w and stores
// 16 bytes at a time. Rows up to 2048 vectors (16384 bf16 / 8192 f32)
// fit the register budget; the wrapper raises beyond that.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    const float* p = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = p[i];
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    float* p = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = f[i];
    return u;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __bfloat162float(p[i]);
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16(f[i]);
    return u;
  }
};

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int H, float eps) {
  constexpr int N = Vec<T>::N;
  const int nvec = H / N;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * H);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out + row * H);

  uint4 xv[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
      xv[i] = xr[idx];
      float f[N];
      Vec<T>::unpack(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  }

  __shared__ float red[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += red[i];
  const float r = rsqrtf(total / static_cast<float>(H) + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < nvec) {
      float f[N], g[N];
      Vec<T>::unpack(xv[i], f);
      Vec<T>::unpack(wr[idx], g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = (f[j] * r) * g[j];
      orow[idx] = Vec<T>::pack(f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int H,
                   float eps, cudaStream_t s) {
  const int nvec = H / Vec<T>::N;
  const int vpt = (nvec + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vpt <= 1)
    rms_norm_kernel<T, 1><<<rows, kThreads, 0, s>>>(xp, wp, op, H, eps);
  else if (vpt <= 2)
    rms_norm_kernel<T, 2><<<rows, kThreads, 0, s>>>(xp, wp, op, H, eps);
  else if (vpt <= 4)
    rms_norm_kernel<T, 4><<<rows, kThreads, 0, s>>>(xp, wp, op, H, eps);
  else if (vpt <= 8)
    rms_norm_kernel<T, 8><<<rows, kThreads, 0, s>>>(xp, wp, op, H, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and out are [rows, H], w is [H].
extern "C" int rms_norm_launch(const void* x, const void* w, void* out,
                               int rows, int H, float eps, int dtype,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
                      ? launch<float>(x, w, out, rows, H, eps, s)
                      : launch<__nv_bfloat16>(x, w, out, rows, H, eps, s);
  return static_cast<int>(e);
}
