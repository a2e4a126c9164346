// Philox4x32-10, the counter-based generator of attention dropout's mask
// (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the function curand exports as curand_Philox4x32_10). Written
// out here: the kernels never include curand. Its plain PyTorch twin is
// paddle_tpu_torch/ops/kernels/dropout_mask.py, which computes the same
// words with int64 tensor ops, so the two masks are equal bit for bit.
//
// The counter layout (the one definition; dropout_mask.py's docstring
// repeats it): the key is the call's 64-bit seed, k = {seed_lo, seed_hi};
// the element (batch row b, query head h, query row r, key column c) takes
// counter {c >> 3, r, h, b} (h the head's index in the whole model: a
// tensor-parallel rank adds its first head's), of its four output words
// the one numbered
// (c >> 1) & 3, and of that word the 16-bit half c & 1 (the low half for
// even c). The element is kept iff that half >= threshold = round(p 2^16)
// (0 .. 65536), which keeps it with probability 1 - p to within 2^-17; a
// kept probability is scaled by keep_scale = 1 / (1 - p) in f32. One hash
// thus decides eight keys of a row: keep_byte.
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key bumps

// the ten rounds, the key bumped between them
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  // the bumped keys are recomputed at each call (two adds a round) rather
  // than hoisted out of a kernel's loops into 18 registers
  asm volatile("" : "+r"(k0), "+r"(k1));
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// the keep bits of keys 8 g .. 8 g + 7 of (b, h, row): bit i keeps key
// 8 g + i (half i & 1 of word i >> 1)
__device__ __forceinline__ uint32_t keep_byte(uint32_t k0, uint32_t k1, int b,
                                              int h, int row, int g,
                                              uint32_t threshold) {
  const uint4 w = philox4x32_10(
      make_uint4(uint32_t(g), uint32_t(row), uint32_t(h), uint32_t(b)), k0,
      k1);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t bits = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bits |= (uint32_t((ws[i] & 0xFFFFu) >= threshold) << (2 * i)) |
            (uint32_t((ws[i] >> 16) >= threshold) << (2 * i + 1));
  return bits;
}

}  // namespace philox
