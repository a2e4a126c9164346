// K10: LLM.int8's linear for Hopper (sm_90a).
//
// A port-only kernel. It replaces what XLA makes of paddle_tpu/nn/quant.py
// llm_int8_linear (:97): the outlier decomposition of LLM.int8 (Dettmers et
// al., arXiv:2208.07339), whose int8 x int8 -> int32 product the JAX package
// leaves to XLA. There is no pallas_call to port.
//
//   xf        = x as f32                                   x [M, K], bf16 / f32
//   outlier_k = max_r |xf[r, k]| > threshold               over ALL rows
//   x_in      = xf with the outlier columns set to 0
//   a_scale_r = max(max_k |x_in[r, k]|, 1e-10) / 127       a true division
//   xq        = clip(rint(x_in / a_scale), -127, 127)      int8, half to even
//   acc       = xq q^T                                     int32, exact
//   y         = (f32(acc) * a_scale_r) * scale_n
//             + sum_{k outlier} xf[r, k] * (f32(q[n, k]) * scale_n)
//             (+ bias_n), rounded once to x's dtype
//
// q int8 [N, K] and scale f32 [N] come from weight_quantize(w, "llm.int8").
// Every step is rounded as the JAX function rounds it (__fdiv_rn, rintf,
// __fmul_rn, __fadd_rn: no contraction into an FMA, no fast math), so xq,
// a_scale and acc equal the plain version's bit for bit, and with no
// outlier column the output does too; the outlier sum is taken in another
// order than the plain version's matrix product.
//
// Bound on this card. At M = 2048 (prefill rows) operations: 2 M N K int8
// operations over 1979 TOP/s (0.0933 ms at [2048, 4096] x [11008, 4096]).
// At M = 8 (decode rows) bytes: the weight's N K bytes over 3.35 TB/s
// (45.1 MB, 0.0135 ms).
//
// Design, simple first (its speed is later work). One call is one memset
// and four kernels on the caller's stream; nothing reads back to the host,
// so a CUDA graph captures a call whole, and the outlier count lives only
// in device memory:
//
// colmax_kernel   the column absmax over all rows: each block a 256-column
//                 strip of 64 rows, atomicMax on the f32 bits (non-negative
//                 floats order as unsigned ints, so the result does not
//                 depend on the blocks' order).
// outlier_kernel  one block: the outlier columns compacted in ascending
//                 order (ballot, popc, a prefix over the warps) and their
//                 count.
// quant_kernel    a block a row: the row's absmax over the other columns,
//                 a_scale, and xq into a row pitch Kp (K rounded up to 64,
//                 the pad zero), so the product never reads past a row.
// gemm_kernel     128 x 128 output tiles, 8 warps of 64 x 32, K in steps of
//                 64 bytes through a 4-stage cp.async ring; the product on
//                 the int8 tensor cores, mma.sync m16n8k32 s8.s8 -> s32.
//                 The grid walks M fastest, so the blocks in flight share a
//                 few weight tiles and each weight byte comes from device
//                 memory about once. The epilogue stages 32 outlier columns
//                 at a time of x (as f32) and of the dequantized weight
//                 (f32(q) * scale, computed from the int8 bytes; no
//                 dequantized copy of the weight ever exists in device
//                 memory) into the ring's shared memory and adds their
//                 products in f32; a count of 0 skips the loop. Any count
//                 from 0 to K is right; a large one makes the epilogue an
//                 f32 product over the outlier columns on the CUDA cores.
//
// K rows whose byte length is not a multiple of 16 (or an unaligned q)
// take byte loads of the weights instead of cp.async (the wrapper's `vec`
// flag). The launch function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // output rows a block
constexpr int kBN = 128;      // output columns (weight rows) a block
constexpr int kBK = 64;       // k bytes a ring stage
constexpr int kPitch = 80;    // padded smem row (bytes): fragment reads
                              // of a warp hit 32 distinct banks
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kSmem = kStages * kStageBytes;   // 81920
constexpr int kOC = 32;       // outlier columns an epilogue chunk
constexpr int kOP = kOC + 1;  // padded f32 row of the chunk
static_assert(2 * kBM * kOP * 4 <= kSmem, "outlier chunk fits the ring");

constexpr int kColRows = 64;  // rows a colmax block
constexpr int kQuantThreads = 256;
constexpr int kOutlierThreads = 1024;

struct Args {
  const void* x;          // [M, K], f32 (dtype 0) or bf16 (dtype 1)
  const int8_t* q;        // [N, K]
  const float* scale;     // [N]
  const void* bias;       // [N] or null
  void* out;              // [M, N], x's dtype
  int32_t* acc_out;       // [M, N] or null: the raw int32 product
  const int8_t* xq;       // [M, Kp]
  const float* a_scale;   // [M]
  const unsigned* amax;   // [K], f32 bits
  const int* idx;         // [K], the first *count hold outlier columns
  const int* count;       // [1]
  int M, N, K, Kp, dtype, bias_code, vec;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_x(const void* x, int dtype, size_t i) {
  return dtype == 1 ? __bfloat162float(static_cast<const bf16*>(x)[i])
                    : static_cast<const float*>(x)[i];
}

// -- pre-pass ----------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) colmax_kernel(const T* x, int M, int K,
                                                     unsigned* amax) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= K) return;
  const int r0 = blockIdx.y * kColRows;
  const int r1 = min(r0 + kColRows, M);
  float m = 0.f;
  for (int r = r0; r < r1; ++r)
    m = fmaxf(m, fabsf(ld(x + static_cast<size_t>(r) * K + k)));
  atomicMax(amax + k, __float_as_uint(m));
}

__device__ __forceinline__ bool is_outlier(const unsigned* amax, int k,
                                           float thr) {
  return __uint_as_float(amax[k]) > thr;
}

__global__ void __launch_bounds__(kOutlierThreads)
    outlier_kernel(const unsigned* amax, float thr, int K, int* idx,
                   int* count) {
  __shared__ int warp_n[kOutlierThreads / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kOutlierThreads) {
    const int k = k0 + threadIdx.x;
    const bool o = k < K && is_outlier(amax, k, thr);
    const unsigned ball = __ballot_sync(0xffffffffu, o);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int before = base;
    for (int w = 0; w < warp; ++w) before += warp_n[w];
    if (o) idx[before + __popc(ball & ((1u << lane) - 1u))] = k;
    __syncthreads();  // every thread has read base and warp_n
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = 0; w < kOutlierThreads / 32; ++w) n += warp_n[w];
      base += n;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = base;
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_kernel(const T* x, const unsigned* amax, float thr, int K, int Kp,
                 int8_t* xq, float* a_scale) {
  __shared__ float red[kQuantThreads / 32];
  const int r = blockIdx.x;
  const T* xr = x + static_cast<size_t>(r) * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    if (!is_outlier(amax, k, thr)) m = fmaxf(m, fabsf(ld(xr + k)));
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-10f), 127.f);
  if (threadIdx.x == 0) a_scale[r] = s;
  int8_t* dst = xq + static_cast<size_t>(r) * Kp;
  for (int k = threadIdx.x; k < Kp; k += kQuantThreads) {
    int8_t v = 0;
    if (k < K && !is_outlier(amax, k, thr)) {
      const float y = fminf(fmaxf(rintf(__fdiv_rn(ld(xr + k), s)), -127.f),
                            127.f);
      v = static_cast<int8_t>(static_cast<int>(y));
    }
    dst[k] = v;
  }
}

// -- the int8 product ----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage kt of the tile: xq rows m0.. and weight rows n0.., k bytes 64 kt..
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* As,
                                           uint8_t* Bs, int m0, int n0,
                                           int kt) {
  const int k = kt * kBK;
  for (int i = threadIdx.x; i < kBM * (kBK / 16); i += kThreads) {
    const int r = i / (kBK / 16), ch = i % (kBK / 16);
    const int gr = m0 + r;
    const bool ok = gr < a.M;  // xq rows hold Kp bytes: no k bound
    cp_async16(As + r * kPitch + ch * 16,
               ok ? a.xq + static_cast<size_t>(gr) * a.Kp + k + ch * 16
                  : a.xq,
               ok);
  }
  for (int i = threadIdx.x; i < kBN * (kBK / 16); i += kThreads) {
    const int r = i / (kBK / 16), ch = i % (kBK / 16);
    const int gn = n0 + r, gk = k + ch * 16;
    uint8_t* dst = Bs + r * kPitch + ch * 16;
    const int8_t* src = a.q + static_cast<size_t>(gn) * a.K + gk;
    if (a.vec) {
      const bool ok = gn < a.N && gk < a.K;
      cp_async16(dst, ok ? src : a.q, ok);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gn < a.N && gk + e < a.K) ? static_cast<uint8_t>(src[e])
                                             : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = a.Kp / kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles)
      load_stage(a, smem + st * kStageBytes,
                 smem + st * kStageBytes + kBM * kPitch, m0, n0, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; step kt - 1 is done with its slot
    const int nx = kt + kStages - 1;
    if (nx < ktiles) {
      unsigned char* s = smem + (nx % kStages) * kStageBytes;
      load_stage(a, s, s + kBM * kPitch, m0, n0, nx);
    }
    cp_async_commit();

    const unsigned char* As = smem + (kt % kStages) * kStageBytes;
    const unsigned char* Bs = As + kBM * kPitch;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int kb = ks * 32 + 4 * t;
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* p = As + (wm * 64 + i * 16 + g) * kPitch + kb;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p = Bs + (wn * 32 + j * 8 + g) * kPitch + kb;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // the outlier columns' f32 term, 32 columns a chunk through the ring's
  // shared memory
  float yfp[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yfp[i][j][e] = 0.f;
  const int cnt = *a.count;
  float* Xs = reinterpret_cast<float*>(smem);
  float* Ws = Xs + kBM * kOP;
  for (int c0 = 0; c0 < cnt; c0 += kOC) {
    __syncthreads();  // the ring (or the last chunk) is no longer read
    for (int i = threadIdx.x; i < kBM * kOC; i += kThreads) {
      const int r = i / kOC, j = i % kOC;
      float xv = 0.f, wv = 0.f;
      if (c0 + j < cnt) {
        const int k = a.idx[c0 + j];
        if (m0 + r < a.M)
          xv = load_x(a.x, a.dtype, static_cast<size_t>(m0 + r) * a.K + k);
        if (n0 + r < a.N)
          wv = __fmul_rn(
              static_cast<float>(a.q[static_cast<size_t>(n0 + r) * a.K + k]),
              a.scale[n0 + r]);
      }
      Xs[r * kOP + j] = xv;
      Ws[r * kOP + j] = wv;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kOC; ++j) {
      float xr[4][2], wc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xr[i][h] = Xs[(wm * 64 + i * 16 + g + 8 * h) * kOP + j];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wc[jn][e] = Ws[(wn * 32 + jn * 8 + 2 * t + e) * kOP + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              yfp[i][jn][2 * h + e] =
                  fmaf(xr[i][h], wc[jn][e], yfp[i][jn][2 * h + e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (r >= a.M) continue;
      const float as = a.a_scale[r];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + jn * 8 + 2 * t + e;
          if (n >= a.N) continue;
          const int v = acc[i][jn][2 * h + e];
          const size_t o = static_cast<size_t>(r) * a.N + n;
          if (a.acc_out) a.acc_out[o] = v;
          float y = __fmul_rn(__fmul_rn(__int2float_rn(v), as), a.scale[n]);
          y = __fadd_rn(y, yfp[i][jn][2 * h + e]);
          if (a.bias_code == 0)
            y = __fadd_rn(y, static_cast<const float*>(a.bias)[n]);
          else if (a.bias_code == 1)
            y = __fadd_rn(y, __bfloat162float(
                                 static_cast<const bf16*>(a.bias)[n]));
          if (a.dtype == 1)
            static_cast<bf16*>(a.out)[o] = __float2bfloat16(y);
          else
            static_cast<float*>(a.out)[o] = y;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_prepass(const Args& a, float thr, unsigned* amax,
                           int* idx, int* count, int8_t* xq, float* a_scale,
                           cudaStream_t s) {
  const T* x = static_cast<const T*>(a.x);
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned) * a.K, s);
  if (e != cudaSuccess) return e;
  dim3 cgrid((a.K + 255) / 256, (a.M + kColRows - 1) / kColRows);
  colmax_kernel<T><<<cgrid, 256, 0, s>>>(x, a.M, a.K, amax);
  outlier_kernel<<<1, kOutlierThreads, 0, s>>>(amax, thr, a.K, idx, count);
  quant_kernel<T><<<a.M, kQuantThreads, 0, s>>>(x, amax, thr, a.K, a.Kp, xq,
                                                a_scale);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype 0 f32, 1 bf16) and out [M, N] in that dtype; q int8
// [N, K]; scale f32 [N]; bias [N] (bias_code -1 none, 0 f32, 1 bf16);
// acc_out int32 [M, N] or null. Work buffers the wrapper allocates: amax
// [K] (4 bytes each), idx int32 [K], count int32 [1], a_scale f32 [M], xq
// int8 [M, Kp] with Kp = K rounded up to 64. vec: K % 16 == 0 and q
// 16-byte aligned (cp.async of the weights).
extern "C" int llm_int8_linear_launch(
    const void* x, const void* q, const void* scale, const void* bias,
    void* out, void* acc_out, void* amax, void* idx, void* count,
    void* a_scale, void* xq, int M, int N, int K, int Kp, int dtype,
    int bias_code, float threshold, int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || Kp < K || Kp % kBK || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(xq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x,
         static_cast<const int8_t*>(q),
         static_cast<const float*>(scale),
         bias,
         out,
         static_cast<int32_t*>(acc_out),
         static_cast<const int8_t*>(xq),
         static_cast<const float*>(a_scale),
         static_cast<const unsigned*>(amax),
         static_cast<const int*>(idx),
         static_cast<const int*>(count),
         M, N, K, Kp, dtype, bias_code, vec};
  unsigned* am = static_cast<unsigned*>(amax);
  int* ix = static_cast<int*>(idx);
  int* cn = static_cast<int*>(count);
  int8_t* xqw = static_cast<int8_t*>(xq);
  float* as = static_cast<float*>(a_scale);
  cudaError_t e =
      dtype == 1
          ? launch_prepass<bf16>(a, threshold, am, ix, cn, xqw, as, s)
          : launch_prepass<float>(a, threshold, am, ix, cn, xqw, as, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(gemm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  gemm_kernel<<<grid, kThreads, kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
