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
// Three bodies, each behind a pre-pass, chosen by the wrapper from the
// shapes and q's alignment alone (llm_int8_route). Nothing reads back to
// the host, so a CUDA graph captures a call whole, and the outlier count
// lives only in device memory.
//
// wgmma (M > 16, K % 16 == 0, q 16-byte aligned: what TMA addresses).
//   Pre-pass: a memset and three kernels. colmax (the column absmax over
//   all rows: 16 bytes of a row a thread where the rows allow, a block's
//   warps meeting in shared memory, then atomicMax on the f32 bits:
//   non-negative floats order as unsigned ints, so the result does not
//   depend on the blocks' order); outlier_kernel (one block: the outlier
//   columns compacted in ascending order by ballots and a scan, their
//   count, and a mask of a bit a column); quant_kernel (a block a row: the
//   row's absmax over the other columns, a_scale, xq in a row pitch Kp, K
//   rounded up to 64, the pad zero; x_out [kOutCap, M], x at the first
//   kOutCap outlier columns in f32, column-major; its extra blocks gather
//   w_out [kOutCap, N] = f32(q[n, k]) * scale[n] there). Every load of a
//   thread is in flight before its first use.
//   Product: y^T = q xq^T on wgmma m64n256k32 s8.s8 -> s32, both operands
//   straight from shared memory (int8 and K-major already: no conversion).
//   A tile is 128 weight rows x 256 xq rows; persistent CTAs, one an SM,
//   walk the tiles in groups of 2048 xq rows that stay in L2. A producer
//   warpgroup keeps a 4-slot ring of 128-byte k steps filled by TMA (the
//   128-byte swizzle, zeros past M, N and K: no masks) behind full and
//   empty mbarriers, across tiles, so a tile's epilogue overlaps the next
//   tile's loads; two consumer warpgroups issue the wgmmas. Epilogue: the
//   outlier term from x_out / w_out staged column-major by cp.async at the
//   tile's start (past kOC0 columns in chunks through the ring's room, past
//   kOutCap gathered at a stride of K: any count from 0 to K is right),
//   added in f32 to the int8 half; the outputs leave through a warp's
//   staging buffer as 16-byte stores.
// gemv (M <= 16, the same K and alignment). Pre-pass: one kernel, one
//   cluster of kSmallCtas CTAs over K slices: column absmax, the row maxima
//   over the other columns (shared through distributed shared memory),
//   a_scale, the compacted outlier list (each CTA's base from the others'
//   counts), x_out and xq. Product: one launch behind it with
//   programmatic dependent launch, so its first weight reads overlap the
//   pre-pass. y^T = q xq^T on mma.sync m16n8k32 s8: 16 weight rows are the
//   A operand, the xq rows B's n8 (two n8 tiles for 9 .. 16 rows). A CTA
//   of 4 warps owns 128 weight rows and one K slice; each lane streams
//   its own 16-byte pieces of the weights through a private cp.async ring
//   (read once, L2 only). The K slices of a column block run as one
//   cluster; each adds, for its 128 weight rows, the f32 term of its share
//   of the outlier columns (the weights gathered there by the CTA that owns
//   the rows: no w_out), and the CTA of rank c sums the slices' int32 sums
//   (exact in any order) and their outlier terms (in slice order) for rows
//   c, c + splits, ... through distributed shared memory before one
//   epilogue.
// mma (otherwise: rows whose byte length is not a multiple of 16, or an
//   unaligned q). The wgmma body's pre-pass without the gathers, then 128
//   x 128 output tiles, 8 warps of 64 x 32, K in steps of 64 bytes through
//   a 4-stage ring (cp.async for xq, byte loads for the weights); mma.sync
//   m16n8k32 s8. The epilogue stages 32 outlier columns at a time of x and
//   of f32(q) * scale, gathered at a stride of K, in the ring's room.
//
// The launch function returns cudaGetLastError() (or a launch's own
// error); a shape or pointer a body does not take returns
// cudaErrorInvalidValue. Nothing routes around the kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kOutCap = 64;   // outlier columns gathered once a call into
                              // x_out / w_out (LLM.int8 finds its
                              // outliers in a handful of feature
                              // dimensions); columns past it are gathered
                              // at a stride of K where they are used
constexpr int kOC = 32;       // outlier columns an epilogue chunk

// mma body
constexpr int kBM = 128;      // output rows a block
constexpr int kBN = 128;      // output columns (weight rows) a block
constexpr int kBK = 64;       // k bytes a ring stage
constexpr int kPitch = 80;    // padded smem row (bytes): fragment reads
                              // of a warp hit 32 distinct banks
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kSmem = kStages * kStageBytes;   // 81920
constexpr int kOP = kOC + 1;  // padded f32 row of the chunk
static_assert(2 * kBM * kOP * 4 <= kSmem, "outlier chunk fits the ring");

// pre-pass
constexpr int kColRows = 64;  // rows a colmax block
constexpr int kColRowsV = 128; // rows a colmax_vec block
constexpr int kHold = 6;       // 16-byte groups of its row a quant_kernel
                               // thread keeps between its passes
constexpr int kQuantThreads = 256;
constexpr int kOutlierThreads = 1024;
constexpr int kOutChunks = 16;  // chunks of kOutlierThreads columns a pass
constexpr int kGatherBlocks = 264;  // quant_kernel's w_out blocks
constexpr int kSmallCtas = 8;       // the M <= 16 pre-pass: one cluster
constexpr int kSmallThreads = 512;
constexpr int kSmallRows = 16;

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
  const float* x_out;     // [kOutCap, pad4(M)] (gemv, wgmma)
  const float* w_out;     // [kOutCap, pad4(N)] (wgmma)
  int M, N, K, Kp, dtype, bias_code, splits, ks;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_x(const void* x, int dtype, size_t i) {
  return dtype == 1 ? __bfloat162float(static_cast<const bf16*>(x)[i])
                    : static_cast<const float*>(x)[i];
}

// the row pitch of x_out and w_out: M or N rounded up to 4 floats, so a
// row starts on 16 bytes
__host__ __device__ __forceinline__ int pad4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float bias_at(const Args& a, int n) {
  if (a.bias_code == 0) return static_cast<const float*>(a.bias)[n];
  if (a.bias_code == 1)
    return __bfloat162float(static_cast<const bf16*>(a.bias)[n]);
  return 0.f;
}

// out[m, n] = ((f32(v) * as) * sc) + yfp (+ bias), each step rounded on its
// own, then once to x's dtype; acc_out[m, n] = v
__device__ __forceinline__ void finish(const Args& a, int m, int n, int v,
                                       float as, float sc, float bs,
                                       float yfp) {
  const size_t o = static_cast<size_t>(m) * a.N + n;
  if (a.acc_out) a.acc_out[o] = v;
  float y = __fmul_rn(__fmul_rn(__int2float_rn(v), as), sc);
  y = __fadd_rn(y, yfp);
  if (a.bias_code >= 0) y = __fadd_rn(y, bs);
  if (a.dtype == 1)
    static_cast<bf16*>(a.out)[o] = __float2bfloat16(y);
  else
    static_cast<float*>(a.out)[o] = y;
}

// f32(q[n, k]) * scale[n] at outlier column j: the epilogue's weight value
__device__ __forceinline__ float w_gather(const Args& a, int n, int j) {
  return __fmul_rn(
      static_cast<float>(a.q[static_cast<size_t>(n) * a.K + a.idx[j]]),
      a.scale[n]);
}

// x[m] at outlier column j: the gathered copy below kOutCap, else x itself
__device__ __forceinline__ float x_outlier(const Args& a, int m, int j) {
  return j < kOutCap
             ? a.x_out[static_cast<size_t>(j) * pad4(a.M) + m]
             : load_x(a.x, a.dtype,
                      static_cast<size_t>(m) * a.K + a.idx[j]);
}

__device__ __forceinline__ float quant(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// -- pre-pass (mma and wgmma bodies) -------------------------------------------
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

// the same over 16 bytes of a row a thread (V columns): a block is 32
// column groups (a warp's lanes) x kColRowsV rows (warp w takes rows w, w +
// 8, ...); the warps' maxima meet in shared memory before one atomicMax a
// column. Rows of a multiple of 16 bytes from a 16-byte-aligned x.
template <typename T>
__global__ void __launch_bounds__(256)
    colmax_vec_kernel(const T* x, int M, int K, unsigned* amax) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[8][V][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = (blockIdx.x * 32 + lane) * V;
  const int r0 = blockIdx.y * kColRowsV;
  float m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = 0.f;
  if (k < K) {
    // every row's load in flight before the first use (in-order issue
    // would wait on each)
    uint4 v[kColRowsV / 8];
#pragma unroll
    for (int i = 0; i < kColRowsV / 8; ++i) {
      const int r = r0 + warp + 8 * i;
      v[i] = r < M ? *reinterpret_cast<const uint4*>(
                         x + static_cast<size_t>(r) * K + k)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kColRowsV / 8; ++i) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int c = 0; c < V; ++c) m[c] = fmaxf(m[c], fabsf(ld(e + c)));
    }
  }
#pragma unroll
  for (int c = 0; c < V; ++c) red[warp][c][lane] = m[c];
  __syncthreads();
  // thread (warp c, lane): column k + c of this lane's group
  if (warp < V && k < K) {
    float mm = red[0][warp][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) mm = fmaxf(mm, red[w][warp][lane]);
    atomicMax(amax + k + warp, __float_as_uint(mm));
  }
}

__device__ __forceinline__ bool is_outlier(const unsigned* amax, int k,
                                           float thr) {
  return __uint_as_float(amax[k]) > thr;
}

// One block over kOutChunks chunks of kOutlierThreads columns at a time,
// their loads in flight together. A warp's ballot over a chunk's 32 columns
// is that word of the outlier mask (bit k % 32 of word k / 32); its
// popcounts, in (chunk, warp) order and scanned by one warp, give each
// warp-chunk the position of its first outlier in the ascending list.
__global__ void __launch_bounds__(kOutlierThreads)
    outlier_kernel(const unsigned* amax, float thr, int K, int* idx,
                   int* count, unsigned* mask) {
  constexpr int W = kOutlierThreads / 32;
  __shared__ int table[kOutChunks][W];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int k0 = 0; k0 < K; k0 += kOutChunks * kOutlierThreads) {
    float am[kOutChunks];  // every load in flight before the first use
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int k = k0 + c * kOutlierThreads + threadIdx.x;
      am[c] = k < K ? __uint_as_float(amax[k]) : 0.f;
    }
    bool o[kOutChunks];
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int k = k0 + c * kOutlierThreads + threadIdx.x;
      o[c] = k < K && am[c] > thr;
    }
    unsigned ball[kOutChunks];
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      ball[c] = __ballot_sync(0xffffffffu, o[c]);
      const int k = k0 + c * kOutlierThreads + 32 * warp;
      if (lane == 0) {
        table[c][warp] = __popc(ball[c]);
        if (k < K) mask[k >> 5] = ball[c];
      }
    }
    __syncthreads();
    if (warp == 0) {
      int run = carry;
      for (int c = 0; c < kOutChunks; ++c) {
        const int v = table[c][lane];
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += u;
        }
        table[c][lane] = run + incl - v;
        run += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) carry = run;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c)
      if (o[c])
        idx[table[c][warp] + __popc(ball[c] & ((1u << lane) - 1u))] =
            k0 + c * kOutlierThreads + threadIdx.x;
    __syncthreads();  // the table is read before the next chunks
  }
  if (threadIdx.x == 0) *count = carry;
}

// blocks 0 .. M - 1: row r's scale, xq and (x_out) its first kOutCap outlier
// columns; blocks M .. M + kGatherBlocks - 1 (w_out): f32(q) * scale at
// those columns. VEC: 16 bytes of x (V columns) a thread a step, their
// outlier bits from the mask (rows of a multiple of 16 bytes from a
// 16-byte-aligned x); else a column a thread, its bit from amax.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
    quant_kernel(const Args a, float thr, int8_t* xq, float* a_scale,
                 float* x_out, float* w_out) {
  if (blockIdx.x >= a.M) {
    const int c = min(*a.count, kOutCap);
    const long long total = static_cast<long long>(a.N) * c;
    for (long long i = static_cast<long long>(blockIdx.x - a.M) *
                           kQuantThreads + threadIdx.x;
         i < total; i += static_cast<long long>(kGatherBlocks) *
                         kQuantThreads) {
      const int j = static_cast<int>(i / a.N), n = static_cast<int>(i % a.N);
      w_out[static_cast<size_t>(j) * pad4(a.N) + n] = w_gather(a, n, j);
    }
    return;
  }
  __shared__ float red[kQuantThreads / 32];
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const unsigned* mask = a.amax + a.K;
  const int r = blockIdx.x;
  const T* xr = static_cast<const T*>(a.x) + static_cast<size_t>(r) * a.K;
  float m = 0.f;
  // VEC: the first kHold groups of a thread stay in registers for pass 2
  uint4 hold[VEC ? kHold : 1];
  auto absmax = [&](const uint4& v, int k) {
    const T* e = reinterpret_cast<const T*>(&v);
    const unsigned bits = mask[k >> 5] >> (k & 31);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (!((bits >> i) & 1u)) m = fmaxf(m, fabsf(ld(e + i)));
  };
  if constexpr (VEC) {
    // every load in flight before the first use
#pragma unroll
    for (int it = 0; it < kHold; ++it) {
      const int k = V * (threadIdx.x + it * kQuantThreads);
      hold[it] = k < a.K ? *reinterpret_cast<const uint4*>(xr + k)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < kHold; ++it) {
      const int k = V * (threadIdx.x + it * kQuantThreads);
      if (k < a.K) absmax(hold[it], k);
    }
    for (int k = V * (threadIdx.x + kHold * kQuantThreads); k < a.K;
         k += V * kQuantThreads)
      absmax(*reinterpret_cast<const uint4*>(xr + k), k);
  } else {
    for (int k = threadIdx.x; k < a.K; k += kQuantThreads)
      if (!is_outlier(a.amax, k, thr)) m = fmaxf(m, fabsf(ld(xr + k)));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-10f), 127.f);
  if (threadIdx.x == 0) a_scale[r] = s;
  int8_t* dst = xq + static_cast<size_t>(r) * a.Kp;
  if constexpr (VEC) {
    auto put = [&](const uint4& v, int k) {
      const T* e = reinterpret_cast<const T*>(&v);
      const unsigned bits = mask[k >> 5] >> (k & 31);
      uint32_t w[V / 4];
#pragma unroll
      for (int i = 0; i < V / 4; ++i) w[i] = 0;
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (!((bits >> i) & 1u))
          w[i / 4] |= (static_cast<uint32_t>(static_cast<int>(
                           quant(ld(e + i), s))) & 0xFFu)
                      << (8 * (i % 4));
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(dst + k) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst + k) = w[0];
    };
#pragma unroll
    for (int it = 0; it < kHold; ++it) {
      const int k = V * (threadIdx.x + it * kQuantThreads);
      if (k < a.K) put(hold[it], k);
    }
    for (int k = V * (threadIdx.x + kHold * kQuantThreads); k < a.K;
         k += V * kQuantThreads)
      put(*reinterpret_cast<const uint4*>(xr + k), k);
    for (int k = a.K + threadIdx.x; k < a.Kp; k += kQuantThreads) dst[k] = 0;
  } else {
    for (int k = threadIdx.x; k < a.Kp; k += kQuantThreads) {
      int8_t v = 0;
      if (k < a.K && !is_outlier(a.amax, k, thr))
        v = static_cast<int8_t>(static_cast<int>(quant(ld(xr + k), s)));
      dst[k] = v;
    }
  }
  if (x_out) {
    const int c = min(*a.count, kOutCap);
    for (int j = threadIdx.x; j < c; j += kQuantThreads)
      x_out[static_cast<size_t>(j) * pad4(a.M) + r] = ld(xr + a.idx[j]);
  }
}

// -- pre-pass (gemv body, M <= 16): one cluster ------------------------------
// CTA `rank` owns columns [rank * per, (rank + 1) * per). Pass 1: each
// column's absmax, whether it is an outlier, the rows' maxima over the
// other columns and the count; the cluster shares the row maxima and the
// counts. Pass 2: the outlier list in ascending order from this CTA's
// base, x_out, and xq.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
    small_prepass_kernel(const Args a, float thr, unsigned* amax, int* idx,
                         int* count, int8_t* xq, float* a_scale,
                         float* x_out) {
  __shared__ float wmax[kSmallThreads / 32][kSmallRows];
  __shared__ int wn[kSmallThreads / 32];
  __shared__ float cta_max[kSmallRows];  // read by the cluster
  __shared__ int cta_n;                  // read by the cluster
  __shared__ float row_scale[kSmallRows];
  __shared__ int base;
  // the product behind this kernel may start streaming its weights
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const T* x = static_cast<const T*>(a.x);
  const int M = a.M, K = a.K;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = ((K + kSmallCtas - 1) / kSmallCtas + 31) & ~31;
  const int k0 = rank * per, k1 = min(K, k0 + per);

  float rm[kSmallRows];
#pragma unroll
  for (int r = 0; r < kSmallRows; ++r) rm[r] = 0.f;
  int n = 0;
  for (int k = k0 + threadIdx.x; k < k1; k += kSmallThreads) {
    float v[kSmallRows];  // every row's load in flight before the first use
#pragma unroll
    for (int r = 0; r < kSmallRows; ++r)
      v[r] = r < M ? ld(x + static_cast<size_t>(r) * K + k) : 0.f;
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < kSmallRows; ++r) {
      v[r] = fabsf(v[r]);
      m = fmaxf(m, v[r]);
    }
    amax[k] = __float_as_uint(m);
    if (m > thr) {
      ++n;
    } else {
#pragma unroll
      for (int r = 0; r < kSmallRows; ++r) rm[r] = fmaxf(rm[r], v[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kSmallRows; ++r)
#pragma unroll
    for (int o = 16; o; o >>= 1)
      rm[r] = fmaxf(rm[r], __shfl_xor_sync(0xffffffffu, rm[r], o));
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kSmallRows; ++r) wmax[warp][r] = rm[r];
    wn[warp] = n;
  }
  __syncthreads();
  if (threadIdx.x < kSmallRows) {
    float m = 0.f;
    for (int w = 0; w < kSmallThreads / 32; ++w)
      m = fmaxf(m, wmax[w][threadIdx.x]);
    cta_max[threadIdx.x] = m;
  }
  if (threadIdx.x == 32) {
    int s = 0;
    for (int w = 0; w < kSmallThreads / 32; ++w) s += wn[w];
    cta_n = s;
  }
  hopper::cluster_sync();
  if (threadIdx.x < kSmallRows) {
    float v[kSmallCtas];  // every remote load in flight, then the max
#pragma unroll
    for (int c = 0; c < kSmallCtas; ++c)
      v[c] = hopper::ld_cluster(&cta_max[threadIdx.x], c);
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < kSmallCtas; ++c) m = fmaxf(m, v[c]);
    const float s = __fdiv_rn(fmaxf(m, 1e-10f), 127.f);
    row_scale[threadIdx.x] = s;
    if (rank == 0 && static_cast<int>(threadIdx.x) < M)
      a_scale[threadIdx.x] = s;
  }
  if (threadIdx.x == 32) {
    int v[kSmallCtas];
#pragma unroll
    for (int c = 0; c < kSmallCtas; ++c) v[c] = hopper::ld_cluster(&cta_n, c);
    int b = 0, total = 0;
#pragma unroll
    for (int c = 0; c < kSmallCtas; ++c) {
      total += v[c];
      if (c < rank) b += v[c];
    }
    base = b;
    if (rank == 0) *count = total;
  }
  __syncthreads();

  for (int kb = k0; kb < k1; kb += kSmallThreads) {
    const int k = kb + threadIdx.x;
    const bool in = k < k1;
    // the column again (pass 1's loads, from L1) and its outlier flag
    float xv[kSmallRows];
#pragma unroll
    for (int r = 0; r < kSmallRows; ++r)
      xv[r] = in && r < M ? ld(x + static_cast<size_t>(r) * K + k) : 0.f;
    float cm = 0.f;
#pragma unroll
    for (int r = 0; r < kSmallRows; ++r) cm = fmaxf(cm, fabsf(xv[r]));
    const bool o = in && cm > thr;
    const unsigned ball = __ballot_sync(0xffffffffu, o);
    if (lane == 0) wn[warp] = __popc(ball);
    __syncthreads();
    int pos = base + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) pos += wn[w];
    if (o) {
      idx[pos] = k;
      if (pos < kOutCap)
#pragma unroll
        for (int r = 0; r < kSmallRows; ++r)
          if (r < M) x_out[static_cast<size_t>(pos) * pad4(M) + r] = xv[r];
    }
    if (in)
#pragma unroll
      for (int r = 0; r < kSmallRows; ++r)
        if (r < M)
          xq[static_cast<size_t>(r) * a.Kp + k] =
              o ? 0
                : static_cast<int8_t>(
                      static_cast<int>(quant(xv[r], row_scale[r])));
    __syncthreads();  // every thread has read base and wn
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kSmallThreads / 32; ++w) s += wn[w];
      base += s;
    }
    __syncthreads();
  }
  // xq's pad columns K .. Kp - 1 are zero
  const int pad = a.Kp - K;
  if (rank == kSmallCtas - 1)
    for (int i = threadIdx.x; i < M * pad; i += kSmallThreads)
      xq[static_cast<size_t>(i / pad) * a.Kp + K + i % pad] = 0;
  hopper::cluster_sync();  // no CTA leaves while another reads its sums
}

// -- mma body ------------------------------------------------------------------
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

__device__ __forceinline__ void cp_async16_stream(void* dst, const void* src,
                                                  bool ok) {
  // read once (L2 only); the L2 fetches the 256 bytes around it
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
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
// (the weights byte by byte: this body takes the rows cp.async cannot)
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
    for (int e = 0; e < 16; ++e)
      dst[e] = (gn < a.N && gk + e < a.K) ? static_cast<uint8_t>(src[e]) : 0;
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
        if (n0 + r < a.N) wv = w_gather(a, n0 + r, c0 + j);
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
          if (n < a.N)
            finish(a, r, n, acc[i][jn][2 * h + e], as, a.scale[n],
                   bias_at(a, n), yfp[i][jn][2 * h + e]);
        }
      }
    }
  }
}

// -- wgmma body (M > 16, operands TMA can address) -----------------------------
// A tile: 128 weight rows (two consumer warpgroups of 64: wgmma's m) x 256
// xq rows (wgmma's n). Per ring slot, TMA writes the xq tile [256, 128] and
// the weight tile [128, 128] (int8, 128-byte swizzle: 16-byte chunk c of
// row r at chunk c ^ (r % 8) of its 128-byte row), both K-major as 8-bit
// wgmma wants them. The CTAs are persistent, one an SM: CTA b takes tiles
// b, b + grid, ... in the grouped raster, and its k steps run on as one
// stream across its tiles. Warp-specialised: a producer warpgroup (40
// registers; one thread) fills the slots as the consumers free them (a
// full and an empty mbarrier a slot), so the next tile's first slots load
// while the last one's epilogue runs, and no consumer waits on a barrier
// of the whole CTA. The two consumer warpgroups (232 registers), each step
// g:
//
//   wait full[g]           the slot's TMA bytes landed
//   issue wgmma(g)         m64n256k32 s8 x 4 (the slot's 128 bytes of k)
//   wait for wgmma(g - 1)  then free its slot (each warp arrives on empty)
//
// The accumulators hold y^T: thread (warp w, lane 4 g + t) of warpgroup
// wg has weight rows 64 wg + 16 w + g (+ 8) against xq rows 8 j + 2 t (+ 1),
// acc[4 j + 2 hi + e]. The epilogue adds the outlier term from column-major
// chunks (a column's 256 x values, then its 128 weight values): the first
// kOC0 columns copied (cp.async) at the tile's start into a region of their
// own, more in chunks of kOC through the ring's room (then the producer
// waits for the epilogue before it loads the next tile). A warp reads one
// 32-byte piece of x and 8 weight values a column, and a thread keeps 32
// running sums (8 of its 32 xq row pairs) at a time.
constexpr int kWgRows = 256;        // xq rows a tile (wgmma's n)
constexpr int kWgCols = 128;        // weight rows a tile: 64 a warpgroup
constexpr int kWgK = 128;           // k bytes a ring slot
constexpr int kWgConsumers = 256;   // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer's
constexpr int kWgStages = 4;
constexpr int kWgGroupRows = 2048;  // xq rows a raster group keeps in L2
constexpr uint32_t kWgXT = kWgRows * kWgK;  // xq tile bytes
constexpr uint32_t kWgQT = kWgCols * kWgK;  // weight tile bytes
constexpr int kWgRing = kWgStages * (kWgXT + kWgQT);
constexpr int kOC0 = 16;            // outlier columns staged at a tile's start
constexpr int kWgChunk = kWgRows + kWgCols;  // f32 values a staged column
constexpr int kWgFirst = kOC0 * kWgChunk * 4;
constexpr int kWgScales = kWgRows * 4;           // the tile's a_scale
constexpr int kWgOut = (kWgConsumers / 32) * 1024;  // a warp's 8 x 16
                                                    // outputs and products
constexpr int kWgBars = (2 * kWgStages + 1) * 8;
constexpr int kWgSmem =
    kWgRing + kWgFirst + kWgScales + kWgOut + kWgBars + 1024;
static_assert(kWgSmem <= 232448, "wgmma body: shared memory over 227 KB");
// a later chunk's room in the ring: the running outlier sums (128 a
// consumer), then the chunk
static_assert((128 * kWgConsumers + kOC * kWgChunk) * 4 <= kWgRing,
              "wgmma body: the outlier chunk fits the ring");
static_assert(kOC0 <= kOutCap, "the first chunk is gathered");

struct WgParams {
  CUtensorMap tx, tq;  // xq byte rows, q byte rows (128-byte swizzle)
  Args a;
};

// cp.async of `bytes` (0 .. 16) to a 16-byte destination, zeros past them
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ WgParams P) {
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* xs = hopper::align1024(wg_smem_raw);  // [stages] xq tiles
  unsigned char* qs = xs + kWgStages * kWgXT;          // [stages] q tiles
  // the first chunk: [kOC0] columns of 256 x values then 128 weights
  float* first_chunk = reinterpret_cast<float*>(xs + kWgRing);
  float* row_scale = first_chunk + kWgFirst / 4;  // [256]
  float* out_stage = row_scale + kWgRows;         // [warps][2][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + kWgRing + kWgFirst +
                                                kWgScales + kWgOut);
  uint64_t* empty = full + kWgStages;
  uint64_t* epi = empty + kWgStages;  // a tile's epilogue is done
  float* run = reinterpret_cast<float*>(xs);   // [128][consumers]: sums
                                               // between chunks
  float* later_chunk = run + 128 * kWgConsumers;  // [kOC] columns
  const Args& a = P.a;
  // grouped raster: the tiles in flight share a group's kWgGroupRows rows
  // of xq (kept in L2) and walk the weight tiles, each read once a group
  constexpr int G = kWgGroupRows / kWgRows;
  const int mt = (a.M + kWgRows - 1) / kWgRows;
  const int nt = (a.N + kWgCols - 1) / kWgCols;
  const int tiles = mt * nt;
  auto origin = [&](int tile, int& m0, int& n0) {
    const int g0 = tile / (G * nt) * G;
    const int gsz = min(mt - g0, G);
    const int local = tile % (G * nt);
    m0 = (g0 + local % gsz) * kWgRows;
    n0 = local / gsz * kWgCols;
  };
  const int steps = (a.K + kWgK - 1) / kWgK;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);
  const int t = threadIdx.x;
  const int cnt = *a.count;
  // the next tile's slots load during an epilogue unless the epilogue
  // needs the ring's room
  const bool across = cnt <= kOC0;
  if (t == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kWgConsumers / 32);
    }
    hopper::mbar_init(epi, kWgConsumers / 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (t >= kWgConsumers) {
    // -- producer ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == kWgConsumers) {
      int m0 = 0, n0 = 0;
      for (int h = 0, ti = 0, kt = 0; h < mine * steps; ++h) {
        const int s = h % kWgStages;
        if (kt == 0) {
          origin(static_cast<int>(blockIdx.x) + ti * gridDim.x, m0, n0);
          if (!across && ti > 0) hopper::mbar_wait(epi, (ti - 1) & 1);
        }
        if (h >= kWgStages)
          hopper::mbar_wait(empty + s, (h / kWgStages - 1) & 1);
        hopper::mbar_arrive_tx(full + s, kWgXT + kWgQT);
        hopper::tma_load_2d(xs + s * kWgXT, &P.tx, full + s, kt * kWgK, m0);
        hopper::tma_load_2d(qs + s * kWgQT, &P.tq, full + s, kt * kWgK, n0);
        if (++kt == steps) {
          kt = 0;
          ++ti;
        }
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = t >> 7, w = (t & 127) >> 5, lane = t & 31;
    const int grp = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64 + 16 * w + grp;  // weight rows r0, r0 + 8
    const int xp = pad4(a.M), wp = pad4(a.N);

    // columns [c0, c0 + nc) (nc <= width) of the tile into dst [width]
    // [kWgChunk] (x rows m0 .. m0 + 255, then weight rows n0 .. n0 + 127),
    // zeros past them: 16 bytes at a time by cp.async from x_out / w_out
    // below kOutCap, gathered at a stride of K past it. One cp.async group.
    auto stage = [&](float* dst, int width, int c0, int nc, int m0, int n0) {
      constexpr int P4 = kWgChunk / 4;  // 16-byte pieces a column
      for (int i = t; i < width * P4; i += kWgConsumers) {
        const int c = i / P4, p = i % P4, j = c0 + c;
        const bool xrow = p < kWgRows / 4;
        const int base = xrow ? m0 + 4 * p : n0 + 4 * p - kWgRows;
        const int lim = xrow ? a.M : a.N;
        const int bytes = c < nc ? 4 * max(0, min(4, lim - base)) : 0;
        float* d = dst + c * kWgChunk + 4 * p;
        if (j < kOutCap) {
          const float* src = xrow ? a.x_out + static_cast<size_t>(j) * xp
                                  : a.w_out + static_cast<size_t>(j) * wp;
          cp_async_n(d, bytes ? src + base : a.x_out, bytes);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = 4 * e < bytes ? (xrow ? x_outlier(a, base + e, j)
                                         : w_gather(a, base + e, j))
                                 : 0.f;
        }
      }
      cp_async_commit();
    };

    // the output's rows take 16-byte stores (see the epilogue)
    const bool rows16 = a.acc_out == nullptr &&
                        a.N % (a.dtype == 1 ? 8 : 4) == 0 &&
                        reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    float* my_stage = out_stage + (t >> 5) * 256;
    int* my_acc = reinterpret_cast<int*>(my_stage + 128);
    int acc[2 * kWgRows / 4];
    for (int ti = 0; ti < mine; ++ti) {
      int m0, n0;
      origin(static_cast<int>(blockIdx.x) + ti * gridDim.x, m0, n0);
      // the tile's row scales, and its first outlier columns, land during
      // the main loop (one cp.async group)
      if (t < kWgRows / 4)
        cp_async_n(row_scale + 4 * t,
                   m0 + 4 * t < a.M ? a.a_scale + m0 + 4 * t : a.a_scale,
                   4 * max(0, min(4, a.M - m0 - 4 * t)));
      if (cnt > 0) stage(first_chunk, kOC0, 0, min(cnt, kOC0), m0, n0);
      else cp_async_commit();
#pragma unroll
      for (int i = 0; i < 2 * kWgRows / 4; ++i) acc[i] = 0;
      for (int kt = 0; kt < steps; ++kt) {
        const int g = ti * steps + kt, s = g % kWgStages;
        hopper::mbar_wait(full + s, (g / kWgStages) & 1);
        const unsigned char* qt = qs + s * kWgQT + wg * 64 * kWgK;
        const unsigned char* xt = xs + s * kWgXT;
        hopper::fence_operand(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgK / 32; ++kk)
          hopper::wgmma_ss256_s8(
              acc, hopper::desc_sw128(qt + 32 * kk, 16, 1024),
              hopper::desc_sw128(xt + 32 * kk, 16, 1024), 1);
        hopper::wgmma_commit();
        hopper::fence_operand(acc);
        hopper::wgmma_wait<1>();
        hopper::fence_operand(acc);
        if (kt > 0 && lane == 0)
          hopper::mbar_arrive(empty + (g - 1) % kWgStages);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      if (lane == 0)
        hopper::mbar_arrive(empty + (ti * steps + steps - 1) % kWgStages);

      // epilogue: y = ((f32(acc) * a_scale) * scale) + the outlier term
      float sc[2], bs[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int n = n0 + r0 + 8 * hi;
        sc[hi] = n < a.N ? a.scale[n] : 0.f;
        bs[hi] = n < a.N ? bias_at(a, n) : 0.f;
      }
      cp_async_wait<0>();
      hopper::named_sync(1, kWgConsumers);  // the scales and first chunk
                                            // landed
      // each warp writes the outputs of one j (8 xq rows x its 16 weight
      // rows, f32) into its staging buffer; a full tile whose rows take
      // 16-byte stores then stores 16 contiguous bytes a lane (every 32-byte
      // sector whole), an edge tile an element a lane at a time
      const bool fast = rows16 && m0 + kWgRows <= a.M && n0 + kWgCols <= a.N;
      const int nw = n0 + wg * 64 + 16 * w;  // the warp's first weight row
      for (int c0 = 0;;) {
        const int width = c0 ? kOC : kOC0;
        const int nc = min(width, cnt - c0);  // <= 0 when there is none
        const float* chunk = c0 ? later_chunk : first_chunk;
        if (c0 && nc > 0) {
          hopper::named_sync(1, kWgConsumers);  // the last chunk is read
          stage(later_chunk, kOC, c0, nc, m0, n0);
          cp_async_wait<0>();
          hopper::named_sync(1, kWgConsumers);
        }
        const bool first = c0 == 0, last = c0 + width >= cnt;
#pragma unroll
        for (int jb = 0; jb < kWgRows / 64; ++jb) {
          // f[4 jj + 2 hi + e]: weight row r0 + 8 hi, xq row 8 j + 2 tig + e,
          // j = 8 jb + jj
          float f[32];
#pragma unroll
          for (int i = 0; i < 32; ++i)
            f[i] = first ? 0.f : run[(32 * jb + i) * kWgConsumers + t];
#pragma unroll 1
          for (int c = 0; c < nc; ++c) {
            const float* col = chunk + c * kWgChunk;
            const float w0 = col[kWgRows + r0], w1 = col[kWgRows + r0 + 8];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const float2 xv = *reinterpret_cast<const float2*>(
                  col + 8 * (8 * jb + jj) + 2 * tig);
              f[4 * jj] = fmaf(xv.x, w0, f[4 * jj]);
              f[4 * jj + 1] = fmaf(xv.y, w0, f[4 * jj + 1]);
              f[4 * jj + 2] = fmaf(xv.x, w1, f[4 * jj + 2]);
              f[4 * jj + 3] = fmaf(xv.y, w1, f[4 * jj + 3]);
            }
          }
          if (!last) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              run[(32 * jb + i) * kWgConsumers + t] = f[i];
            continue;
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * jb + jj;
            // finish()'s arithmetic into the staging buffer [8 rows][16]
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float as = row_scale[8 * j + 2 * tig + e];
#pragma unroll
              for (int hi = 0; hi < 2; ++hi) {
                const int v = acc[4 * j + 2 * hi + e];
                float y = __fmul_rn(__fmul_rn(__int2float_rn(v), as), sc[hi]);
                y = __fadd_rn(y, f[4 * jj + 2 * hi + e]);
                if (a.bias_code >= 0) y = __fadd_rn(y, bs[hi]);
                my_stage[(2 * tig + e) * 16 + grp + 8 * hi] = y;
                my_acc[(2 * tig + e) * 16 + grp + 8 * hi] = v;
              }
            }
            __syncwarp();
            const size_t row = static_cast<size_t>(m0 + 8 * j);
            const float4* st = reinterpret_cast<const float4*>(my_stage);
            if (!fast) {  // an edge tile, or acc_out too
              for (int i = lane; i < 128; i += 32) {
                const int m = m0 + 8 * j + i / 16, n = nw + i % 16;
                if (m >= a.M || n >= a.N) continue;
                const size_t o = static_cast<size_t>(m) * a.N + n;
                if (a.dtype == 1)
                  static_cast<bf16*>(a.out)[o] = __float2bfloat16(my_stage[i]);
                else
                  static_cast<float*>(a.out)[o] = my_stage[i];
                if (a.acc_out) a.acc_out[o] = my_acc[i];
              }
            } else if (a.dtype == 1) {
              if (lane < 16) {  // row lane / 2, weight rows 8 (lane % 2) ..
                const float4 lo = st[2 * lane], hi = st[2 * lane + 1];
                *reinterpret_cast<uint4*>(
                    static_cast<bf16*>(a.out) + (row + (lane >> 1)) * a.N +
                    nw + 8 * (lane & 1)) =
                    make_uint4(hopper::bf16x2(lo.x, lo.y),
                               hopper::bf16x2(lo.z, lo.w),
                               hopper::bf16x2(hi.x, hi.y),
                               hopper::bf16x2(hi.z, hi.w));
              }
            } else {  // row lane / 4, weight rows 4 (lane % 4) ..
              *reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                         (row + (lane >> 2)) * a.N + nw +
                                         4 * (lane & 3)) = st[lane];
            }
            __syncwarp();
          }
        }
        if (last) break;
        c0 += width;
      }
      // the scales and chunks are read before the next tile's copies; the
      // producer may load into the ring again
      hopper::named_sync(1, kWgConsumers);
      if (lane == 0) hopper::mbar_arrive(epi);
    }
  }
}

// -- gemv body (M <= 16, the weights cp.async can stream) --------------------
// A CTA of kGvWarps warps owns kGvCols weight rows (kGvTiles 16-row tiles a
// warp, each with its own C fragments) and one K slice. A k block is 64
// weight bytes a row: lane (g, t) = (lane / 4, lane % 4) copies bytes 16 t
// .. 16 t + 15 of the block of rows g and g + 8 of each tile into its own
// ring (kGvStages blocks in flight, no barrier), and takes its words as A
// fragments under a permutation of k: m16n8k32 step s (0, 1) reads words 2s
// (k-slots 4t..) and 2s + 1 (k-slots 16 + 4t..), and its B fragments are the
// same 8 bytes of the xq rows, one 16-byte read of the staged window for
// both steps. 8 rows of a warp read at 16 t from rows a pitch of 64 (mod
// 128) bytes apart: distinct banks.
constexpr int kGvWarps = 4;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvTiles = 2;                        // 16-row tiles a warp
constexpr int kGvCols = 16 * kGvTiles * kGvWarps;  // weight rows a CTA
constexpr int kGvPieces = 2 * kGvTiles;            // 16-byte pieces a lane
constexpr int kGvStages = 6;                       // k blocks in flight
constexpr int kGvBlock = 64;                       // a k block: bytes a row
constexpr int kGvRingBytes = kGvStages * kGvPieces * kGvThreads * 16;
constexpr int kGvXBytes = 48 * 1024;               // staged xq a window, max
constexpr int kGvMaxSplits = 8;                    // portable cluster size
constexpr int kGvPartPitch = kGvCols + 4;          // a row of partial sums

// k blocks of xq a window stages: the slice's, or as many as kGvXBytes holds
__host__ __device__ __forceinline__ int gemv_window(int mr, int ks) {
  const int cap = (kGvXBytes / mr - 128) / kGvBlock;
  return ks / kGvBlock < cap ? ks / kGvBlock : cap;
}

// the staged window's row pitch: 64 bytes past a multiple of 128
__host__ __device__ __forceinline__ int gemv_pitch(int wk) {
  return (wk * kGvBlock + 127) / 128 * 128 + 64;
}

// dynamic shared memory: the ring, then the staged xq window, whose room
// takes the int32 and f32 partial sums [mr][kGvPartPitch] after the product
inline int gemv_smem(int mr, int ks) {
  const int xb = mr * gemv_pitch(gemv_window(mr, ks));
  const int pb = 2 * mr * kGvPartPitch * 4;
  return kGvRingBytes + (xb > pb ? xb : pb);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int MR>
__global__ void __launch_bounds__(kGvThreads, 4) gemv_kernel(const Args a) {
  constexpr int NT = MR / 8;
  extern __shared__ __align__(16) unsigned char gv_smem[];
  // [stage][piece][thread]: a lane's pieces are its own, so its cp.async
  // groups alone order them (no barrier)
  uint4* ring = reinterpret_cast<uint4*>(gv_smem) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * a.ks;
  const int nk = min(a.ks, a.K - k0);
  const int nkb = (nk + kGvBlock - 1) / kGvBlock;
  const int n0 = blockIdx.x * kGvCols;
  const int row = n0 + warp * 16 * kGvTiles + g;  // tile r: row + 16 r (+ 8)
  const int boff = k0 + 16 * t;                   // this lane's byte, block 0

  // block b's pieces into its ring slot, one cp.async group (zeros past
  // K and N)
  auto issue = [&](int b) {
    if (b < nkb) {
      uint4* slot = ring + (b % kGvStages) * kGvPieces * kGvThreads;
      const int off = boff + kGvBlock * b;
#pragma unroll
      for (int p = 0; p < kGvPieces; ++p) {
        const int rn = row + 16 * (p >> 1) + 8 * (p & 1);
        const bool ok = rn < a.N && off < a.K;
        cp_async16_stream(slot + p * kGvThreads,
                          ok ? a.q + static_cast<size_t>(rn) * a.K + off
                             : a.q,
                          ok);
      }
    }
    cp_async_commit();
  };

  // the weights read nothing the pre-pass writes: the first kGvStages - 1
  // blocks go out before the wait on it (programmatic dependent launch)
  for (int s = 0; s < kGvStages - 1; ++s) issue(s);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int wk = gemv_window(MR, a.ks);  // k blocks a window
  const int pitch = gemv_pitch(wk);
  unsigned char* xs = gv_smem + kGvRingBytes;
  // xq rows 0 .. MR - 1 of the window's k blocks wb .. wb + wk (zeros past
  // M and the slice), one cp.async group
  auto stage = [&](int wb) {
    const int chunks = wk * (kGvBlock / 16);
    for (int i = threadIdx.x; i < MR * chunks; i += kGvThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int kk = wb * kGvBlock + 16 * c;  // k inside the slice
      const bool ok = r < a.M && kk < nkb * kGvBlock;
      cp_async16(xs + r * pitch + 16 * c,
                 ok ? a.xq + static_cast<size_t>(r) * a.Kp + k0 + kk : a.xq,
                 ok);
    }
    cp_async_commit();
  };
  stage(0);
  cp_async_wait<0>();
  __syncthreads();

  int acc[kGvTiles][NT][4];
#pragma unroll
  for (int r = 0; r < kGvTiles; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0;
  int wb = 0;
  for (int b = 0; b < nkb; ++b) {
    if (b == wb + wk) {  // the next xq window (long K slices only)
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the last window
      wb = b;
      stage(wb);
      cp_async_wait<0>();
      __syncthreads();
    }
    uint4 w[kGvTiles][2];
    const uint4* slot = ring + (b % kGvStages) * kGvPieces * kGvThreads;
#pragma unroll
    for (int p = 0; p < kGvPieces; ++p)
      w[p >> 1][p & 1] = slot[p * kGvThreads];
    issue(b + kGvStages - 1);
    uint4 xv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xv[j] = *reinterpret_cast<const uint4*>(
          xs + (g + 8 * j) * pitch + (b - wb) * kGvBlock + 16 * t);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < kGvTiles; ++r) {
        const uint32_t af[4] = {word(w[r][0], 2 * s), word(w[r][1], 2 * s),
                                word(w[r][0], 2 * s + 1),
                                word(w[r][1], 2 * s + 1)};
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[r][j], af, word(xv[j], 2 * s), word(xv[j], 2 * s + 1));
      }
    cp_async_wait<kGvStages - 2>();  // block b + 1 has landed
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with xq: its room takes the sums

  int* parti = reinterpret_cast<int*>(xs);  // [MR][kGvPartPitch]
  float* partf = reinterpret_cast<float*>(xs) + MR * kGvPartPitch;
  // C fragment (r, j): weight rows 16 r + g (+ 8), xq rows 8 j + 2 t (+ 1)
#pragma unroll
  for (int r = 0; r < kGvTiles; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        parti[(8 * j + 2 * t + (e & 1)) * kGvPartPitch +
              warp * 16 * kGvTiles + 16 * r + g + 8 * (e >> 1)] =
            acc[r][j][e];
  // this slice's share of the outlier columns, a thread a weight row
  {
    const int cnt = *a.count;
    const int ja = static_cast<int>(static_cast<long long>(cnt) * blockIdx.y /
                                    a.splits);
    const int jb = static_cast<int>(static_cast<long long>(cnt) *
                                    (blockIdx.y + 1) / a.splits);
    const int n = n0 + threadIdx.x;
    float f[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) f[m] = 0.f;
    if (n < a.N)
      for (int j = ja; j < jb; ++j) {
        const float wv = w_gather(a, n, j);
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < a.M) f[m] = fmaf(x_outlier(a, m, j), wv, f[m]);
      }
#pragma unroll
    for (int m = 0; m < MR; ++m) partf[m * kGvPartPitch + threadIdx.x] = f[m];
  }
  hopper::cluster_sync();
  // this CTA's share of the outputs: rows m = rank, rank + splits, ... of
  // every column; the slices' int32 sums in any order (exact), their
  // outlier terms loaded first, then added in slice order
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int mine = rank < a.M ? (a.M - rank + a.splits - 1) / a.splits : 0;
  for (int i = threadIdx.x; i < mine * kGvCols; i += kGvThreads) {
    const int m = rank + a.splits * (i / kGvCols), col = i % kGvCols;
    const int n = n0 + col;
    if (n >= a.N) continue;
    const int o = m * kGvPartPitch + col;
    int v = 0;
    float fv[kGvMaxSplits];
#pragma unroll
    for (int c = 0; c < kGvMaxSplits; ++c) {
      if (c < a.splits) v += hopper::ld_cluster(parti + o, c);
      fv[c] = c < a.splits ? hopper::ld_cluster(partf + o, c) : 0.f;
    }
    float yf = fv[0];
#pragma unroll
    for (int c = 1; c < kGvMaxSplits; ++c)
      if (c < a.splits) yf += fv[c];
    finish(a, m, n, v, a.a_scale[m], a.scale[n], bias_at(a, n), yf);
  }
  hopper::cluster_sync();  // no CTA leaves while another reads its sums
}

// -- launches --------------------------------------------------------------------
enum Body { kMma = 0, kWgmma = 1, kGemv = 2 };

// the pre-pass of the mma and wgmma bodies; gather: x_out and w_out too
// (amax holds K floats, then the outlier mask's K / 32 words)
template <typename T>
cudaError_t prepass_rows(const Args& a, float thr, unsigned* amax, int* idx,
                         int* count, int8_t* xq, float* a_scale, float* x_out,
                         float* w_out, cudaStream_t s) {
  const T* x = static_cast<const T*>(a.x);
  const bool vec = (a.K * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned) * a.K, s);
  if (e != cudaSuccess) return e;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    dim3 cgrid((a.K / V + 31) / 32, (a.M + kColRowsV - 1) / kColRowsV);
    colmax_vec_kernel<T><<<cgrid, 256, 0, s>>>(x, a.M, a.K, amax);
  } else {
    dim3 cgrid((a.K + 255) / 256, (a.M + kColRows - 1) / kColRows);
    colmax_kernel<T><<<cgrid, 256, 0, s>>>(x, a.M, a.K, amax);
  }
  outlier_kernel<<<1, kOutlierThreads, 0, s>>>(amax, thr, a.K, idx, count,
                                               amax + a.K);
  const int blocks = a.M + (w_out ? kGatherBlocks : 0);
  if (vec)
    quant_kernel<T, true><<<blocks, kQuantThreads, 0, s>>>(a, thr, xq, a_scale,
                                                           x_out, w_out);
  else
    quant_kernel<T, false><<<blocks, kQuantThreads, 0, s>>>(a, thr, xq,
                                                            a_scale, x_out,
                                                            w_out);
  return cudaGetLastError();
}

// the gemv body's pre-pass: one cluster of kSmallCtas CTAs
template <typename T>
cudaError_t prepass_small(const Args& a, float thr, unsigned* amax, int* idx,
                          int* count, int8_t* xq, float* a_scale,
                          float* x_out, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSmallCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSmallCtas, 1, 1);
  cfg.blockDim = dim3(kSmallThreads, 1, 1);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, small_prepass_kernel<T>, a, thr,
                                     amax, idx, count, xq, a_scale, x_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.M + kBM - 1) / kBM, (a.N + kBN - 1) / kBN);
  gemm_kernel<<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  WgParams p{};
  p.a = a;
  if (!hopper_host::encode_u8_rows(&p.tx, a.xq, a.M, a.Kp, kWgRows, kWgK,
                                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper_host::encode_u8_rows(&p.tq, a.q, a.N, a.K, kWgCols, kWgK,
                                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.M + kWgRows - 1) / kWgRows) *
                    ((a.N + kWgCols - 1) / kWgCols);
  // persistent: one CTA an SM, each walking its share of the tiles
  wgmma_kernel<<<min(tiles, sms), kWgThreads, kWgSmem, s>>>(p);
  return cudaGetLastError();
}

template <int MR>
cudaError_t launch_gemv_mr(const Args& a, cudaStream_t s) {
  const int smem = gemv_smem(MR, a.ks);
  cudaError_t e = cudaFuncSetAttribute(
      gemv_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the blocks may start while the
  // pre-pass runs; they wait for it before touching its outputs
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kGvCols - 1) / kGvCols, a.splits, 1);
  cfg.blockDim = dim3(kGvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, gemv_kernel<MR>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// slices the gemv body refuses: ks not a whole number of k blocks, slices
// that do not cover K exactly once, a cluster over kGvMaxSplits
bool bad_slices(int K, int splits, int ks) {
  return ks <= 0 || ks % kGvBlock || splits < 1 || splits > kGvMaxSplits ||
         static_cast<long long>(splits) * ks < K ||
         static_cast<long long>(splits - 1) * ks >= K;
}

int run(const void* x, const void* q, const void* scale, const void* bias,
        void* out, void* acc_out, void* amax, void* idx, void* count,
        void* a_scale, void* xq, void* x_out, void* w_out, int M, int N,
        int K, int Kp, int dtype, int bias_code, float threshold, int body,
        int splits, int ks, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool tma = K % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (K <= 0 || Kp < K || Kp % kBK || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      (body == kWgmma && (!tma || !x_out || !w_out)) ||
      (body == kGemv && (!tma || !x_out || M > kSmallRows ||
                         bad_slices(K, splits, ks))) ||
      (body != kMma && body != kWgmma && body != kGemv))
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
         static_cast<const float*>(x_out),
         static_cast<const float*>(w_out),
         M, N, K, Kp, dtype, bias_code, splits, ks};
  unsigned* am = static_cast<unsigned*>(amax);
  int* ix = static_cast<int*>(idx);
  int* cn = static_cast<int*>(count);
  int8_t* xqw = static_cast<int8_t*>(xq);
  float* as = static_cast<float*>(a_scale);
  float* xo = static_cast<float*>(x_out);
  float* wo = body == kWgmma ? static_cast<float*>(w_out) : nullptr;
  cudaError_t e;
  if (body == kGemv)
    e = dtype == 1
            ? prepass_small<bf16>(a, threshold, am, ix, cn, xqw, as, xo, s)
            : prepass_small<float>(a, threshold, am, ix, cn, xqw, as, xo, s);
  else
    e = dtype == 1 ? prepass_rows<bf16>(a, threshold, am, ix, cn, xqw, as,
                                        body == kWgmma ? xo : nullptr, wo, s)
                   : prepass_rows<float>(a, threshold, am, ix, cn, xqw, as,
                                         body == kWgmma ? xo : nullptr, wo,
                                         s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (body == kWgmma) return static_cast<int>(launch_wgmma(a, s));
  if (body == kGemv)
    return static_cast<int>(M <= 8 ? launch_gemv_mr<8>(a, s)
                                   : launch_gemv_mr<16>(a, s));
  return static_cast<int>(launch_mma(a, s));
}

}  // namespace

// x [M, K] (dtype 0 f32, 1 bf16) and out [M, N] in that dtype; q int8
// [N, K]; scale f32 [N]; bias [N] (bias_code -1 none, 0 f32, 1 bf16);
// acc_out int32 [M, N] or null. Work buffers the wrapper allocates: amax
// [K + K / 32 rounded up] (4 bytes each: the column absmax, then the
// outlier mask), idx int32 [K], count int32 [1], a_scale f32 [M], xq
// int8 [M, Kp] with Kp = K rounded up to 64, x_out f32 [kOutCap, M
// rounded up to 4] (gemv, wgmma), w_out f32 [kOutCap, N rounded up to 4]
// (wgmma). body: 0 mma, 1 wgmma (K % 16 ==
// 0, q 16-byte aligned), 2 gemv (the same, M <= 16; `splits` K slices of
// `ks` bytes, a multiple of 64, at most 8, one cluster).
extern "C" int llm_int8_linear_launch(
    const void* x, const void* q, const void* scale, const void* bias,
    void* out, void* acc_out, void* amax, void* idx, void* count,
    void* a_scale, void* xq, void* x_out, void* w_out, int M, int N, int K,
    int Kp, int dtype, int bias_code, float threshold, int body, int splits,
    int ks, void* stream) {
  return run(x, q, scale, bias, out, acc_out, amax, idx, count, a_scale, xq,
             x_out, w_out, M, N, K, Kp, dtype, bias_code, threshold, body,
             splits, ks, stream);
}
