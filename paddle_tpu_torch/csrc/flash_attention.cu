// K1 and K2: flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K1 flash_attention_fwd -> _pallas_fa -> _fwd_kernel: online-softmax
//      attention that emits O and the f32 per-row logsumexp (lse);
//   K2 _fa_bwd -> _pallas_fa_bwd -> _dq_kernel and _dkv_kernel: the
//      FlashAttention-2 backward, P recomputed as exp(S - lse), with
//      delta = rowsum(dO o O) (XLA in the JAX _fa_bwd) as a pre-pass here.
//
// Layouts: q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, KV, D]
// (the paddle layout, indexed directly: no [B*H, S, D] copy); lse [B, H,
// Sq] f32; optional int32 segment ids qseg [B, Sq] and kseg [B, Skv] (a
// pair attends only within equal ids). Query head h reads KV head
// h / (H / KV): GQA is native, and each KV head's dk/dv sum the G query
// heads of its group inside one CTA.
//
// Masking (as the Pallas kernel): causal uses the bottom-right convention,
// row r sees keys <= r + Skv - Sq; masked scores are -1e30 and their
// probabilities exactly 0; l is clamped at 1e-30, so a row that sees no
// key outputs 0 with lse about -1e30. Scores, softmax state and every
// accumulator are f32. Products run in the input type: bf16 P, dS are
// rounded to bf16 before their products (flash_attention.py:137, :249,
// :291, :297), as the TPU kernel does.
//
// Shape limits (the wrapper raises on anything else): D in {16, 32, 64,
// 128}; H a multiple of KV; any Sq, Skv >= 0 (partial tiles are masked);
// 16-byte aligned, contiguous tensors; bf16 or f32.
//
// Bound on this card: operations at training shapes. The forward needs
// 2 matmuls of 2*Sq*Skv*D flops per (b, h), halved under causal; the
// backward 5. At [4, 2048, 32, 128] causal bf16 the forward is 0.137
// TFLOP (0.139 ms at 989 TFLOP/s) against 0.27 GB of q, k, v and out
// (0.080 ms at 3.35 TB/s); the backward 0.344 TFLOP (0.348 ms).
//
// Design. No body uses atomics: each output element is owned by one CTA,
// so the backward is deterministic.
//   bf16, D = 64 and 128 (the training path): Hopper bodies. A CTA is two
//     consumer warpgroups of 64 rows (the forward: W of them, 1 to 3) and
//     one producer warp. The producer
//     issues TMA loads (4-D tensor maps over the native layout, 128-byte
//     swizzle, each tile as 64-column panels, rows past the end zero-
//     filled) into a two-stage ring of shared-memory tiles, each stage
//     guarded by a "full" mbarrier (TMA bytes) and an "empty" one (the 256
//     consumer threads). Consumers run wgmma: scores from Q and K both in
//     shared memory (K-major), products with P or dS as register A fragments
//     against a tile read transposed (MN-major). Masks are applied only on
//     tiles that a row's causal frontier, the key or row count, or segment
//     ids cut; softmax runs in base 2 (exp2 of scores times
//     scale*log2(e)), lse stays natural.
//     forward: one CTA per (block_q = 64 W q rows, head, batch row),
//       block_kv = 64 or 128 keys of K and V a stage up to the block's
//       causal frontier, the softmax in sub-steps of 64 keys; S = Q K^T,
//       O += P V. The tile is a template
//       parameter; kFwdTiles lists the built ones (default 128 x 128),
//       flash_attention_fwd_tiles exports the list, and K7 (the measured
//       search, ops/kernels/autotune.py) chooses among them.
//       The q blocks of one head launch together (the K and V they
//       stream stay in L2), under causal the heaviest (last rows) first.
//     pre-pass: delta = rowsum(dO o O) and lse * log2(e) into f32 rows
//       padded to 64, one read of O, dO and lse (any dtype, any D).
//     dq: one CTA per 128 q rows; Q and dO resident, 64 keys of K and V a
//       stage; S = Q K^T, dP = dO V^T, dS = P (dP - delta), dq += dS K.
//     dk/dv: one CTA per (keys, KV head, batch row), K and V resident;
//       64 q rows of Q, dO, lse and delta a stage for each head of the
//       group from the first q block that sees the CTA's keys; S^T = K Q^T,
//       dP^T = V dO^T, dv += P^T dO, dk += dS^T Q. The key blocks of one
//       KV head launch together, the first keys (the most q rows) first.
//       At D = 128 a CTA holds 64 keys and each warpgroup 64 of the 128
//       columns of dk and dv (both compute S^T and dP^T: 6 matmuls of
//       work for the 4 of the function, the price of fitting the 168
//       registers a thread of a 288-thread block may hold); at D = 64, 128
//       keys, 64 a warpgroup.
//   bf16, D = 16 and 32: the first tensor-core bodies on mma.sync m16n8k16,
//     4 warps of 16 rows (or keys), K/V (or Q/dO) staged synchronously;
//     wgmma's 64-column swizzled panels do not fit these widths. A call
//     with no q row or no key takes them at D = 64 and 128 too (a tensor
//     map needs every dimension > 0).
//   fp32: one warp per 4 rows (forward, dq) or 4 keys (dk/dv), each lane
//     owning head-dim elements d = lane + 32 n; dot products by warp
//     shuffles. Right first; the fp32 path is not the training path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;   // backward
  const float* delta;    // backward
  const int* qseg;       // null: no segments
  const int* kseg;
  void* out;             // forward
  float* lse;            // forward
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KV, D, causal;
  int Sp;                // delta rows, padded: [B, H, Sp]
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// last key row r may attend (-1: none); rows past Sq see nothing
__device__ __forceinline__ int frontier(const Args& a, int r) {
  if (r >= a.Sq) return -1;
  return a.causal ? min(a.Skv - a.Sq + r, a.Skv - 1) : a.Skv - 1;
}

__device__ __forceinline__ size_t q_off(const Args& a, int b, int r, int h) {
  return ((size_t(b) * a.Sq + r) * a.H + h) * size_t(a.D);
}

__device__ __forceinline__ size_t k_off(const Args& a, int b, int j, int kv) {
  return ((size_t(b) * a.Skv + j) * a.KV + kv) * size_t(a.D);
}

// ---------------------------------------------------------------------------
// FMA bodies (fp32). kTR rows (or keys) per warp, kKB keys per step.
// ---------------------------------------------------------------------------
constexpr int kTR = 4;
constexpr int kKB = 8;

template <int NI>
__global__ void __launch_bounds__(kThreads) fwd_fma(Args a) {
  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  float* __restrict__ out = static_cast<float*>(a.out);
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * kTR;
  if (r0 >= a.Sq) return;  // no barrier in this kernel
  const int kvh = h / (a.H / a.KV);

  float qr[kTR][NI], acc[kTR][NI], m[kTR], l[kTR];
  int fr[kTR], qs[kTR];
  int kend = 0;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    fr[i] = frontier(a, r);
    kend = max(kend, fr[i] + 1);
    qs[i] = (a.qseg && r < a.Sq) ? a.qseg[size_t(b) * a.Sq + r] : 0;
    m[i] = kNeg;
    l[i] = 0.f;
    const size_t o = r < a.Sq ? q_off(a, b, r, h) : 0;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      qr[i][n] = (r < a.Sq && d < a.D) ? q[o + d] : 0.f;
      acc[i][n] = 0.f;
    }
  }
  for (int k0 = 0; k0 < kend; k0 += kKB) {
    float kf[kKB][NI], vf[kKB][NI];
    int ks[kKB];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      const int j = k0 + kk;
      const bool ok = j < a.Skv;
      const size_t o = ok ? k_off(a, b, j, kvh) : 0;
      ks[kk] = (a.kseg && ok) ? a.kseg[size_t(b) * a.Skv + j] : 0;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int d = lane + 32 * n;
        kf[kk][n] = (ok && d < a.D) ? k[o + d] : 0.f;
        vf[kk][n] = (ok && d < a.D) ? v[o + d] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      if (fr[i] < k0) continue;  // warp-uniform
      float s[kKB];
      bool keep[kKB];
      float mx = m[i];
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) part += qr[i][n] * kf[kk][n];
        const float dot = warp_sum(part);
        keep[kk] = k0 + kk <= fr[i] && (!a.qseg || qs[i] == ks[kk]);
        s[kk] = keep[kk] ? dot * a.scale : kNeg;
        mx = fmaxf(mx, s[kk]);
      }
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        s[kk] = keep[kk] ? expf(s[kk] - mx) : 0.f;
        psum += s[kk];
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        float x = acc[i][n] * corr;
#pragma unroll
        for (int kk = 0; kk < kKB; ++kk) x += s[kk] * vf[kk][n];
        acc[i][n] = x;
      }
      m[i] = mx;
    }
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    if (r >= a.Sq) continue;
    const float L = fmaxf(l[i], 1e-30f);
    const size_t o = q_off(a, b, r, h);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      if (d < a.D) out[o + d] = acc[i][n] / L;
    }
    if (lane == 0) a.lse[(size_t(b) * a.H + h) * a.Sq + r] = m[i] + logf(L);
  }
}

template <int NI>
__global__ void __launch_bounds__(kThreads) dq_fma(Args a) {
  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  float* __restrict__ dq = static_cast<float*>(a.dq);
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * kTR;
  if (r0 >= a.Sq) return;
  const int kvh = h / (a.H / a.KV);

  float qr[kTR][NI], dr[kTR][NI], acc[kTR][NI], lse[kTR], dl[kTR];
  int fr[kTR], qs[kTR];
  int kend = 0;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    const bool live = r < a.Sq;
    fr[i] = frontier(a, r);
    kend = max(kend, fr[i] + 1);
    qs[i] = (a.qseg && live) ? a.qseg[size_t(b) * a.Sq + r] : 0;
    const size_t st = (size_t(b) * a.H + h) * a.Sq + r;
    lse[i] = live ? a.lse_in[st] : 0.f;
    dl[i] = live ? a.delta[(size_t(b) * a.H + h) * a.Sp + r] : 0.f;
    const size_t o = live ? q_off(a, b, r, h) : 0;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      qr[i][n] = (live && d < a.D) ? q[o + d] : 0.f;
      dr[i][n] = (live && d < a.D) ? dout[o + d] : 0.f;
      acc[i][n] = 0.f;
    }
  }
  for (int k0 = 0; k0 < kend; k0 += kKB) {
    float kf[kKB][NI], vf[kKB][NI];
    int ks[kKB];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      const int j = k0 + kk;
      const bool ok = j < a.Skv;
      const size_t o = ok ? k_off(a, b, j, kvh) : 0;
      ks[kk] = (a.kseg && ok) ? a.kseg[size_t(b) * a.Skv + j] : 0;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int d = lane + 32 * n;
        kf[kk][n] = (ok && d < a.D) ? k[o + d] : 0.f;
        vf[kk][n] = (ok && d < a.D) ? v[o + d] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      if (fr[i] < k0) continue;
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          ps += qr[i][n] * kf[kk][n];
          pd += dr[i][n] * vf[kk][n];
        }
        const bool keep = k0 + kk <= fr[i] && (!a.qseg || qs[i] == ks[kk]);
        const float s = warp_sum(ps) * a.scale;
        const float dp = warp_sum(pd);
        const float p = keep ? expf(s - lse[i]) : 0.f;
        const float ds = p * (dp - dl[i]);
#pragma unroll
        for (int n = 0; n < NI; ++n) acc[i][n] += ds * kf[kk][n];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    if (r >= a.Sq) continue;
    const size_t o = q_off(a, b, r, h);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      if (d < a.D) dq[o + d] = acc[i][n] * a.scale;
    }
  }
}

template <int NI>
__global__ void __launch_bounds__(kThreads) dkv_fma(Args a) {
  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  float* __restrict__ dk = static_cast<float*>(a.dk);
  float* __restrict__ dv = static_cast<float*>(a.dv);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (blockIdx.x * kWarps + warp) * kTR;
  if (j0 >= a.Skv) return;
  const int G = a.H / a.KV;
  const int qoff = a.Skv - a.Sq;

  float kr[kTR][NI], vr[kTR][NI], ak[kTR][NI], av[kTR][NI];
  int ks[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int j = j0 + i;
    const bool ok = j < a.Skv;
    ks[i] = (a.kseg && ok) ? a.kseg[size_t(b) * a.Skv + j] : 0;
    const size_t o = ok ? k_off(a, b, j, kvh) : 0;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      kr[i][n] = (ok && d < a.D) ? k[o + d] : 0.f;
      vr[i][n] = (ok && d < a.D) ? v[o + d] : 0.f;
      ak[i][n] = av[i][n] = 0.f;
    }
  }
  // the first q row that sees key j0 (the warp's smallest key)
  const int rstart = a.causal ? max(0, j0 - qoff) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int r = rstart; r < a.Sq; ++r) {
      const int fr = frontier(a, r);
      const int qs = a.qseg ? a.qseg[size_t(b) * a.Sq + r] : 0;
      const size_t st = (size_t(b) * a.H + h) * a.Sq + r;
      const float lse = a.lse_in[st];
      const float dl = a.delta[(size_t(b) * a.H + h) * a.Sp + r];
      const size_t o = q_off(a, b, r, h);
      float qf[NI], df[NI];
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int d = lane + 32 * n;
        qf[n] = d < a.D ? q[o + d] : 0.f;
        df[n] = d < a.D ? dout[o + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int j = j0 + i;
        if (j > fr || j >= a.Skv) continue;  // warp-uniform
        if (a.qseg && qs != ks[i]) continue;
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          ps += qf[n] * kr[i][n];
          pd += df[n] * vr[i][n];
        }
        const float s = warp_sum(ps) * a.scale;
        const float dp = warp_sum(pd);
        const float p = expf(s - lse);
        const float ds = p * (dp - dl);
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          av[i][n] += p * df[n];
          ak[i][n] += ds * qf[n];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int j = j0 + i;
    if (j >= a.Skv) continue;
    const size_t o = k_off(a, b, j, kvh);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      if (d < a.D) {
        dk[o + d] = ak[i][n] * a.scale;
        dv[o + d] = av[i][n];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core bodies: mma.sync m16n8k16, bf16 in, f32 accumulate.
// Fragment layout (lane = 4 * grp + tig): A rows grp and grp + 8, columns
// 2 tig, 2 tig + 1 (+ 8); B column grp, rows 2 tig, 2 tig + 1 (+ 8); C rows
// grp and grp + 8, columns 2 tig, 2 tig + 1.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of a [k, n] operand stored row-major by k in shared memory
// (row stride LD): k = 2 tig, 2 tig + 1 and + 8, n = grp
template <int LD>
__device__ __forceinline__ void ld_b_kn(const bf16* base, uint32_t& b0,
                                        uint32_t& b1) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(base);
  b0 = uint32_t(p[0]) | (uint32_t(p[LD]) << 16);
  b1 = uint32_t(p[8 * LD]) | (uint32_t(p[9 * LD]) << 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// stage rows [r0, r0 + ROWS) of a [B, S, heads, D] tensor (head hh) into
// shared memory with row stride LD; rows past S are zero
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int b,
                                      int r0, int S, int heads, int hh) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int c = threadIdx.x; c < ROWS * VPR; c += kThreads) {
    const int r = c / VPR;
    const int col = (c % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t(b) * S + r0 + r) * heads + hh) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

constexpr int kRows = 64;     // q rows per forward / dq CTA (16 per warp)
constexpr int kFwdKeys = 64;  // keys per forward stage
constexpr int kDqKeys = 32;   // keys per dq stage
constexpr int kKvRows = 64;   // keys per dk/dv CTA (16 per warp)
constexpr int kKvQ = 32;      // q rows per dk/dv stage

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_mma(Args a) {
  constexpr int KT = D / 16, NT = D / 8, LD = D + 8;
  __shared__ __align__(16) bf16 sk[kFwdKeys * LD];
  __shared__ __align__(16) bf16 sv[kFwdKeys * LD];
  __shared__ int sseg[kFwdKeys];
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int kvh = h / (a.H / a.KV);
  const int rA = q0 + warp * 16 + grp, rB = rA + 8;
  const int fA = frontier(a, rA), fB = frontier(a, rB);
  const int wmax = warp_max(max(fA, fB));
  const int sA = (a.qseg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
  const int sB = (a.qseg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
  const int kend = frontier(a, min(q0 + kRows, a.Sq) - 1) + 1;
  const size_t oA = rA < a.Sq ? q_off(a, b, rA, h) : 0;
  const size_t oB = rB < a.Sq ? q_off(a, b, rB, h) : 0;

  uint32_t qa[KT][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const int c = s * 16 + tig * 2;
    qa[s][0] = rA < a.Sq ? ld32(q + oA + c) : 0u;
    qa[s][1] = rB < a.Sq ? ld32(q + oB + c) : 0u;
    qa[s][2] = rA < a.Sq ? ld32(q + oA + c + 8) : 0u;
    qa[s][3] = rB < a.Sq ? ld32(q + oB + c + 8) : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kFwdKeys) {
    __syncthreads();  // the previous stage's readers are done
    stage<D, kFwdKeys, LD>(sk, k, b, k0, a.Skv, a.KV, kvh);
    stage<D, kFwdKeys, LD>(sv, v, b, k0, a.Skv, a.KV, kvh);
    if (threadIdx.x < kFwdKeys)
      sseg[threadIdx.x] = (a.kseg && k0 + threadIdx.x < a.Skv)
                              ? a.kseg[size_t(b) * a.Skv + k0 + threadIdx.x]
                              : 0;
    __syncthreads();
    if (wmax < k0) continue;  // warp-uniform: no row of it sees this block

    float s[kFwdKeys / 8][4];
#pragma unroll
    for (int t = 0; t < kFwdKeys / 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      const bf16* krow = sk + (t * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks)
        mma_bf16(s[t], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }
    float bmA = kNeg, bmB = kNeg;
    unsigned keepA = 0u, keepB = 0u;  // bit 2t+e: element kept
#pragma unroll
    for (int t = 0; t < kFwdKeys / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = t * 8 + tig * 2 + e;
        const int key = k0 + kl;
        const bool kA = key <= fA && (!a.qseg || sseg[kl] == sA);
        const bool kB = key <= fB && (!a.qseg || sseg[kl] == sB);
        keepA |= unsigned(kA) << (2 * t + e);
        keepB |= unsigned(kB) << (2 * t + e);
        s[t][e] = kA ? s[t][e] * a.scale : kNeg;
        s[t][2 + e] = kB ? s[t][2 + e] * a.scale : kNeg;
        bmA = fmaxf(bmA, s[t][e]);
        bmB = fmaxf(bmB, s[t][2 + e]);
      }
    }
    const float nmA = fmaxf(mA, quad_max(bmA));
    const float nmB = fmaxf(mB, quad_max(bmB));
    const float cA = expf(mA - nmA), cB = expf(mB - nmB);
    float psA = 0.f, psB = 0.f;
#pragma unroll
    for (int t = 0; t < kFwdKeys / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = 2 * t + e;
        s[t][e] = (keepA >> bit & 1u) ? expf(s[t][e] - nmA) : 0.f;
        s[t][2 + e] = (keepB >> bit & 1u) ? expf(s[t][2 + e] - nmB) : 0.f;
        psA += s[t][e];
        psB += s[t][2 + e];
      }
    }
    lA = lA * cA + psA;  // per-lane partial sums; the quad adds them last
    lB = lB * cB + psB;
    mA = nmA;
    mB = nmB;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= cA;
      acc[t][1] *= cA;
      acc[t][2] *= cB;
      acc[t][3] *= cB;
    }
#pragma unroll
    for (int u = 0; u < kFwdKeys / 16; ++u) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
      pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
      pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
      pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
      const bf16* vk = sv + (u * 16 + tig * 2) * LD + grp;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b0, b1;
        ld_b_kn<LD>(vk + t * 8, b0, b1);
        mma_bf16(acc[t], pa, b0, b1);
      }
    }
  }

  lA = fmaxf(quad_sum(lA), 1e-30f);
  lB = fmaxf(quad_sum(lB), 1e-30f);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = t * 8 + tig * 2;
    if (rA < a.Sq)
      *reinterpret_cast<uint32_t*>(out + oA + d) =
          pack_bf16(acc[t][0] / lA, acc[t][1] / lA);
    if (rB < a.Sq)
      *reinterpret_cast<uint32_t*>(out + oB + d) =
          pack_bf16(acc[t][2] / lB, acc[t][3] / lB);
  }
  if (tig == 0) {
    const size_t st = (size_t(b) * a.H + h) * a.Sq;
    if (rA < a.Sq) a.lse[st + rA] = mA + logf(lA);
    if (rB < a.Sq) a.lse[st + rB] = mB + logf(lB);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_mma(Args a) {
  constexpr int KT = D / 16, NT = D / 8, LD = D + 8;
  constexpr int NS = kDqKeys / 8;  // score n-tiles
  __shared__ __align__(16) bf16 sk[kDqKeys * LD];
  __shared__ __align__(16) bf16 sv[kDqKeys * LD];
  __shared__ int sseg[kDqKeys];
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(a.dout);
  bf16* __restrict__ dq = static_cast<bf16*>(a.dq);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int kvh = h / (a.H / a.KV);
  const int rA = q0 + warp * 16 + grp, rB = rA + 8;
  const int fA = frontier(a, rA), fB = frontier(a, rB);
  const int wmax = warp_max(max(fA, fB));
  const int sA = (a.qseg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
  const int sB = (a.qseg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
  const size_t st = (size_t(b) * a.H + h) * a.Sq;
  const float lseA = rA < a.Sq ? a.lse_in[st + rA] : 0.f;
  const float lseB = rB < a.Sq ? a.lse_in[st + rB] : 0.f;
  const size_t sp = (size_t(b) * a.H + h) * a.Sp;
  const float dlA = rA < a.Sq ? a.delta[sp + rA] : 0.f;
  const float dlB = rB < a.Sq ? a.delta[sp + rB] : 0.f;
  const int kend = frontier(a, min(q0 + kRows, a.Sq) - 1) + 1;
  const size_t oA = rA < a.Sq ? q_off(a, b, rA, h) : 0;
  const size_t oB = rB < a.Sq ? q_off(a, b, rB, h) : 0;

  uint32_t qa[KT][4], da[KT][4];
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const int c = s * 16 + tig * 2;
    qa[s][0] = rA < a.Sq ? ld32(q + oA + c) : 0u;
    qa[s][1] = rB < a.Sq ? ld32(q + oB + c) : 0u;
    qa[s][2] = rA < a.Sq ? ld32(q + oA + c + 8) : 0u;
    qa[s][3] = rB < a.Sq ? ld32(q + oB + c + 8) : 0u;
    da[s][0] = rA < a.Sq ? ld32(dout + oA + c) : 0u;
    da[s][1] = rB < a.Sq ? ld32(dout + oB + c) : 0u;
    da[s][2] = rA < a.Sq ? ld32(dout + oA + c + 8) : 0u;
    da[s][3] = rB < a.Sq ? ld32(dout + oB + c + 8) : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kDqKeys) {
    __syncthreads();
    stage<D, kDqKeys, LD>(sk, k, b, k0, a.Skv, a.KV, kvh);
    stage<D, kDqKeys, LD>(sv, v, b, k0, a.Skv, a.KV, kvh);
    if (threadIdx.x < kDqKeys)
      sseg[threadIdx.x] = (a.kseg && k0 + threadIdx.x < a.Skv)
                              ? a.kseg[size_t(b) * a.Skv + k0 + threadIdx.x]
                              : 0;
    __syncthreads();
    if (wmax < k0) continue;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
      const bf16* krow = sk + (t * 8 + grp) * LD + tig * 2;
      const bf16* vrow = sv + (t * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        mma_bf16(s[t], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
        mma_bf16(dp[t], da[ks], ld32(vrow + ks * 16), ld32(vrow + ks * 16 + 8));
      }
    }
    // dS = P (dP - delta), P = exp(S scale - lse), kept in s
#pragma unroll
    for (int t = 0; t < NS; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = t * 8 + tig * 2 + e;
        const int key = k0 + kl;
        const bool kA = key <= fA && (!a.qseg || sseg[kl] == sA);
        const bool kB = key <= fB && (!a.qseg || sseg[kl] == sB);
        const float pA = kA ? expf(s[t][e] * a.scale - lseA) : 0.f;
        const float pB = kB ? expf(s[t][2 + e] * a.scale - lseB) : 0.f;
        s[t][e] = pA * (dp[t][e] - dlA);
        s[t][2 + e] = pB * (dp[t][2 + e] - dlB);
      }
    }
#pragma unroll
    for (int u = 0; u < kDqKeys / 16; ++u) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
      pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
      pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
      pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
      const bf16* kk = sk + (u * 16 + tig * 2) * LD + grp;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b0, b1;
        ld_b_kn<LD>(kk + t * 8, b0, b1);
        mma_bf16(acc[t], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = t * 8 + tig * 2;
    if (rA < a.Sq)
      *reinterpret_cast<uint32_t*>(dq + oA + d) =
          pack_bf16(acc[t][0] * a.scale, acc[t][1] * a.scale);
    if (rB < a.Sq)
      *reinterpret_cast<uint32_t*>(dq + oB + d) =
          pack_bf16(acc[t][2] * a.scale, acc[t][3] * a.scale);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kKvRows + 2 * kKvQ) * (D + 8) * 2 + 3 * kKvQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_mma(Args a) {
  constexpr int KT = D / 16, NT = D / 8, LD = D + 8;
  constexpr int NS = kKvQ / 8;  // score n-tiles (q rows)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kKvRows * LD;
  bf16* sq = sv + kKvRows * LD;
  bf16* sdo = sq + kKvQ * LD;
  float* slse = reinterpret_cast<float*>(sdo + kKvQ * LD);
  float* sdl = slse + kKvQ;
  int* sseg = reinterpret_cast<int*>(sdl + kKvQ);
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(a.dout);
  bf16* __restrict__ dk = static_cast<bf16*>(a.dk);
  bf16* __restrict__ dv = static_cast<bf16*>(a.dv);

  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * kKvRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int G = a.H / a.KV;
  const int qoff = a.Skv - a.Sq;
  const int jA = j0 + warp * 16 + grp, jB = jA + 8;
  const int wmin = j0 + warp * 16;  // the warp's smallest key
  const int gA = (a.kseg && jA < a.Skv) ? a.kseg[size_t(b) * a.Skv + jA] : 0;
  const int gB = (a.kseg && jB < a.Skv) ? a.kseg[size_t(b) * a.Skv + jB] : 0;

  stage<D, kKvRows, LD>(sk, k, b, j0, a.Skv, a.KV, kvh);
  stage<D, kKvRows, LD>(sv, v, b, j0, a.Skv, a.KV, kvh);

  float ak[NT][4], av[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    ak[t][0] = ak[t][1] = ak[t][2] = ak[t][3] = 0.f;
    av[t][0] = av[t][1] = av[t][2] = av[t][3] = 0.f;
  }
  const bf16* kr = sk + (warp * 16 + grp) * LD + tig * 2;
  const bf16* vr = sv + (warp * 16 + grp) * LD + tig * 2;
  // q blocks before the first row that sees key j0 are skipped
  const int qfirst = a.causal ? max(0, j0 - qoff) / kKvQ * kKvQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = qfirst; q0 < a.Sq; q0 += kKvQ) {
      __syncthreads();  // the previous stage's readers are done
      stage<D, kKvQ, LD>(sq, q, b, q0, a.Sq, a.H, h);
      stage<D, kKvQ, LD>(sdo, dout, b, q0, a.Sq, a.H, h);
      if (threadIdx.x < kKvQ) {
        const int r = q0 + threadIdx.x;
        const bool ok = r < a.Sq;
        const size_t st = (size_t(b) * a.H + h) * a.Sq + r;
        slse[threadIdx.x] = ok ? a.lse_in[st] : 0.f;
        sdl[threadIdx.x] = ok ? a.delta[(size_t(b) * a.H + h) * a.Sp + r] : 0.f;
        sseg[threadIdx.x] = (a.qseg && ok) ? a.qseg[size_t(b) * a.Sq + r] : 0;
      }
      __syncthreads();
      // warp-uniform: the block's last row cannot see the warp's keys
      if (frontier(a, min(q0 + kKvQ, a.Sq) - 1) < wmin) continue;

      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
        dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
        const bf16* qrow = sq + (t * 8 + grp) * LD + tig * 2;
        const bf16* drow = sdo + (t * 8 + grp) * LD + tig * 2;
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          uint32_t fk[4], fv[4];
          fk[0] = ld32(kr + ks * 16);
          fk[1] = ld32(kr + 8 * LD + ks * 16);
          fk[2] = ld32(kr + ks * 16 + 8);
          fk[3] = ld32(kr + 8 * LD + ks * 16 + 8);
          fv[0] = ld32(vr + ks * 16);
          fv[1] = ld32(vr + 8 * LD + ks * 16);
          fv[2] = ld32(vr + ks * 16 + 8);
          fv[3] = ld32(vr + 8 * LD + ks * 16 + 8);
          mma_bf16(s[t], fk, ld32(qrow + ks * 16), ld32(qrow + ks * 16 + 8));
          mma_bf16(dp[t], fv, ld32(drow + ks * 16), ld32(drow + ks * 16 + 8));
        }
      }
      // P^T and dS^T: rows are keys (jA, jB), columns q rows; p kept in s,
      // ds in dp
#pragma unroll
      for (int t = 0; t < NS; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = t * 8 + tig * 2 + e;
          const int fr = frontier(a, q0 + rl);
          const bool kA = jA <= fr && (!a.qseg || sseg[rl] == gA);
          const bool kB = jB <= fr && (!a.qseg || sseg[rl] == gB);
          const float pA = kA ? expf(s[t][e] * a.scale - slse[rl]) : 0.f;
          const float pB = kB ? expf(s[t][2 + e] * a.scale - slse[rl]) : 0.f;
          s[t][e] = pA;
          s[t][2 + e] = pB;
          dp[t][e] = pA * (dp[t][e] - sdl[rl]);
          dp[t][2 + e] = pB * (dp[t][2 + e] - sdl[rl]);
        }
      }
#pragma unroll
      for (int u = 0; u < kKvQ / 16; ++u) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
        pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
        pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
        pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
        da[0] = pack_bf16(dp[2 * u][0], dp[2 * u][1]);
        da[1] = pack_bf16(dp[2 * u][2], dp[2 * u][3]);
        da[2] = pack_bf16(dp[2 * u + 1][0], dp[2 * u + 1][1]);
        da[3] = pack_bf16(dp[2 * u + 1][2], dp[2 * u + 1][3]);
        const bf16* dk_b = sdo + (u * 16 + tig * 2) * LD + grp;
        const bf16* qk_b = sq + (u * 16 + tig * 2) * LD + grp;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t b0, b1;
          ld_b_kn<LD>(dk_b + t * 8, b0, b1);
          mma_bf16(av[t], pa, b0, b1);
          ld_b_kn<LD>(qk_b + t * 8, b0, b1);
          mma_bf16(ak[t], da, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = t * 8 + tig * 2;
    if (jA < a.Skv) {
      const size_t o = k_off(a, b, jA, kvh) + d;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(ak[t][0] * a.scale, ak[t][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(av[t][0], av[t][1]);
    }
    if (jB < a.Skv) {
      const size_t o = k_off(a, b, jB, kvh) + d;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(ak[t][2] * a.scale, ak[t][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(av[t][2], av[t][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper bodies (bf16, D = 64 and 128): wgmma on the tensor cores, TMA into
// a two-stage shared-memory ring guarded by mbarriers, one producer warp
// and two consumer warpgroups of 64 rows each (the forward: W, its own
// FwdHop::kConsumers).
// Layout of a thread's wgmma accumulator d[64 x N] (warp w of the
// warpgroup, lane = 4 grp + tig): d[4 j + 2 hi + e] is row 16 w + grp +
// 8 hi, column 8 j + 2 tig + e.
// ---------------------------------------------------------------------------
// 288 threads, at most 168 registers each: ptxas caps a block of 9 warps
// there (as it does 12). Moving the producer's registers to the consumers
// with setmaxnreg did not lift that cap in ptxas's allocation (the same
// spills with and without it, nvcc 12.9), so the bodies are sized to 168
// instead: see the dk/dv split below.
constexpr int kConsumers = 256;               // two consumer warpgroups (K2)
constexpr int kHopThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 64;  // lse2 / delta rows are padded to this

struct HopParams {
  CUtensorMap tq, tk, tv, tdo;  // bf16 row maps (128-byte swizzle)
  CUtensorMap tlse, tdelta;     // dk/dv: f32 [B * H, Sp] rows
  Args a;
  const float* lse2;            // dq: padded lse * log2(e)
  const float* delta2;          // dq: padded delta
};

// the tile helpers shared with the paged-attention bodies (hopper.cuh)
using hopper::align1024;
using hopper::kmajor;
using hopper::mnmajor;
using hopper::neg_inf;
using hopper::rs;
using hopper::ss;
using hopper::store_rows;
using hopper::to_a;
using hopper::zero;

// slot and phase parity of a kStages ring, walked in the same order by the
// producer and the consumers
struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == kStages) {
      s = 0;
      ph ^= 1u;
    }
  }
};

// shared bytes of a bf16 [rows, D] tile
template <int D>
constexpr uint32_t tile_bytes(int rows) {
  return uint32_t(rows) * D * 2;
}

// TMA a [rows, D] tile (D / 64 panels) of row map `map` at row r0 of head hh
template <int D>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int hh,
                                         int r0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    hopper::tma_load_4d(dst + p * rows * 64, map, bar, p * 64, hh, r0, b);
}

// K1 forward: one CTA per (BM = 64 W q rows, head, batch row), W consumer
// warpgroups of 64 rows and one producer warp; BN keys a stage. The tile
// (BM, BN) is what K7 (the measured search, ops/kernels/autotune.py)
// chooses among; kFwdTiles lists the instances that are built.
template <int D, int W, int BN_>
struct FwdHop {
  static constexpr int BM = 64 * W, BN = BN_;  // q rows, keys a stage
  static constexpr int kConsumers = 128 * W;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr uint32_t QB = tile_bytes<D>(BM), KB = tile_bytes<D>(BN);
  static constexpr int smem = QB + kStages * 2 * KB + 64 + 1024;
  static_assert(W >= 1 && W <= 3 && (BN == 64 || BN == 128),
                "K1 tiles: 1 to 3 warpgroups, 64 or 128 keys a stage");
};

// The built (D, W, BN) instances, each D's default first. Every instance
// runs the softmax over the same 64-key sub-steps in the same order, so all
// compute the same bits: a tile changes only the speed. ptxas caps a
// block's registers a thread by its warpgroups, rounded up (the producer
// warp counts as one): 255 at W = 1, 168 at W = 2, 128 at W = 3 (nvcc
// 12.8). An instance that spills is left out (chip_smoke.py's build phase
// fails on a spill of a listed one): at D = 128, W = 3 spills (o alone is
// 64 registers a thread), and at D = 64, W = 3 with 128 keys a stage.
struct FwdTile {
  int D, W, BN;
};
constexpr FwdTile kFwdTiles[] = {
    {128, 2, 128},  // the default, (0, 0)
    {128, 1, 64}, {128, 1, 128}, {128, 2, 64},
    {64, 2, 128},   // the default, (0, 0)
    {64, 1, 64},  {64, 1, 128},  {64, 2, 64}, {64, 3, 64},
};
constexpr int kNumFwdTiles = sizeof(kFwdTiles) / sizeof(kFwdTiles[0]);

// a shared-memory descriptor `base` advanced by `off` (16-byte units),
// computed where it is used: the empty asm keeps the compiler from
// computing a whole wgmma batch's descriptors into registers ahead of it
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t off) {
  asm volatile("" : "+l"(base));
  return base + off;
}


template <int D, int W, int BN>
__global__ void __launch_bounds__(FwdHop<D, W, BN>::kThreads, 1)
    fwd_wgmma(const __grid_constant__ HopParams P) {
  using C = FwdHop<D, W, BN>;
  constexpr int BM = C::BM, kConsumers = C::kConsumers;
  // A stage of BN = 128 keys runs as two softmax sub-steps of 64, the
  // second's S = Q K^T issued before the first's softmax, and every wgmma's
  // descriptors are formed where it is issued (desc_at). Together they keep
  // the 128 x 128 default within W = 2's 168 registers without a spill; a
  // one-step 128-key body spills 8 bytes there and runs ~4% faster (the K1
  // table in PERF.md).
  constexpr int SN = 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = reinterpret_cast<bf16*>(smem + C::QB);  // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::QB +
                                               kStages * 2 * C::KB);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  const Args& a = P.a;
  // the q blocks of one (head, batch row) launch together, so the K and V
  // they all stream stay in L2; causal: the heaviest (last rows) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int qb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BM;
  const int kvh = h / (a.H / a.KV);
  // keys [0, kend) reach the block's last row
  const int kend = frontier(a, min(q0 + BM, a.Sq) - 1) + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    if (threadIdx.x == kConsumers) {
      hopper::mbar_arrive_tx(bars, C::QB);
      tma_rows<D>(sq, &P.tq, bars, BM, h, q0, b);
      Ring ring;
      for (int k0 = 0; k0 < kend; k0 += BN, ring.next()) {
        // parity ph ^ 1: the first round passes, as the slot starts empty
        hopper::mbar_wait(empty + ring.s, ring.ph ^ 1);
        hopper::mbar_arrive_tx(full + ring.s, 2 * C::KB);
        bf16* ks = skv + ring.s * 2 * BN * D;
        tma_rows<D>(ks, &P.tk, full + ring.s, BN, kvh, k0, b);
        tma_rows<D>(ks + BN * D, &P.tv, full + ring.s, BN, kvh, k0, b);
      }
    }
  } else {  // W consumer warpgroups, 64 q rows each
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
    const int r0 = q0 + wg * 64;
    const int rA = r0 + w * 16 + grp, rB = rA + 8;
    // the warpgroup's smallest frontier (-1 when its rows start past Sq:
    // every tile is then masked, and nothing of it is stored)
    const int f0 = frontier(a, r0);
    const bool seg = a.qseg != nullptr;
    const int fA = frontier(a, rA), fB = frontier(a, rB);
    const int sA = (seg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
    const int sB = (seg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
    const float sl2 = a.scale * kLog2e;  // scores in base 2
    float o[D / 2];
    zero(o);
    float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;
    hopper::mbar_wait(bars, 0);
    Ring ring;
    for (int k0 = 0; k0 < kend; k0 += BN, ring.next()) {
      hopper::mbar_wait(full + ring.s, ring.ph);
      const bf16* ks = skv + ring.s * 2 * BN * D;
      const bf16* vs = ks + BN * D;
      // scores of sub-step hs land in s2[hs & 1]; the first goes in here
      const uint64_t dq0 = kmajor(sq, BM, wg * 64, 0);
      float s2[2][SN / 2];
      {
        hopper::wgmma_fence();
        const uint64_t dk0 = kmajor(ks, BN, 0, 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ss<SN>(s2[0], desc_at(dq0, (kk >> 2) * BM * 8 + (kk & 3) * 2),
                 desc_at(dk0, (kk >> 2) * BN * 8 + (kk & 3) * 2), kk > 0);
        hopper::wgmma_commit();
      }
#pragma unroll
      for (int hs = 0; hs < BN / SN; ++hs) {
        const int kh = k0 + hs * SN;  // the sub-step's first key
        float (&sc)[SN / 2] = s2[hs & 1];
        hopper::wgmma_wait<0>();
        hopper::fence_operand(sc);
        hopper::fence_operand(o);
        if (hs + 1 < BN / SN) {
          // the next sub-step's scores run on the tensor cores while this
          // one's softmax runs
          float (&sn)[SN / 2] = s2[(hs + 1) & 1];
          hopper::wgmma_fence();
          const uint64_t dk1 = kmajor(ks, BN, (hs + 1) * SN, 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            ss<SN>(sn, desc_at(dq0, (kk >> 2) * BM * 8 + (kk & 3) * 2),
                   desc_at(dk1, (kk >> 2) * BN * 8 + (kk & 3) * 2), kk > 0);
          hopper::wgmma_commit();
        }
        // the mask only where a key past a row's frontier (or a segment
        // boundary) can fall in the tile; masked scores become -inf, so
        // their probability is exactly 0 and m never drops below kNeg
        if (seg || kh + SN - 1 > f0) {
#pragma unroll
          for (int i = 0; i < SN / 2; ++i) {
            const int key = kh + 8 * (i >> 2) + 2 * tig + (i & 1);
            const bool hi = (i >> 1) & 1;
            bool keep = key <= (hi ? fB : fA);
            if (seg && keep)
              keep = a.kseg[size_t(b) * a.Skv + key] == (hi ? sB : sA);
            if (!keep) sc[i] = neg_inf();
          }
        }
        float bA = neg_inf(), bB = neg_inf();
#pragma unroll
        for (int j = 0; j < SN / 8; ++j) {
          bA = fmaxf(bA, fmaxf(sc[4 * j], sc[4 * j + 1]));
          bB = fmaxf(bB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        const float nA = fmaxf(mA, quad_max(bA) * sl2);
        const float nB = fmaxf(mB, quad_max(bB) * sl2);
        const float cA = exp2f(mA - nA), cB = exp2f(mB - nB);
        float pA = 0.f, pB = 0.f;
#pragma unroll
        for (int j = 0; j < SN / 8; ++j) {
          sc[4 * j] = exp2f(fmaf(sc[4 * j], sl2, -nA));
          sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], sl2, -nA));
          sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], sl2, -nB));
          sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], sl2, -nB));
          pA += sc[4 * j] + sc[4 * j + 1];
          pB += sc[4 * j + 2] + sc[4 * j + 3];
        }
        lA = lA * cA + pA;  // per-lane partial sums; the quad adds them last
        lB = lB * cB + pB;
        mA = nA;
        mB = nB;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= cA;
          o[4 * j + 1] *= cA;
          o[4 * j + 2] *= cB;
          o[4 * j + 3] *= cB;
        }
        uint32_t pa[SN / 16][4];
#pragma unroll
        for (int kk = 0; kk < SN / 16; ++kk) to_a(pa[kk], sc, kk);
        hopper::wgmma_fence();
        const uint64_t dv0 = mnmajor(vs, BN, hs * (SN / 16));
#pragma unroll
        for (int kk = 0; kk < SN / 16; ++kk)
          rs<D>(o, pa[kk], desc_at(dv0, kk * 128));
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);
      hopper::mbar_arrive(empty + ring.s);
    }
    lA = fmaxf(quad_sum(lA), 1e-30f);
    lB = fmaxf(quad_sum(lB), 1e-30f);
    const size_t oA = rA < a.Sq ? q_off(a, b, rA, h) : 0;
    const size_t oB = rB < a.Sq ? q_off(a, b, rB, h) : 0;
    store_rows<D>(static_cast<bf16*>(a.out), o, oA, rA < a.Sq, 1.f / lA, oB,
                  rB < a.Sq, 1.f / lB, tig);
    if (tig == 0) {
      // natural-log lse; a row that saw no key keeps m = kNeg, as the
      // plain version's -1e30 + log(1e-30) rounds to -1e30
      const size_t st = (size_t(b) * a.H + h) * a.Sq;
      if (rA < a.Sq) a.lse[st + rA] = mA == kNeg ? kNeg : mA * kLn2 + logf(lA);
      if (rB < a.Sq) a.lse[st + rB] = mB == kNeg ? kNeg : mB * kLn2 + logf(lB);
    }
  }
}


// K2 dq: one CTA per (128 q rows, head, batch row); Q and dO resident, 64
// keys of K and V a stage. S = Q K^T and dP = dO V^T from shared memory,
// dS = P (dP - delta) in registers, dq += dS K with K read transposed.
template <int D>
struct DqHop {
  static constexpr int BM = 128, BN = 64;
  static constexpr uint32_t QB = tile_bytes<D>(BM), KB = tile_bytes<D>(BN);
  static constexpr int smem = 2 * QB + kStages * 2 * KB + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    dq_wgmma(const __grid_constant__ HopParams P) {
  using C = DqHop<D>;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + BM * D;
  bf16* skv = reinterpret_cast<bf16*>(smem + 2 * C::QB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * C::QB +
                                               kStages * 2 * C::KB);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  const Args& a = P.a;
  const int h = blockIdx.y, b = blockIdx.z;  // as the forward
  const int qb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BM;
  const int kvh = h / (a.H / a.KV);
  // keys [0, kend) reach the block's last row
  const int kend = frontier(a, min(q0 + BM, a.Sq) - 1) + 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      hopper::mbar_arrive_tx(bars, 2 * C::QB);
      tma_rows<D>(sq, &P.tq, bars, BM, h, q0, b);
      tma_rows<D>(sdo, &P.tdo, bars, BM, h, q0, b);
      Ring ring;
      for (int k0 = 0; k0 < kend; k0 += BN, ring.next()) {
        // parity ph ^ 1: the first round passes, as the slot starts empty
        hopper::mbar_wait(empty + ring.s, ring.ph ^ 1);
        hopper::mbar_arrive_tx(full + ring.s, 2 * C::KB);
        bf16* ks = skv + ring.s * 2 * BN * D;
        tma_rows<D>(ks, &P.tk, full + ring.s, BN, kvh, k0, b);
        tma_rows<D>(ks + BN * D, &P.tv, full + ring.s, BN, kvh, k0, b);
      }
    }
  } else {
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
    const int r0 = q0 + wg * 64;
    const int rA = r0 + w * 16 + grp, rB = rA + 8;
    const int fA = frontier(a, rA), fB = frontier(a, rB);
    const int f0 = frontier(a, r0);
    const bool seg = a.qseg != nullptr;
    const int sA = (seg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
    const int sB = (seg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
    const size_t st = (size_t(b) * a.H + h) * a.Sp;
    const float lA = rA < a.Sq ? P.lse2[st + rA] : 0.f;
    const float lB = rB < a.Sq ? P.lse2[st + rB] : 0.f;
    const float dA = rA < a.Sq ? P.delta2[st + rA] : 0.f;
    const float dB = rB < a.Sq ? P.delta2[st + rB] : 0.f;
    const float sl2 = a.scale * kLog2e;
    float dq[D / 2];
    zero(dq);
    hopper::mbar_wait(bars, 0);
    Ring ring;
    for (int k0 = 0; k0 < kend; k0 += BN, ring.next()) {
      hopper::mbar_wait(full + ring.s, ring.ph);
      const bf16* ks = skv + ring.s * 2 * BN * D;
      const bf16* vs = ks + BN * D;
      float sc[BN / 2], dp[BN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ss<BN>(sc, kmajor(sq, BM, wg * 64, kk), kmajor(ks, BN, 0, kk), kk > 0);
        ss<BN>(dp, kmajor(sdo, BM, wg * 64, kk), kmajor(vs, BN, 0, kk),
               kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(sc);
      hopper::fence_operand(dp);
      if (seg || k0 + BN - 1 > f0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const bool hi = (i >> 1) & 1;
          bool keep = key <= (hi ? fB : fA);
          if (seg && keep)
            keep = a.kseg[size_t(b) * a.Skv + key] == (hi ? sB : sA);
          if (!keep) sc[i] = neg_inf();
        }
      }
      // dS = P (dP - delta), P = exp2(S scale log2(e) - lse2), kept in sc
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool hi = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[i], sl2, -(hi ? lB : lA)));
        sc[i] = p * (dp[i] - (hi ? dB : dA));
      }
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a(da[kk], sc, kk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) rs<D>(dq, da[kk], mnmajor(ks, BN, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dq);
      hopper::mbar_arrive(empty + ring.s);
    }
    const size_t oA = rA < a.Sq ? q_off(a, b, rA, h) : 0;
    const size_t oB = rB < a.Sq ? q_off(a, b, rB, h) : 0;
    store_rows<D>(static_cast<bf16*>(a.dq), dq, oA, rA < a.Sq, a.scale, oB,
                  rB < a.Sq, a.scale, tig);
  }
}

// K2 dk/dv: one CTA per (BN keys, KV head, batch row); K and V resident,
// 64 q rows of Q, dO, lse2 and delta a stage, for each query head of the
// GQA group from the first q block that sees the CTA's keys. S^T = K Q^T
// and dP^T = V dO^T from shared memory; dv += P^T dO and dk += dS^T Q
// with P^T, dS^T in registers and dO, Q read transposed.
template <int D>
struct DkvHop {
  // D = 128 splits the head dim between the warpgroups: both hold S^T and
  // dP^T of the CTA's 64 keys and each accumulates 64 columns of dk and
  // dv, which keeps a thread within the 168 registers of a 288-thread
  // block (one warpgroup owning 64 keys x 128 columns of dk and dv needs
  // some 200 and spills). D = 64 gives each warpgroup 64 keys of its own.
  static constexpr bool kSplit = D == 128;
  static constexpr int BN = kSplit ? 64 : 128, BQ = 64;
  static constexpr int DW = kSplit ? D / 2 : D;  // dk, dv columns a thread
  static constexpr uint32_t KB = tile_bytes<D>(BN), QB = tile_bytes<D>(BQ);
  static constexpr uint32_t VB = BQ * 4;  // one lse2 or delta tile
  static constexpr int smem =
      2 * KB + kStages * (2 * QB + 2 * VB) + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    dkv_wgmma(const __grid_constant__ HopParams P) {
  using C = DkvHop<D>;
  constexpr int BN = C::BN, BQ = C::BQ, DW = C::DW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + BN * D;
  bf16* sqd = reinterpret_cast<bf16*>(smem + 2 * C::KB);  // stage: Q, dO
  float* svec = reinterpret_cast<float*>(smem + 2 * C::KB +
                                         kStages * 2 * C::QB);  // lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + 2 * C::KB + kStages * (2 * C::QB + 2 * C::VB));
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  const Args& a = P.a;
  // the key blocks of one (KV head, batch row) launch together, so the Q
  // and dO they all stream stay in L2; causal: the first keys see the most
  // q rows, so they launch first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * BN;
  const int G = a.H / a.KV;
  const int qoff = a.Skv - a.Sq;
  const int qfirst = a.causal ? max(0, j0 - qoff) / BQ * BQ : 0;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      hopper::mbar_arrive_tx(bars, 2 * C::KB);
      tma_rows<D>(sk, &P.tk, bars, BN, kvh, j0, b);
      tma_rows<D>(sv, &P.tv, bars, BN, kvh, j0, b);
      Ring ring;
      for (int h = kvh * G; h < (kvh + 1) * G; ++h) {
        for (int q0 = qfirst; q0 < a.Sq; q0 += BQ, ring.next()) {
          uint64_t* bar = full + ring.s;
          hopper::mbar_wait(empty + ring.s, ring.ph ^ 1);
          hopper::mbar_arrive_tx(bar, 2 * C::QB + 2 * C::VB);
          bf16* qs = sqd + ring.s * 2 * BQ * D;
          float* vs = svec + ring.s * 2 * BQ;
          tma_rows<D>(qs, &P.tq, bar, BQ, h, q0, b);
          tma_rows<D>(qs + BQ * D, &P.tdo, bar, BQ, h, q0, b);
          hopper::tma_load_2d(vs, &P.tlse, bar, q0, b * a.H + h);
          hopper::tma_load_2d(vs + BQ, &P.tdelta, bar, q0, b * a.H + h);
        }
      }
    }
  } else {
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
    const int k0 = C::kSplit ? 0 : wg * 64;  // the warpgroup's first key row
    const int c0 = C::kSplit ? wg * DW : 0;  // and first dk, dv column
    const int jA = j0 + k0 + w * 16 + grp, jB = jA + 8;
    const int jmax = j0 + k0 + 63;  // the warpgroup's last key
    const bool seg = a.qseg != nullptr;
    const int gA = (seg && jA < a.Skv) ? a.kseg[size_t(b) * a.Skv + jA] : 0;
    const int gB = (seg && jB < a.Skv) ? a.kseg[size_t(b) * a.Skv + jB] : 0;
    const float sl2 = a.scale * kLog2e;
    float dk[DW / 2], dv[DW / 2];
    zero(dk);
    zero(dv);
    hopper::mbar_wait(bars, 0);
    Ring ring;
    // the producer's order: each head of the group, then its q blocks
    for (int g = 0; g < G; ++g)
    for (int q0 = qfirst; q0 < a.Sq; q0 += BQ, ring.next()) {
      hopper::mbar_wait(full + ring.s, ring.ph);
      const bf16* qs = sqd + ring.s * 2 * BQ * D;
      const bf16* dos = qs + BQ * D;
      const float* vl = svec + ring.s * 2 * BQ;
      const float* vd = vl + BQ;
      float st[BQ / 2], dpt[BQ / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ss<BQ>(st, kmajor(sk, BN, k0, kk), kmajor(qs, BQ, 0, kk), kk > 0);
        ss<BQ>(dpt, kmajor(sv, BN, k0, kk), kmajor(dos, BQ, 0, kk), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(st);
      hopper::fence_operand(dpt);
      // rows (keys) jA, jB; columns q rows q0 + 8 j + 2 tig + e. The mask
      // only where a tile holds rows past Sq, keys past Skv, pairs past the
      // causal frontier or segments, as -inf scores (probability 0: lse2 is
      // finite, pad rows' 0 included), in a loop of its own: the per-element
      // tests inside the exp loop cost more than the tiles that need them
      if (seg || q0 + BQ > a.Sq || jmax >= a.Skv ||
          (a.causal && jmax > q0 + qoff)) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int r = q0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const bool hi = (i >> 1) & 1;
          const int j = hi ? jB : jA;
          bool keep = r < a.Sq && j < a.Skv && (!a.causal || j <= r + qoff);
          if (seg && keep)
            keep = a.qseg[size_t(b) * a.Sq + r] == (hi ? gB : gA);
          if (!keep) st[i] = neg_inf();
        }
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * tig + (i & 1);
        const float p = exp2f(fmaf(st[i], sl2, -vl[c]));
        st[i] = p;
        dpt[i] = p * (dpt[i] - vd[c]);
      }
      // one product after the other, so that P^T's registers are free
      // before dS^T's fragments are made
      {
        uint32_t pa[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) to_a(pa[kk], st, kk);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          rs<DW>(dv, pa[kk], mnmajor(dos + c0 * BQ, BQ, kk));
      }
      {
        uint32_t da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) to_a(da[kk], dpt, kk);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          rs<DW>(dk, da[kk], mnmajor(qs + c0 * BQ, BQ, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(dv);
      hopper::fence_operand(dk);
      hopper::mbar_arrive(empty + ring.s);
    }
    const size_t oA = jA < a.Skv ? k_off(a, b, jA, kvh) : 0;
    const size_t oB = jB < a.Skv ? k_off(a, b, jB, kvh) : 0;
    store_rows<DW>(static_cast<bf16*>(a.dk) + c0, dk, oA, jA < a.Skv,
                   a.scale, oB, jB < a.Skv, a.scale, tig);
    store_rows<DW>(static_cast<bf16*>(a.dv) + c0, dv, oA, jA < a.Skv, 1.f,
                   oB, jB < a.Skv, 1.f, tig);
  }
}

// K2 pre-pass: delta = rowsum(dO o O) and lse2 = lse log2(e), both f32
// [B, H, Sp] with zero pad rows, from one read of O, dO and lse. L lanes
// (16 bytes each) per (batch, row, head), rows walked in memory order.
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_prepass(Args a, const void* outp,
                                                   float* lse2, float* delta) {
  constexpr int V = 16 / sizeof(T);  // elements per lane
  constexpr int L = D / V;           // lanes per row
  const T* out = static_cast<const T*>(outp);
  const T* dout = static_cast<const T*>(a.dout);
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row = idx / L;  // over (b, r, h), h fastest
  const int c = int(idx % L);
  const int h = int(row % a.H);
  const int r = int(row / a.H % a.Sp);
  const int b = int(row / (size_t(a.H) * a.Sp));
  const bool live = b < a.B && r < a.Sq;
  float sum = 0.f;
  if (live) {
    const size_t o = q_off(a, b, r, h) + size_t(c) * V;
    const uint4 x = *reinterpret_cast<const uint4*>(out + o);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + o);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += float(xs[i]) * float(ys[i]);
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (c == 0 && b < a.B) {
    const size_t st = (size_t(b) * a.H + h) * a.Sp + r;
    delta[st] = sum;
    lse2[st] = live ? a.lse_in[(size_t(b) * a.H + h) * a.Sq + r] * kLog2e : 0.f;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// the Hopper bodies take bf16 at D = 64 and 128 with at least one q row and
// one key (a tensor map needs every dimension > 0)
bool hop_ok(const Args& a, int dtype) {
  return dtype == 1 && (a.D == 64 || a.D == 128) && a.Sq > 0 && a.Skv > 0;
}

template <int D, int W, int BN>
cudaError_t fwd_hop(const Args& a, cudaStream_t s) {
  using C = FwdHop<D, W, BN>;
  HopParams p{};
  p.a = a;
  if (!hopper_host::encode_rows(&p.tq, a.q, a.B, a.Sq, a.H, D, C::BM) ||
      !hopper_host::encode_rows(&p.tk, a.k, a.B, a.Skv, a.KV, D, C::BN) ||
      !hopper_host::encode_rows(&p.tv, a.v, a.B, a.Skv, a.KV, D, C::BN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_wgmma<D, W, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + C::BM - 1) / C::BM, a.H, a.B);
  fwd_wgmma<D, W, BN><<<grid, C::kThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

// the Hopper forward at tile (bq, bkv) = (64 W, BN); (0, 0) is the first
// tile kFwdTiles lists for a.D. A pair not listed for a.D is refused.
template <int I = 0>
cudaError_t fwd_hop_tile(const Args& a, int bq, int bkv, cudaStream_t s) {
  if constexpr (I == kNumFwdTiles) {
    return cudaErrorInvalidValue;
  } else {
    constexpr FwdTile t = kFwdTiles[I];
    const bool deflt = bq == 0 && bkv == 0;
    if (a.D == t.D && (deflt || (bq == 64 * t.W && bkv == t.BN)))
      return fwd_hop<t.D, t.W, t.BN>(a, s);
    return fwd_hop_tile<I + 1>(a, bq, bkv, s);
  }
}

template <typename T, int D>
cudaError_t prepass(const Args& a, const void* out, float* work,
                    cudaStream_t s) {
  constexpr int L = D * int(sizeof(T)) / 16;
  const size_t lanes = size_t(a.B) * a.Sp * a.H * L;
  bwd_prepass<T, D><<<unsigned((lanes + 255) / 256), 256, 0, s>>>(
      a, out, work, work + size_t(a.B) * a.H * a.Sp);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_hop(const Args& a, const float* work, cudaStream_t s) {
  using C = DqHop<D>;
  HopParams p{};
  p.a = a;
  p.lse2 = work;
  p.delta2 = work + size_t(a.B) * a.H * a.Sp;
  if (!hopper_host::encode_rows(&p.tq, a.q, a.B, a.Sq, a.H, D, C::BM) ||
      !hopper_host::encode_rows(&p.tdo, a.dout, a.B, a.Sq, a.H, D, C::BM) ||
      !hopper_host::encode_rows(&p.tk, a.k, a.B, a.Skv, a.KV, D, C::BN) ||
      !hopper_host::encode_rows(&p.tv, a.v, a.B, a.Skv, a.KV, D, C::BN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + C::BM - 1) / C::BM, a.H, a.B);
  dq_wgmma<D><<<grid, kHopThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_hop(const Args& a, const float* work, cudaStream_t s) {
  using C = DkvHop<D>;
  HopParams p{};
  p.a = a;
  const float* delta = work + size_t(a.B) * a.H * a.Sp;
  if (!hopper_host::encode_rows(&p.tq, a.q, a.B, a.Sq, a.H, D, C::BQ) ||
      !hopper_host::encode_rows(&p.tdo, a.dout, a.B, a.Sq, a.H, D, C::BQ) ||
      !hopper_host::encode_rows(&p.tk, a.k, a.B, a.Skv, a.KV, D, C::BN) ||
      !hopper_host::encode_rows(&p.tv, a.v, a.B, a.Skv, a.KV, D, C::BN) ||
      !hopper_host::encode_f32_rows(&p.tlse, work, a.B * a.H, a.Sp, C::BQ) ||
      !hopper_host::encode_f32_rows(&p.tdelta, delta, a.B * a.H, a.Sp, C::BQ))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Skv + C::BN - 1) / C::BN, a.KV, a.B);
  dkv_wgmma<D><<<grid, kHopThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

dim3 row_grid(const Args& a, int rows_per_cta) {
  return dim3((a.Sq + rows_per_cta - 1) / rows_per_cta, a.H, a.B);
}

dim3 key_grid(const Args& a, int keys_per_cta) {
  return dim3((a.Skv + keys_per_cta - 1) / keys_per_cta, a.KV, a.B);
}


template <int D>
cudaError_t bwd_mma(const Args& a, int parts, cudaStream_t s) {
  if ((parts & 2) && a.Sq > 0) {
    dq_mma<D><<<row_grid(a, kRows), kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (!(parts & 4) || a.Skv <= 0) return cudaSuccess;
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t e;
  e = cudaFuncSetAttribute(dkv_mma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dkv_mma<D><<<key_grid(a, kKvRows), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_hop(const Args& a, const float* work, int parts,
                    cudaStream_t s) {
  if (parts & 2) {
    cudaError_t e = dq_hop<D>(a, work, s);
    if (e != cudaSuccess) return e;
  }
  return (parts & 4) ? dkv_hop<D>(a, work, s) : cudaSuccess;
}

template <int NI>
cudaError_t fwd_f(const Args& a, cudaStream_t s) {
  fwd_fma<NI><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NI>
cudaError_t bwd_f(const Args& a, int parts, cudaStream_t s) {
  if ((parts & 2) && a.Sq > 0) {
    dq_fma<NI><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (!(parts & 4) || a.Skv <= 0) return cudaSuccess;
  dkv_fma<NI><<<key_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_fwd(const Args& a, int dtype, int bq, int bkv,
                    cudaStream_t s) {
  if (hop_ok(a, dtype)) return fwd_hop_tile(a, bq, bkv, s);
  // the mma and FMA bodies have one tile each: (0, 0)
  if (bq != 0 || bkv != 0) return cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (a.D) {
      case 16: fwd_mma<16><<<row_grid(a, kRows), kThreads, 0, s>>>(a); break;
      case 32: fwd_mma<32><<<row_grid(a, kRows), kThreads, 0, s>>>(a); break;
      case 64: fwd_mma<64><<<row_grid(a, kRows), kThreads, 0, s>>>(a); break;
      case 128: fwd_mma<128><<<row_grid(a, kRows), kThreads, 0, s>>>(a); break;
      default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  switch (a.D) {
    case 16:
    case 32: return fwd_f<1>(a, s);
    case 64: return fwd_f<2>(a, s);
    case 128: return fwd_f<4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_prepass(const Args& a, int dtype, const void* out,
                        float* work, cudaStream_t s) {
  if (dtype == 1) {
    switch (a.D) {
      case 16: return prepass<bf16, 16>(a, out, work, s);
      case 32: return prepass<bf16, 32>(a, out, work, s);
      case 64: return prepass<bf16, 64>(a, out, work, s);
      case 128: return prepass<bf16, 128>(a, out, work, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (a.D) {
    case 16: return prepass<float, 16>(a, out, work, s);
    case 32: return prepass<float, 32>(a, out, work, s);
    case 64: return prepass<float, 64>(a, out, work, s);
    case 128: return prepass<float, 128>(a, out, work, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_bwd(const Args& a, int dtype, const void* out, float* work,
                    int parts, cudaStream_t s) {
  if ((parts & 1) && a.Sq > 0) {
    cudaError_t e = run_prepass(a, dtype, out, work, s);
    if (e != cudaSuccess) return e;
  }
  if (hop_ok(a, dtype))
    return a.D == 64 ? bwd_hop<64>(a, work, parts, s)
                     : bwd_hop<128>(a, work, parts, s);
  if (dtype == 1) {
    switch (a.D) {
      case 16: return bwd_mma<16>(a, parts, s);
      case 32: return bwd_mma<32>(a, parts, s);
      case 64: return bwd_mma<64>(a, parts, s);
      case 128: return bwd_mma<128>(a, parts, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (a.D) {
    case 16:
    case 32: return bwd_f<1>(a, parts, s);
    case 64: return bwd_f<2>(a, parts, s);
    case 128: return bwd_f<4>(a, parts, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it). lse [B, H, Sq].
// (block_q, block_kv): a tile flash_attention_fwd_tiles lists for (D,
// dtype), or (0, 0) for the body's default; any other pair, or a pair on a
// call the Hopper body does not take (no key), returns
// cudaErrorInvalidValue without a launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, void* out, void* lse, int B, int Sq, int Skv, int H,
    int KV, int D, int causal, float scale, int dtype, int block_q,
    int block_kv, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KV = KV; a.D = D;
  a.causal = causal;
  a.scale = scale;
  return static_cast<int>(
      run_fwd(a, dtype, block_q, block_kv, static_cast<cudaStream_t>(stream)));
}

// The forward's built tiles for (D, dtype) as (block_q, block_kv) pairs in
// out[2 i], out[2 i + 1], the default first; returns how many there are
// (at most `max` are written). Only the Hopper body (bf16, D = 64 and 128)
// has tiles to choose: 0 for any other (D, dtype).
extern "C" int flash_attention_fwd_tiles(int D, int dtype, int* out, int max) {
  int n = 0;
  if (dtype != 1) return 0;
  for (int i = 0; i < kNumFwdTiles; ++i) {
    if (kFwdTiles[i].D != D) continue;
    if (n < max) {
      out[2 * n] = 64 * kFwdTiles[i].W;
      out[2 * n + 1] = kFwdTiles[i].BN;
    }
    ++n;
  }
  return n;
}

// dq, dk, dv are written whole (every element, zeros where no q row sees a
// key). `work` is f32 [2, B, H, Sp], Sp = Sq rounded up to 64: the
// pre-pass writes lse * log2(e) and delta = rowsum(dout * out) there.
// `parts` selects the launches: 1 the pre-pass, 2 the dq kernel, 4 the
// dk/dv kernel (7: the whole backward).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, const void* qseg,
    const void* kseg, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
    int H, int KV, int D, int causal, float scale, int dtype, int parts,
    void* stream) {
  if (B <= 0 || H <= 0 || (Sq <= 0 && Skv <= 0)) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(work) +
            size_t(B) * H * ((Sq + kPad - 1) / kPad * kPad);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KV = KV; a.D = D;
  a.Sp = (Sq + kPad - 1) / kPad * kPad;
  a.causal = causal;
  a.scale = scale;
  return static_cast<int>(run_bwd(a, dtype, out, static_cast<float*>(work),
                                  parts, static_cast<cudaStream_t>(stream)));
}
