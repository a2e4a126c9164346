// K1 and K2: flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K1 flash_attention_fwd -> _pallas_fa -> _fwd_kernel: online-softmax
//      attention that emits O and the f32 per-row logsumexp (lse);
//   K2 _fa_bwd -> _pallas_fa_bwd -> _dq_kernel and _dkv_kernel: the
//      FlashAttention-2 backward, P recomputed as exp(S - lse).
//
// Layouts: q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, KV, D]
// (the paddle layout, indexed directly: no [B*H, S, D] copy); lse and
// delta [B, H, Sq] f32; optional int32 segment ids qseg [B, Sq] and kseg
// [B, Skv] (a pair attends only within equal ids). Query head h reads KV
// head h / (H / KV): GQA is native, and each KV head's dk/dv sum the G
// query heads of its group inside one CTA.
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
// (0.080 ms at 3.35 TB/s).
//
// Design. bf16 runs tensor-core bodies on mma.sync m16n8k16 (the tile
// pattern of paged_attention.cu); fp32 runs simple FMA bodies. Neither
// uses atomics: each output element is owned by one CTA, so the backward
// is deterministic.
//   forward (bf16): one CTA of 4 warps per (64 q rows, head, batch row),
//     16 rows per warp held as mma A fragments; K and V are staged in
//     padded shared memory 64 keys at a time, up to the tile's causal
//     frontier (later blocks are never read); S = Q K^T and acc += P V.
//   dq (bf16): the same CTA shape with Q and dO in registers; K and V
//     staged 32 keys at a time; S = Q K^T, dP = dO V^T, dS = P (dP - delta),
//     dq += dS K.
//   dk/dv (bf16): one CTA per (64 keys, KV head, batch row), 16 keys per
//     warp; K and V stay in shared memory; the CTA walks the q rows of
//     each head of the group 32 at a time from the first q block that sees
//     its keys, computing S^T = K Q^T and dP^T = V dO^T, then
//     dv += P^T dO and dk += dS^T Q.
//   fp32: one warp per 4 rows (forward, dq) or 4 keys (dk/dv), each lane
//     owning head-dim elements d = lane + 32 n; dot products by warp
//     shuffles. Right first; the fp32 path is not the training path.
// wgmma, TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
    dl[i] = live ? a.delta[st] : 0.f;
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
      const float dl = a.delta[st];
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
  const float dlA = rA < a.Sq ? a.delta[st + rA] : 0.f;
  const float dlB = rB < a.Sq ? a.delta[st + rB] : 0.f;
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
        sdl[threadIdx.x] = ok ? a.delta[st] : 0.f;
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
// launches
// ---------------------------------------------------------------------------
dim3 row_grid(const Args& a, int rows_per_cta) {
  return dim3((a.Sq + rows_per_cta - 1) / rows_per_cta, a.H, a.B);
}

dim3 key_grid(const Args& a, int keys_per_cta) {
  return dim3((a.Skv + keys_per_cta - 1) / keys_per_cta, a.KV, a.B);
}

template <int D>
cudaError_t bwd_mma(const Args& a, cudaStream_t s) {
  if (a.Sq > 0) {
    dq_mma<D><<<row_grid(a, kRows), kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv <= 0) return cudaSuccess;
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t e;
  e = cudaFuncSetAttribute(dkv_mma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dkv_mma<D><<<key_grid(a, kKvRows), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int NI>
cudaError_t fwd_f(const Args& a, cudaStream_t s) {
  fwd_fma<NI><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NI>
cudaError_t bwd_f(const Args& a, cudaStream_t s) {
  if (a.Sq > 0) {
    dq_fma<NI><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv <= 0) return cudaSuccess;
  dkv_fma<NI><<<key_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_fwd(const Args& a, int dtype, cudaStream_t s) {
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

cudaError_t run_bwd(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    switch (a.D) {
      case 16: return bwd_mma<16>(a, s);
      case 32: return bwd_mma<32>(a, s);
      case 64: return bwd_mma<64>(a, s);
      case 128: return bwd_mma<128>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (a.D) {
    case 16:
    case 32: return bwd_f<1>(a, s);
    case 64: return bwd_f<2>(a, s);
    case 128: return bwd_f<4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it). lse [B, H, Sq].
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, void* out, void* lse, int B, int Sq, int Skv, int H,
    int KV, int D, int causal, float scale, int dtype, void* stream) {
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
  return static_cast<int>(run_fwd(a, dtype, static_cast<cudaStream_t>(stream)));
}

// dq, dk, dv are written whole (every element, zeros where no q row sees a
// key); delta = rowsum(dout * out) [B, H, Sq] f32, computed by the caller.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qseg, const void* kseg,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
    int D, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || (Sq <= 0 && Skv <= 0)) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KV = KV; a.D = D;
  a.causal = causal;
  a.scale = scale;
  return static_cast<int>(run_bwd(a, dtype, static_cast<cudaStream_t>(stream)));
}
