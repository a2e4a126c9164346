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
// Per-sequence frontiers (varlen packs, the JAX flash_attn_varlen's
// per-sequence bottom-right mask, ops/attention.py:149-166): two optional
// int32 pair arrays replace the rule above. qrange [B, Sq] holds each q
// row's visible keys as (first, last) packed key, krange [B, Skv] each
// key's (first, last) q row that sees it; first > last: none. In a pack the
// pairs one row sees, and the rows one key is seen by, are contiguous, so
// one range test is the whole mask (causal and segment ids are not read
// with them). Every body takes them: the row-major ones (forward, dq) read
// qrange, the key-major ones (dk/dv) krange, and each CTA's loop runs over
// the union of its rows' (keys') ranges only, so a pack skips the key
// tiles of other sequences. Null pointers keep the rule. The Hopper
// bodies' instances for them run on a 1-D grid in index order, the heads
// of a block adjacent, and K2's dq and dk/dv CTAs are one launch
// (bwd_wgmma), the dk/dv ones after the dq ones.
//
// Attention dropout (the JAX _sdpa_raw's, after the softmax; entries
// flash_attention_fwd_dropout_launch and _bwd_dropout_launch): the
// bodies built with kDrop multiply each probability by M / (1 - p) in f32,
// at the (row, key) the mask already computes, before its bf16 round;
// l and lse stay over the undropped P; K2 scales dP = dO V^T by the same
// factor and dv takes the dropped P (delta = rowsum(dO o O) is unchanged).
// M is Philox4x32-10 keyed by the call's seed over (batch row, query head,
// query row, key column / 8) (philox.cuh): each 16-bit half of the hash's
// four words decides one key, so one hash decides eight keys of a row and
// every body makes one hash per 8 elements it masks. The lanes that hold a
// hash's keys share it: a lane quad in the row-major bodies (lane tig holds
// keys 2 tig, 2 tig + 1 of each 8-key block, word tig of its hash: the
// quad's four lanes hash rows A and B of two blocks and trade the keep
// bytes, drop_rows), the 8 lanes of a tig in dk/dv's S^T (key jA is
// position grp of its block: drop_keys), one warp in the fp32 bodies, so
// every body masks the same elements; the Hopper dk/dv body hashes while
// its S^T and dP^T products run on the tensor cores. Nothing is stored
// between K1 and K2: each recomputes the mask from (seed, b, h, r, c).
// Built for every body: the Hopper ones (K1 at its default tiles), the
// bf16 mma.sync ones (D = 16, 32) and the fp32 ones.
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
//       padded to 64, one read of O, dO and lse (the Hopper and fp32
//       bodies' backward).
//     dq: one CTA per 128 q rows; Q and dO resident, 64 keys of K and V a
//       stage; S = Q K^T, dP = dO V^T, dS = P (dP - delta), dq += dS K.
//     At the frontier arrays dq and dk/dv are one launch (bwd_wgmma): the
//       dq CTAs, then the dk/dv CTAs.
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
//   bf16, D = 16 and 32: mma.sync m16n8k16 bodies (wgmma's 64-column
//     swizzled panels do not fit these widths), 4 warps of 16 rows (or
//     keys), rows streamed through a cp.async ring, B fragments by
//     ldmatrix, masks on cut tiles only, exp2; K2 is one launch of dq and
//     dk/dv CTAs that compute delta themselves (no pre-pass). The design
//     is at the bodies below. A bf16 call with no q row or no key at D =
//     64 and 128 (a tensor map needs every dimension > 0) has no pair:
//     no_pairs writes its zeros and lse.
//   fp32: one warp per 4 rows (forward, dq) or 4 keys (dk/dv; 8, one
//     Philox group, with dropout), each lane owning head-dim elements
//     d = lane + 32 n; dot products by warp shuffles. Right first; the
//     fp32 path is not the training path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
  void* out;             // forward: written; backward: read (delta)
  float* lse;            // forward
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KV, D, causal;
  int Sp;                // delta rows, padded: [B, H, Sp]
  float scale;
  // attention dropout (the bodies built with kDrop): the Philox key (the
  // call's seed), the keep test's bound round(p 2^16) on a 16-bit half and
  // 1 / (1 - p); philox.cuh gives the counter layout
  uint32_t seed0, seed1, threshold;
  float keep_scale;
  // the first head's global index: a tensor-parallel rank holding heads
  // h0 .. h0 + H - 1 of the model hashes h0 + h, so its mask is its slice
  // of the degree-1 mask (0 at degree 1)
  int h0;
  // per-sequence frontiers (null: the causal / segment rule): qrange[b, r]
  // = (first, last) key row r sees, krange[b, j] = (first, last) q row
  // that sees key j; first > last: none
  const int2* qrange;
  const int2* krange;
};

// the keep bits of keys 8 g .. 8 g + 7 of (b, h, row): bit i keeps 8 g + i
__device__ __forceinline__ uint32_t drop_byte(const Args& a, int b, int h,
                                              int row, int g) {
  return philox::keep_byte(a.seed0, a.seed1, b, a.h0 + h, row, g,
                           a.threshold);
}

// The keep bits of a thread's elements of two 8-key column blocks g, g + 1
// of an mma/wgmma row-major accumulator (rows rA, rB = rA + 8; keys
// 8 (g + d) + 2 tig + e): bit row_bit(i) keeps accumulator element i =
// 4 d + 2 hi + e of the pair (row hi ? rB : rA). The four (row, block)
// pairs are a hash each, and lane tig of the quad needs word tig of every
// one: lane tig hashes (row tig & 1 ? rB : rA, block g + (tig >> 1)), the
// quad gathers the four keep bytes (byte 2 d + hi), and each lane keeps
// bits 2 tig, 2 tig + 1 of each byte.
__device__ __forceinline__ uint32_t drop_rows(const Args& a, int b, int h,
                                              int rA, int rB, int g,
                                              int tig) {
  uint32_t v = drop_byte(a, b, h, (tig & 1) ? rB : rA, g + (tig >> 1))
               << (8 * tig);
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return v >> (2 * tig);
}

// drop_rows' bit of element i = 4 d + 2 hi + e
__host__ __device__ constexpr int row_bit(int i) {
  return 16 * (i >> 2) + 8 * ((i >> 1) & 1) + (i & 1);
}

// The keep bits of a thread's S^T accumulator elements (rows keys jA and
// jB = jA + 8, columns q rows q0 + 8 jj + 2 tig + e, NQ q rows): bit
// key_bit<NQ>(i) keeps element i = 4 jj + 2 hi + e (key hi ? jB : jA).
// Key jA is position grp of its 8-key block g = jA >> 3 (warp-uniform), so
// the 8 lanes grp = 0..7 of a tig need the same NQ / 2 hashes (a q row and
// block each), each lane its own position's bit of every one. Lane grp
// hashes NQ / 16 of them, one keep byte each (bit p: position p), and the
// lanes xor 4, 8, 16 apart transpose the 8 x 8 matrix of (lane, position)
// bit groups in three butterfly rounds: after round k, bit k of a group's
// lane and of its position have swapped.
template <int NQ>
__device__ __forceinline__ uint32_t drop_keys(const Args& a, int b, int h,
                                              int q0, int g, int grp,
                                              int tig) {
  constexpr int J = NQ / 8, C = J / 2;  // jj values; (hi, e) a lane
  static_assert(J == 4 || J == 8, "drop_keys: 32 or 64 q rows");
  // lane grp: jj = grp % J and the pairs c = 2 hi + e = C (grp / J) + cc
  uint32_t x = 0u;
#pragma unroll
  for (int cc = 0; cc < C; ++cc) {
    const int c = C * (grp / J) + cc;
    x |= drop_byte(a, b, h, q0 + 8 * (grp % J) + 2 * tig + (c & 1),
                   g + (c >> 1))
         << (8 * cc);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // positions with bit k clear; a lane with bit k of grp set keeps the
    // others, and each lane sends its partner the bits it does not keep,
    // moved to the positions they take there
    const uint32_t clear = k == 0 ? 0x55555555u
                                  : (k == 1 ? 0x33333333u : 0x0F0F0F0Fu);
    const bool up = (grp >> k) & 1;
    const uint32_t mine = up ? ~clear : clear;
    const uint32_t send = (up ? x << (1 << k) : x >> (1 << k)) & mine;
    x = (x & mine) | __shfl_xor_sync(0xffffffffu, send, 4 << k);
  }
  return x;
}

// drop_keys<NQ>'s bit of element i = 4 jj + 2 hi + e: byte c % C of the
// lane that hashed it, at position jj + J (c / C), c = 2 hi + e
template <int NQ>
__host__ __device__ constexpr int key_bit(int i) {
  return 8 * ((i & 3) % (NQ / 16)) + (i >> 2) +
         (NQ / 8) * ((i & 3) / (NQ / 16));
}

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

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A span [x, y] of keys (or q rows); x > y is empty, and kNone the empty
// one the helpers return.
__device__ __forceinline__ int2 kNone() { return make_int2(0, -1); }

__device__ __forceinline__ bool has(int2 s) { return s.x <= s.y; }

// the keys row r attends, before segment ids: qrange's entry, or keys <=
// r + Skv - Sq causal (the bottom-right rule), every key otherwise; rows
// past Sq see none
__device__ __forceinline__ int2 row_span(const Args& a, int b, int r) {
  if (r >= a.Sq) return kNone();
  if (a.qrange) {
    const int2 s = a.qrange[size_t(b) * a.Sq + r];
    return make_int2(max(s.x, 0), min(s.y, a.Skv - 1));
  }
  return make_int2(0, a.causal ? min(a.Skv - a.Sq + r, a.Skv - 1)
                               : a.Skv - 1);
}

// the q rows that attend key j, before segment ids (row_span's inverse)
__device__ __forceinline__ int2 key_span(const Args& a, int b, int j) {
  if (j >= a.Skv) return kNone();
  if (a.krange) {
    const int2 s = a.krange[size_t(b) * a.Skv + j];
    return make_int2(max(s.x, 0), min(s.y, a.Sq - 1));
  }
  return make_int2(a.causal ? max(0, j - (a.Skv - a.Sq)) : 0, a.Sq - 1);
}

// the union of two spans, empty ones ignored
__device__ __forceinline__ int2 join(int2 s, int2 t) {
  if (!has(t)) return s;
  if (!has(s)) return t;
  return make_int2(min(s.x, t.x), max(s.y, t.y));
}

// the union of a warp's spans (kNone when all are empty)
__device__ __forceinline__ int2 warp_join(int2 s) {
  const int lo = warp_min(has(s) ? s.x : 0x7fffffff);
  const int hi = warp_max(has(s) ? s.y : -1);
  return lo <= hi ? make_int2(lo, hi) : kNone();
}

// The union of the spans of rows [s0, s0 + n) (kKeys false: the keys they
// attend, row_span) or of keys [s0, s0 + n) (kKeys true: the q rows that
// see them, key_span). Without the frontier arrays it has a closed form;
// with them the block reduces its entries, so every thread of the block
// must call it (it synchronises the block twice).
template <bool kKeys>
__device__ int2 block_span(const Args& a, int b, int s0, int n) {
  if (!(kKeys ? a.krange : a.qrange)) {
    if (kKeys)
      return s0 < a.Skv ? make_int2(key_span(a, b, s0).x, a.Sq - 1) : kNone();
    return make_int2(0, row_span(a, b, min(s0 + n, a.Sq) - 1).y);
  }
  __shared__ int red[2];
  if (threadIdx.x == 0) {
    red[0] = 0x7fffffff;
    red[1] = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int2 s = kKeys ? key_span(a, b, s0 + i) : row_span(a, b, s0 + i);
    if (has(s)) {
      atomicMin(red, s.x);
      atomicMax(red + 1, s.y);
    }
  }
  __syncthreads();
  return red[0] <= red[1] ? make_int2(red[0], red[1]) : kNone();
}

__device__ __forceinline__ int2 rows_span(const Args& a, int b, int r0,
                                          int n) {
  return block_span<false>(a, b, r0, n);
}

__device__ __forceinline__ int2 keys_span(const Args& a, int b, int j0,
                                          int n) {
  return block_span<true>(a, b, j0, n);
}

// the first of a loop's steps of `step` keys (or rows) over span s
__device__ __forceinline__ int first_step(int2 s, int step) {
  return has(s) ? s.x / step * step : 0;
}

// does span s hold the whole step [k0, k0 + n)? (else it needs a mask)
__device__ __forceinline__ bool covers(int2 s, int k0, int n) {
  return s.x <= k0 && k0 + n - 1 <= s.y;
}

__device__ __forceinline__ size_t q_off(const Args& a, int b, int r, int h) {
  return ((size_t(b) * a.Sq + r) * a.H + h) * size_t(a.D);
}

__device__ __forceinline__ size_t k_off(const Args& a, int b, int j, int kv) {
  return ((size_t(b) * a.Skv + j) * a.KV + kv) * size_t(a.D);
}

// ---------------------------------------------------------------------------
// FMA bodies (fp32). kTR rows (or keys; fma_keys for dk/dv) per warp,
// kKB keys per step.
// ---------------------------------------------------------------------------
constexpr int kTR = 4;
constexpr int kKB = 8;

// keys a warp of dk/dv: with dropout one 8-key Philox group, so that one
// hash serves the warp's keys of a q row
__host__ __device__ constexpr int fma_keys(bool drop) {
  return drop ? 8 : kTR;
}

template <int NI, bool kDrop>
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
  int2 sp[kTR];
  int qs[kTR];
  int2 wsp = kNone();  // the warp's keys
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    sp[i] = row_span(a, b, r);
    wsp = join(wsp, sp[i]);
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
  for (int k0 = first_step(wsp, kKB); k0 <= wsp.y; k0 += kKB) {
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
      // warp-uniform: the row sees none of these keys
      if (sp[i].y < k0 || sp[i].x > k0 + kKB - 1) continue;
      float s[kKB];
      bool keep[kKB];
      float mx = m[i];
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) part += qr[i][n] * kf[kk][n];
        const float dot = warp_sum(part);
        keep[kk] = k0 + kk >= sp[i].x && k0 + kk <= sp[i].y &&
                   (!a.qseg || qs[i] == ks[kk]);
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
      l[i] = l[i] * corr + psum;  // over the undropped probabilities
      if constexpr (kDrop) {
        // keys k0 .. k0 + 7 are one 8-key Philox group (k0 % 8 == 0)
        const uint32_t bits = drop_byte(a, b, h, r0 + i, k0 >> 3);
#pragma unroll
        for (int kk = 0; kk < kKB; ++kk)
          s[kk] *= ((bits >> kk) & 1u) ? a.keep_scale : 0.f;
      }
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

template <int NI, bool kDrop>
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
  int2 sp[kTR];
  int qs[kTR];
  int2 wsp = kNone();  // the warp's keys
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + i;
    const bool live = r < a.Sq;
    sp[i] = row_span(a, b, r);
    wsp = join(wsp, sp[i]);
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
  for (int k0 = first_step(wsp, kKB); k0 <= wsp.y; k0 += kKB) {
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
      if (sp[i].y < k0 || sp[i].x > k0 + kKB - 1) continue;  // warp-uniform
      uint32_t bits = 0xFFu;
      if constexpr (kDrop) bits = drop_byte(a, b, h, r0 + i, k0 >> 3);
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          ps += qr[i][n] * kf[kk][n];
          pd += dr[i][n] * vf[kk][n];
        }
        const bool keep = k0 + kk >= sp[i].x && k0 + kk <= sp[i].y &&
                          (!a.qseg || qs[i] == ks[kk]);
        const float s = warp_sum(ps) * a.scale;
        float dp = warp_sum(pd);
        if constexpr (kDrop) dp *= ((bits >> kk) & 1u) ? a.keep_scale : 0.f;
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

template <int NI, bool kDrop>
__global__ void __launch_bounds__(kThreads) dkv_fma(Args a) {
  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  float* __restrict__ dk = static_cast<float*>(a.dk);
  float* __restrict__ dv = static_cast<float*>(a.dv);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int KR = fma_keys(kDrop);
  const int j0 = (blockIdx.x * kWarps + warp) * KR;
  if (j0 >= a.Skv) return;
  const int G = a.H / a.KV;

  float kr[KR][NI], vr[KR][NI], ak[KR][NI], av[KR][NI];
  int ks[KR];
  int2 sp[KR];
  int2 wsp = kNone();  // the q rows that see the warp's keys
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int j = j0 + i;
    const bool ok = j < a.Skv;
    sp[i] = key_span(a, b, j);
    wsp = join(wsp, sp[i]);
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
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int r = wsp.x; r <= wsp.y; ++r) {
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
      // with dropout keys j0 .. j0 + 7 are one Philox group (j0 % 8 == 0)
      const uint32_t bits = kDrop ? drop_byte(a, b, h, r, j0 >> 3) : 0xFu;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        if (r < sp[i].x || r > sp[i].y) continue;  // warp-uniform
        if (a.qseg && qs != ks[i]) continue;
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          ps += qf[n] * kr[i][n];
          pd += df[n] * vr[i][n];
        }
        const float s = warp_sum(ps) * a.scale;
        float dp = warp_sum(pd);
        const float p = expf(s - lse);
        // dropout: dv takes the dropped, scaled P; dP = dO V^T is scaled
        // the same way before dS = P (dP - delta)
        const float z =
            ((bits >> i) & 1u) ? (kDrop ? a.keep_scale : 1.f) : 0.f;
        dp *= z;
        const float ds = p * (dp - dl);
        const float pz = p * z;
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          av[i][n] += pz * df[n];
          ak[i][n] += ds * qf[n];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) {
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
// bf16 tensor-core bodies at D = 16 and 32: mma.sync m16n8k16, bf16 in, f32
// accumulate. Fragment layout (lane = 4 * grp + tig): A rows grp and grp + 8,
// columns 2 tig, 2 tig + 1 (+ 8); B column grp, rows 2 tig, 2 tig + 1 (+ 8);
// C rows grp and grp + 8, columns 2 tig, 2 tig + 1. An accumulator over N
// keys (or q rows) is a flat float[N / 2] whose element 4 j + 2 hi + e is
// row hi ? grp + 8 : grp, column 8 j + 2 tig + e: a wgmma accumulator's
// layout within its warp, so drop_rows, drop_keys, hopper::to_a and
// hopper::store_rows serve both.
//
// wgmma's 64-column panels do not fit these widths, and at them the tensor
// cores are not the limit: a step's range tests, exp2 and Philox hashes
// outnumber its mma instructions many times over, so what costs time is
// the serial chain of steps and the instructions in each. Hence:
//   - K and V (forward, dq) or Q, dO and O rows (dk/dv) stream through a
//     ring of shared-memory stages filled by 16-byte cp.async ahead of the
//     step that reads them (rows past the end zero-filled), with one block
//     barrier a step. Rows are D + 8 bf16 apart, so the 8 rows an ldmatrix
//     reads fall in distinct banks.
//   - Every B fragment comes from ldmatrix, transposed where the
//     contraction runs along the tile's rows (V in the forward, K in dq, Q
//     and dO in dk/dv); Q, dO (forward, dq) and K, V (dk/dv) are resident A
//     fragments.
//   - The mask runs only on a step that a row's span (a key's), the
//     row or key count, or segment ids cut: `covers` of the span every row
//     of the warp sees; masked scores are -inf. A step no row of the warp
//     sees is skipped.
//   - Scores go to base 2 in one FFMA (scale log2(e) folded in); lse stays
//     natural at the interface.
//   - Under causal the heaviest q blocks (the last rows) launch first, in
//     the forward and in dq.
//   - The tiles are measured (PERF.md): 16 q rows (keys) a warp
//     and 64-key stages in the forward beat 32 rows a warp (two m16 groups
//     sharing every K and V fragment) with 128-key stages, whose 202 / 254
//     registers (without / with dropout) left 2 CTAs an SM; dq takes 64
//     keys a stage and dk/dv 64 q rows (32 of either, or 32 dq rows a
//     warp, ran slower).
// Each body reads the frontier arrays or the rule at run time (row_span,
// key_span), so one instance serves both.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2^x in one MUFU op (results below 2^-126 flush to 0, as no P that
// small changes a bf16 product or an f32 row sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the f32 dot product of two bf16 pairs
__device__ __forceinline__ float dot2(uint32_t x, uint32_t y) {
  const float2 u = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  const float2 w = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&y));
  return fmaf(u.y, w.y, u.x * w.x);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ldmatrix of four 8 x 8 bf16 matrices: lane l gives the address of row
// l % 8 of matrix l / 8 and receives in r[i] matrix i's row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 (kTrans: its column l / 4, rows 2 (l % 4)
// and 2 (l % 4) + 1)
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = hopper::smem_u32(p);
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// The B fragments of two n8 tiles over one k16 step of a shared tile with
// row stride LD, at `t` (the tiles' first n and k): r[0], r[1] are the first
// n-tile's b0, b1, r[2], r[3] the second's. ldb_nk reads a tile whose rows
// are n and whose columns are k (K for S = Q K^T, Q and dO for S^T = K Q^T),
// ldb_kn one whose rows are k (V for O = P V, K for dq, Q and dO for dk/dv),
// transposed.
template <int LD>
__device__ __forceinline__ void ldb_nk(uint32_t (&r)[4], const bf16* t,
                                       int lane) {
  ldsm4<false>(r, t + ((lane & 7) + ((lane >> 4) << 3)) * LD + (lane & 8));
}

template <int LD>
__device__ __forceinline__ void ldb_kn(uint32_t (&r)[4], const bf16* t,
                                       int lane) {
  ldsm4<true>(r, t + ((lane & 7) + (lane & 8)) * LD + ((lane >> 4) << 3));
}

// cp.async of 16 (4) bytes from global to shared memory; !ok zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async rows [r0, r0 + ROWS) of a [B, S, heads, D] bf16 tensor (head
// hh) into a shared tile of row stride D + 8; rows past S are zero
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int b,
                                           int r0, int S, int heads,
                                           int hh) {
  constexpr int VPR = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * VPR % kThreads == 0, "stage_rows: whole passes");
#pragma unroll
  for (int i = 0; i < ROWS * VPR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / VPR, col = c % VPR * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * (D + 8) + col,
               ok ? src + ((size_t(b) * S + r0 + r) * heads + hh) * D + col
                  : src,
               ok);
  }
}

// the span every row (key) of the warp sees, from each lane's `cov`, and
// the union of the warp's spans, from each lane's `any`
__device__ __forceinline__ void warp_spans(int2& cov, int2& any) {
  cov = make_int2(warp_max(cov.x), warp_min(cov.y));
  any = warp_join(any);
}

__device__ __forceinline__ int2 meet(int2 s, int2 t) {
  return make_int2(max(s.x, t.x), min(s.y, t.y));
}

constexpr int cmax(int x, int y) { return x > y ? x : y; }

// K1: one CTA per (kFwdRows q rows, head, batch row), 16 rows a warp;
// kFwdBN keys of K and V a stage in a ring of kFwdRing, one online-softmax
// step a stage.
constexpr int kFwdRows = 16 * kWarps;
constexpr int kFwdBN = 64;
constexpr int kFwdRing = 3;

template <int D>
constexpr int fwd_mma_smem() {
  return kFwdRing * 2 * kFwdBN * (D + 8) * 2;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads) fwd_mma(Args a) {
  constexpr int BN = kFwdBN, R = kFwdRing, KT = D / 16, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage: K, then V rows
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  const int h = blockIdx.y, b = blockIdx.z;
  const int qb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * kFwdRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int kvh = h / (a.H / a.KV);
  const bool seg = a.qseg != nullptr;
  const int rA = q0 + 16 * warp + grp, rB = rA + 8;
  const int2 spA = row_span(a, b, rA), spB = row_span(a, b, rB);
  const int sA = (seg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
  const int sB = (seg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
  int2 cov = meet(spA, spB), any = join(spA, spB);
  warp_spans(cov, any);
  const int2 bsp = rows_span(a, b, q0, kFwdRows);  // the block's keys
  const int kbeg = first_step(bsp, BN);
  const int steps = has(bsp) ? (bsp.y - kbeg) / BN + 1 : 0;
  auto issue = [&](int t) {
    bf16* ks = ring + (t % R) * 2 * BN * LD;
    stage_rows<D, BN>(ks, k, b, kbeg + t * BN, a.Skv, a.KV, kvh);
    stage_rows<D, BN>(ks + BN * LD, v, b, kbeg + t * BN, a.Skv, a.KV, kvh);
  };
#pragma unroll
  for (int t = 0; t < R - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }

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
  float o[D / 2];
  hopper::zero(o);
  float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;
  const float sl2 = a.scale * kLog2e;  // scores in base 2

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<R - 2>();
    // stage t is in, and every warp is past step t - 1, whose slot the
    // next copy refills
    __syncthreads();
    if (t + R - 1 < steps) issue(t + R - 1);
    cp_async_commit();
    const int k0 = kbeg + t * BN;
    if (any.y < k0 || any.x > k0 + BN - 1) continue;  // warp-uniform
    const bf16* ks = ring + (t % R) * 2 * BN * LD;
    const bf16* vs = ks + BN * LD;
    float sc[BN / 2];
    hopper::zero(sc);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t f[4];
        ldb_nk<LD>(f, ks + 16 * j * LD + 16 * kk, lane);
        mma_bf16(sc + 8 * j, qa[kk], f[0], f[1]);
        mma_bf16(sc + 8 * j + 4, qa[kk], f[2], f[3]);
      }
    if (seg || !covers(cov, k0, BN)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int2 s = (i & 2) ? spB : spA;
        bool keep = key >= s.x && key <= s.y;
        if (seg && keep)
          keep = a.kseg[size_t(b) * a.Skv + key] == ((i & 2) ? sB : sA);
        if (!keep) sc[i] = hopper::neg_inf();
      }
    }
    float bA = hopper::neg_inf(), bB = hopper::neg_inf();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      bA = fmaxf(bA, fmaxf(sc[4 * j], sc[4 * j + 1]));
      bB = fmaxf(bB, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float nA = fmaxf(mA, quad_max(bA) * sl2);
    const float nB = fmaxf(mB, quad_max(bB) * sl2);
    const float cA = ex2(mA - nA), cB = ex2(mB - nB);
    float pA = 0.f, pB = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], sl2, -nA));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], sl2, -nA));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], sl2, -nB));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], sl2, -nB));
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
    if constexpr (kDrop) {
      // l summed the undropped P; O takes P M / (1 - p), in f32 before the
      // bf16 round; one hash a lane for each pair of 8-key blocks
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t bits = drop_rows(a, b, h, rA, rB, (k0 >> 3) + j, tig);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sc[4 * j + i] *= ((bits >> row_bit(i)) & 1u) ? a.keep_scale : 0.f;
      }
    }
    // O += P V
#pragma unroll
    for (int u = 0; u < BN / 16; ++u) {
      uint32_t pa[4];
      hopper::to_a(pa, sc, u);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t f[4];
        ldb_kn<LD>(f, vs + 16 * u * LD + 16 * n, lane);
        mma_bf16(o + 8 * n, pa, f[0], f[1]);
        mma_bf16(o + 8 * n + 4, pa, f[2], f[3]);
      }
    }
  }

  lA = fmaxf(quad_sum(lA), 1e-30f);
  lB = fmaxf(quad_sum(lB), 1e-30f);
  hopper::store_rows<D>(static_cast<bf16*>(a.out), o, oA, rA < a.Sq,
                        1.f / lA, oB, rB < a.Sq, 1.f / lB, tig);
  if (tig == 0) {
    // natural-log lse; a row that saw no key keeps m = kNeg
    const size_t st = (size_t(b) * a.H + h) * a.Sq;
    if (rA < a.Sq) a.lse[st + rA] = mA == kNeg ? kNeg : mA * kLn2 + logf(lA);
    if (rB < a.Sq) a.lse[st + rB] = mB == kNeg ? kNeg : mB * kLn2 + logf(lB);
  }
}

// K2 in one launch. The grid holds the dk/dv CTAs (the first keys, which
// the most q rows see, first) and then the dq CTAs (under causal the last
// rows first); `parts` selects the roles, and a CTA computes the same bits
// whatever else its grid holds. There is no pre-pass: each CTA computes
// delta = rowsum(dO o O) (D multiply-adds a row) and lse log2(e) for the q
// rows it reads, dq for its resident rows and dk/dv for each stage's rows
// one stage ahead of the step that reads them, so a step keeps one barrier.
// Both roles recompute P = exp2(S scale log2(e) - lse log2(e)) (and the
// dropout mask), the price of determinism without atomics: every visible
// pair's exp2 and hash run twice. At D = 32 ([8, 2048, 8, 32], causal, on
// an H100) the dq CTAs, there only to make dq without atomics, take 0.121
// ms of the backward's 0.305 run alone (0.197 of 0.462 with dropout;
// PERF.md).
constexpr int kDqRows = 16 * kWarps;  // dq: q rows a CTA, 16 a warp
constexpr int kDqBN = 64;     // dq: keys a stage
constexpr int kDqRing = 3;
constexpr int kKvKeys = 16 * kWarps;  // dk/dv: keys a CTA, 16 a warp
constexpr int kKvBQ = 64;     // dk/dv: q rows a stage
constexpr int kKvRing = 4;

template <int D>
constexpr int dq_mma_smem() {
  return kDqRing * 2 * kDqBN * (D + 8) * 2;
}

// a dk/dv stage: Q, dO and O rows, then lse (log2(e) lse once delta is
// computed) and delta, f32
template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 3 * kKvBQ * (D + 8) * 2 + 2 * kKvBQ * 4;
}

template <int D>
constexpr int bwd_mma_smem() {
  return cmax(dq_mma_smem<D>(), kKvRing * dkv_stage_bytes<D>());
}

// dq of CTA x of the role: rows [q0, q0 + kDqRows) of head h, 16 a warp; Q
// and dO as resident A fragments, kDqBN keys of K and V a stage; S = Q K^T,
// dP = dO V^T, dS = P (dP - delta), dq += dS K
template <int D, bool kDrop>
__device__ __forceinline__ void dq_role(const Args& a, int x,
                                        unsigned char* smem) {
  constexpr int BN = kDqBN, R = kDqRing, KT = D / 16, LD = D + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage: K, then V rows
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(a.dout);
  const bf16* __restrict__ out = static_cast<const bf16*>(a.out);
  const int nqb = (a.Sq + kDqRows - 1) / kDqRows;
  const int rank = x / (a.H * a.B), h = x % a.H, b = x / a.H % a.B;
  const int q0 = (a.causal ? nqb - 1 - rank : rank) * kDqRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int kvh = h / (a.H / a.KV);
  const bool seg = a.qseg != nullptr;
  const int rA = q0 + 16 * warp + grp, rB = rA + 8;
  const bool wA = rA < a.Sq, wB = rB < a.Sq;
  const int2 spA = row_span(a, b, rA), spB = row_span(a, b, rB);
  const int sA = (seg && wA) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
  const int sB = (seg && wB) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
  int2 cov = meet(spA, spB), any = join(spA, spB);
  warp_spans(cov, any);
  const int2 bsp = rows_span(a, b, q0, kDqRows);
  const int kbeg = first_step(bsp, BN);
  const int steps = has(bsp) ? (bsp.y - kbeg) / BN + 1 : 0;
  auto issue = [&](int t) {
    bf16* ks = ring + (t % R) * 2 * BN * LD;
    stage_rows<D, BN>(ks, k, b, kbeg + t * BN, a.Skv, a.KV, kvh);
    stage_rows<D, BN>(ks + BN * LD, v, b, kbeg + t * BN, a.Skv, a.KV, kvh);
  };
#pragma unroll
  for (int t = 0; t < R - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }

  // Q and dO fragments, delta = rowsum(dO o O) (the quad's lanes hold a
  // row's columns between them) and lse in base 2; rows past Sq read 0
  const size_t oA = wA ? q_off(a, b, rA, h) : 0;
  const size_t oB = wB ? q_off(a, b, rB, h) : 0;
  uint32_t qa[KT][4], da[KT][4];
  float dA = 0.f, dB = 0.f;
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const int c = s * 16 + tig * 2;
    qa[s][0] = wA ? ld32(q + oA + c) : 0u;
    qa[s][1] = wB ? ld32(q + oB + c) : 0u;
    qa[s][2] = wA ? ld32(q + oA + c + 8) : 0u;
    qa[s][3] = wB ? ld32(q + oB + c + 8) : 0u;
    da[s][0] = wA ? ld32(dout + oA + c) : 0u;
    da[s][1] = wB ? ld32(dout + oB + c) : 0u;
    da[s][2] = wA ? ld32(dout + oA + c + 8) : 0u;
    da[s][3] = wB ? ld32(dout + oB + c + 8) : 0u;
    dA += dot2(da[s][0], wA ? ld32(out + oA + c) : 0u) +
          dot2(da[s][2], wA ? ld32(out + oA + c + 8) : 0u);
    dB += dot2(da[s][1], wB ? ld32(out + oB + c) : 0u) +
          dot2(da[s][3], wB ? ld32(out + oB + c + 8) : 0u);
  }
  dA = quad_sum(dA);
  dB = quad_sum(dB);
  const size_t st = (size_t(b) * a.H + h) * a.Sq;
  const float lA = wA ? a.lse_in[st + rA] * kLog2e : 0.f;
  const float lB = wB ? a.lse_in[st + rB] * kLog2e : 0.f;
  float acc[D / 2];
  hopper::zero(acc);
  const float sl2 = a.scale * kLog2e;

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<R - 2>();
    __syncthreads();  // as in the forward
    if (t + R - 1 < steps) issue(t + R - 1);
    cp_async_commit();
    const int k0 = kbeg + t * BN;
    if (any.y < k0 || any.x > k0 + BN - 1) continue;  // warp-uniform
    const bf16* ks = ring + (t % R) * 2 * BN * LD;
    const bf16* vs = ks + BN * LD;
    float sc[BN / 2], dp[BN / 2];
    hopper::zero(sc);
    hopper::zero(dp);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t f[4], g[4];
        ldb_nk<LD>(f, ks + 16 * j * LD + 16 * kk, lane);
        ldb_nk<LD>(g, vs + 16 * j * LD + 16 * kk, lane);
        mma_bf16(sc + 8 * j, qa[kk], f[0], f[1]);
        mma_bf16(sc + 8 * j + 4, qa[kk], f[2], f[3]);
        mma_bf16(dp + 8 * j, da[kk], g[0], g[1]);
        mma_bf16(dp + 8 * j + 4, da[kk], g[2], g[3]);
      }
    if (seg || !covers(cov, k0, BN)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int2 s = (i & 2) ? spB : spA;
        bool keep = key >= s.x && key <= s.y;
        if (seg && keep)
          keep = a.kseg[size_t(b) * a.Skv + key] == ((i & 2) ? sB : sA);
        if (!keep) sc[i] = hopper::neg_inf();
      }
    }
    // dropout: dP = (dO V^T) M / (1 - p), one hash a lane for each pair of
    // 8-key blocks
    if constexpr (kDrop) {
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t bits = drop_rows(a, b, h, rA, rB, (k0 >> 3) + j, tig);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dp[4 * j + i] *= ((bits >> row_bit(i)) & 1u) ? a.keep_scale : 0.f;
      }
    }
    // dS = P (dP - delta), P = exp2(S scale log2(e) - lse2), kept in sc
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float p = ex2(fmaf(sc[i], sl2, (i & 2) ? -lB : -lA));
      sc[i] = p * (dp[i] - ((i & 2) ? dB : dA));
    }
    // dq += dS K
#pragma unroll
    for (int u = 0; u < BN / 16; ++u) {
      uint32_t pa[4];
      hopper::to_a(pa, sc, u);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t f[4];
        ldb_kn<LD>(f, ks + 16 * u * LD + 16 * n, lane);
        mma_bf16(acc + 8 * n, pa, f[0], f[1]);
        mma_bf16(acc + 8 * n + 4, pa, f[2], f[3]);
      }
    }
  }
  hopper::store_rows<D>(static_cast<bf16*>(a.dq), acc, oA, wA, a.scale, oB,
                        wB, a.scale, tig);
}

// dk/dv of CTA x of the role: keys [j0, j0 + kKvKeys) of KV head kvh, 16 a
// warp, K and V as resident A fragments; kKvBQ q rows of Q, dO, O and lse a
// stage, for each query head of the GQA group from the first q block that
// sees the CTA's keys; S^T = K Q^T, dP^T = V dO^T, dv += P^T dO, dk +=
// dS^T Q
template <int D, bool kDrop>
__device__ __forceinline__ void dkv_role(const Args& a, int x,
                                         unsigned char* smem) {
  constexpr int BQ = kKvBQ, R = kKvRing;
  constexpr int KT = D / 16, LD = D + 8, SB = dkv_stage_bytes<D>();
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(a.dout);
  const bf16* __restrict__ out = static_cast<const bf16*>(a.out);
  const int rank = x / (a.KV * a.B), kvh = x % a.KV, b = x / a.KV % a.B;
  const int j0 = rank * kKvKeys;
  const int G = a.H / a.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int jA = j0 + 16 * warp + grp, jB = jA + 8;
  const bool seg = a.qseg != nullptr;
  const int2 ksA = key_span(a, b, jA), ksB = key_span(a, b, jB);
  const int gA = (seg && jA < a.Skv) ? a.kseg[size_t(b) * a.Skv + jA] : 0;
  const int gB = (seg && jB < a.Skv) ? a.kseg[size_t(b) * a.Skv + jB] : 0;
  int2 cov = meet(ksA, ksB), any = join(ksA, ksB);
  warp_spans(cov, any);
  const int2 bsp = keys_span(a, b, j0, kKvKeys);  // the block's q rows
  const int qfirst = first_step(bsp, BQ);
  const int nq = has(bsp) ? (bsp.y - qfirst) / BQ + 1 : 0;
  const int steps = G * nq;  // each head of the group, then its q blocks
  auto stage = [&](int t) { return smem + (t % R) * SB; };
  auto issue = [&](int t) {
    const int hh = kvh * G + t / nq, q0 = qfirst + t % nq * BQ;
    bf16* s = reinterpret_cast<bf16*>(stage(t));
    stage_rows<D, BQ>(s, q, b, q0, a.Sq, a.H, hh);
    stage_rows<D, BQ>(s + BQ * LD, dout, b, q0, a.Sq, a.H, hh);
    stage_rows<D, BQ>(s + 2 * BQ * LD, out, b, q0, a.Sq, a.H, hh);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      float* sl = reinterpret_cast<float*>(s + 3 * BQ * LD);
      cp_async4(sl + threadIdx.x,
                a.lse_in + (r < a.Sq ? (size_t(b) * a.H + hh) * a.Sq + r : 0),
                r < a.Sq);
    }
  };
  // stage t's delta = rowsum(dO o O) and its lse times log2(e) (in place),
  // TPR threads a row
  auto prep = [&](int t) {
    constexpr int TPR = kThreads / BQ, E = D / TPR;
    static_assert(kThreads % BQ == 0 && E % 4 == 0, "dk/dv delta pass");
    const bf16* s = reinterpret_cast<const bf16*>(stage(t));
    float* sl = reinterpret_cast<float*>(stage(t) + 3 * BQ * LD * 2);
    const int r = threadIdx.x / TPR, c = threadIdx.x % TPR * E;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const uint2 d =
          *reinterpret_cast<const uint2*>(s + (BQ + r) * LD + c + i);
      const uint2 o =
          *reinterpret_cast<const uint2*>(s + (2 * BQ + r) * LD + c + i);
      sum += dot2(d.x, o.x) + dot2(d.y, o.y);
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (threadIdx.x % TPR == 0) {
      sl[BQ + r] = sum;
      sl[r] *= kLog2e;
    }
  };
#pragma unroll
  for (int t = 0; t < R - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }

  uint32_t ka[KT][4], va[KT][4];
  {
    const size_t oA = jA < a.Skv ? k_off(a, b, jA, kvh) : 0;
    const size_t oB = jB < a.Skv ? k_off(a, b, jB, kvh) : 0;
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      const int c = s * 16 + tig * 2;
      ka[s][0] = jA < a.Skv ? ld32(k + oA + c) : 0u;
      ka[s][1] = jB < a.Skv ? ld32(k + oB + c) : 0u;
      ka[s][2] = jA < a.Skv ? ld32(k + oA + c + 8) : 0u;
      ka[s][3] = jB < a.Skv ? ld32(k + oB + c + 8) : 0u;
      va[s][0] = jA < a.Skv ? ld32(v + oA + c) : 0u;
      va[s][1] = jB < a.Skv ? ld32(v + oB + c) : 0u;
      va[s][2] = jA < a.Skv ? ld32(v + oA + c + 8) : 0u;
      va[s][3] = jB < a.Skv ? ld32(v + oB + c + 8) : 0u;
    }
  }
  float dk[D / 2], dv[D / 2];
  hopper::zero(dk);
  hopper::zero(dv);
  const float sl2 = a.scale * kLog2e;
  cp_async_wait<R - 2>();
  __syncthreads();  // stage 0 is in
  if (steps > 0) prep(0);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<R - 3>();
    // stages t and t + 1 are in, stage t's delta is written, and every
    // warp is past step t - 1, whose slot the next copy refills
    __syncthreads();
    if (t + R - 1 < steps) issue(t + R - 1);
    cp_async_commit();
    if (t + 1 < steps) prep(t + 1);
    const int hh = kvh * G + t / nq, q0 = qfirst + t % nq * BQ;
    if (any.y < q0 || any.x > q0 + BQ - 1) continue;  // warp-uniform
    const bf16* sq = reinterpret_cast<const bf16*>(stage(t));
    const bf16* sd = sq + BQ * LD;
    const float* sl = reinterpret_cast<const float*>(sq + 3 * BQ * LD);
    float st[BQ / 2], dpt[BQ / 2];
    hopper::zero(st);
    hopper::zero(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t f[4], g[4];
        ldb_nk<LD>(f, sq + 16 * j * LD + 16 * kk, lane);
        ldb_nk<LD>(g, sd + 16 * j * LD + 16 * kk, lane);
        mma_bf16(st + 8 * j, ka[kk], f[0], f[1]);
        mma_bf16(st + 8 * j + 4, ka[kk], f[2], f[3]);
        mma_bf16(dpt + 8 * j, va[kk], g[0], g[1]);
        mma_bf16(dpt + 8 * j + 4, va[kk], g[2], g[3]);
      }
    // dropout on S^T: bit key_bit<BQ>(i) of kbits is element i's
    uint32_t kbits = 0xFFFFFFFFu;
    if constexpr (kDrop)
      kbits = drop_keys<BQ>(a, b, hh, q0, jA >> 3, grp, tig);
    // rows keys jA, jB; columns q rows q0 + 8 j + 2 tig + e
    if (seg || !covers(cov, q0, BQ)) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = q0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int2 s = (i & 2) ? ksB : ksA;
        bool keep = r >= s.x && r <= s.y;
        if (seg && keep)
          keep = a.qseg[size_t(b) * a.Sq + r] == ((i & 2) ? gB : gA);
        if (!keep) st[i] = hopper::neg_inf();
      }
    }
    // P^T (dropout: P^T M / (1 - p), for dv) and dS^T = P^T (dP^T - delta)
    // (dropout: dP^T M / (1 - p))
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * tig + (i & 1);
      const float p = ex2(fmaf(st[i], sl2, -sl[c]));
      if constexpr (kDrop) {
        const float z = ((kbits >> key_bit<BQ>(i)) & 1u) ? a.keep_scale : 0.f;
        st[i] = p * z;
        dpt[i] = p * (dpt[i] * z - sl[BQ + c]);
      } else {
        st[i] = p;
        dpt[i] = p * (dpt[i] - sl[BQ + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < BQ / 16; ++u) {
      uint32_t pa[4], ds[4];
      hopper::to_a(pa, st, u);
      hopper::to_a(ds, dpt, u);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t f[4], g[4];
        ldb_kn<LD>(f, sd + 16 * u * LD + 16 * n, lane);
        ldb_kn<LD>(g, sq + 16 * u * LD + 16 * n, lane);
        mma_bf16(dv + 8 * n, pa, f[0], f[1]);
        mma_bf16(dv + 8 * n + 4, pa, f[2], f[3]);
        mma_bf16(dk + 8 * n, ds, g[0], g[1]);
        mma_bf16(dk + 8 * n + 4, ds, g[2], g[3]);
      }
    }
  }
  const size_t oA = jA < a.Skv ? k_off(a, b, jA, kvh) : 0;
  const size_t oB = jB < a.Skv ? k_off(a, b, jB, kvh) : 0;
  hopper::store_rows<D>(static_cast<bf16*>(a.dk), dk, oA, jA < a.Skv,
                        a.scale, oB, jB < a.Skv, a.scale, tig);
  hopper::store_rows<D>(static_cast<bf16*>(a.dv), dv, oA, jA < a.Skv, 1.f,
                        oB, jB < a.Skv, 1.f, tig);
}

// K2 on the mma bodies: CTAs [0, dkv_ctas) are dk/dv ones, the rest dq
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads) bwd_mma(Args a, int dkv_ctas) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (int(blockIdx.x) < dkv_ctas)
    dkv_role<D, kDrop>(a, blockIdx.x, smem);
  else
    dq_role<D, kDrop>(a, blockIdx.x - dkv_ctas, smem);
}

// A bf16 call at D = 64 or 128 with no q row or no key (the Hopper bodies'
// tensor maps need both) has no (row, key) pair: O and the gradients are 0
// and lse is -1e30, what every body gives a row that sees no key. `words`
// 32-bit words of x are zeroed, then `rows` lse entries set.
__global__ void __launch_bounds__(256) no_pairs(uint32_t* x, size_t words,
                                                float* lse, size_t rows) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < words + rows; i += size_t(gridDim.x) * blockDim.x) {
    if (i < words) x[i] = 0u;
    else lse[i - words] = kNeg;
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
constexpr int kPad = 64;  // lse2 / delta rows are padded to this

struct HopParams {
  CUtensorMap tq, tk, tv, tdo;  // bf16 row maps (128-byte swizzle)
  CUtensorMap tlse, tdelta;     // dk/dv: f32 [B * H, Sp] rows
  Args a;
  const float* lse2;            // dq: padded lse * log2(e)
  const float* delta2;          // dq: padded delta
};

// The Hopper bodies are built twice: for the rule (kRange false: causal,
// the key and row counts and segment ids, with the registers the rule
// needs) and for the frontier arrays (kRange true, the default tiles only).
// RowKeys<kRange> is a thread's mask in the row-major bodies (its rows rA,
// rB = rA + 8; the rule also keeps its warpgroup's first row r0, whose
// frontier decides which tiles need a mask), KeyRows<kRange> in the
// key-major dk/dv body (its keys jA, jB = jA + 8).

// last key row r may attend under the rule (-1: none); rows past Sq see
// nothing
__device__ __forceinline__ int frontier(const Args& a, int r) {
  if (r >= a.Sq) return -1;
  return a.causal ? min(a.Skv - a.Sq + r, a.Skv - 1) : a.Skv - 1;
}

template <bool kRange>
struct RowKeys;

template <>
struct RowKeys<false> {
  int fA, fB, f0;
  __device__ __forceinline__ RowKeys(const Args& a, int, int r0, int rA,
                                     int rB)
      : fA(frontier(a, rA)), fB(frontier(a, rB)), f0(frontier(a, r0)) {}
  // may a key of [k0, k0 + n) be past one of the thread's rows' frontier?
  __device__ __forceinline__ bool partial(int k0, int n) const {
    return k0 + n - 1 > f0;
  }
  __device__ __forceinline__ bool sees(bool hi, int key) const {
    return key <= (hi ? fB : fA);
  }
};

template <>
struct RowKeys<true> {
  int2 A, B;
  __device__ __forceinline__ RowKeys(const Args& a, int b, int, int rA,
                                     int rB)
      : A(row_span(a, b, rA)), B(row_span(a, b, rB)) {}
  __device__ __forceinline__ bool partial(int k0, int n) const {
    return !covers(make_int2(max(A.x, B.x), min(A.y, B.y)), k0, n);
  }
  __device__ __forceinline__ bool sees(bool hi, int key) const {
    const int2 s = hi ? B : A;
    return key >= s.x && key <= s.y;
  }
};

template <bool kRange>
struct KeyRows;

template <>
struct KeyRows<false> {
  int jA, jB, jmax;  // jmax: the warpgroup's last key
  __device__ __forceinline__ KeyRows(const Args&, int, int jA_, int jmax_)
      : jA(jA_), jB(jA_ + 8), jmax(jmax_) {}
  // may a row of [q0, q0 + n) not see one of the thread's keys?
  __device__ __forceinline__ bool partial(const Args& a, int q0,
                                          int n) const {
    return q0 + n > a.Sq || jmax >= a.Skv ||
           (a.causal && jmax > q0 + a.Skv - a.Sq);
  }
  __device__ __forceinline__ bool sees(const Args& a, bool hi, int r) const {
    const int j = hi ? jB : jA;
    return r < a.Sq && j < a.Skv && (!a.causal || j <= r + a.Skv - a.Sq);
  }
};

template <>
struct KeyRows<true> {
  int2 A, B;
  __device__ __forceinline__ KeyRows(const Args& a, int b, int jA, int)
      : A(key_span(a, b, jA)), B(key_span(a, b, jA + 8)) {}
  __device__ __forceinline__ bool partial(const Args&, int q0, int n) const {
    return !covers(make_int2(max(A.x, B.x), min(A.y, B.y)), q0, n);
  }
  __device__ __forceinline__ bool sees(const Args&, bool hi, int r) const {
    const int2 s = hi ? B : A;
    return r >= s.x && r <= s.y;
  }
};

// the keys (kRange: from a multiple of `step`) that rows [q0, q0 + n) see,
// as [begin, end)
template <bool kRange>
__device__ __forceinline__ int2 rows_steps(const Args& a, int b, int q0,
                                           int n, int step) {
  if constexpr (kRange) {
    const int2 s = rows_span(a, b, q0, n);
    return make_int2(first_step(s, step), s.y + 1);
  } else {
    return make_int2(0, frontier(a, min(q0 + n, a.Sq) - 1) + 1);
  }
}

// the q rows (from a multiple of `step`) that see keys [j0, j0 + n), as
// [begin, end)
template <bool kRange>
__device__ __forceinline__ int2 keys_steps(const Args& a, int b, int j0,
                                           int n, int step) {
  if constexpr (kRange) {
    const int2 s = keys_span(a, b, j0, n);
    return make_int2(first_step(s, step), s.y + 1);
  } else {
    return make_int2(a.causal ? max(0, j0 - (a.Skv - a.Sq)) / step * step : 0,
                     a.Sq);
  }
}

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

// The kRange launches run on a 1-D grid. CTA id c = head + heads (block +
// blocks b), blocks of `rows` rows (keys) out of S: cta_of gives (block,
// head, batch row). The heads of a block launch together, so a pack's
// sequences, whose blocks differ in work, reach the SMs one after another
// and no head's share of the heaviest blocks is left for the last wave
__device__ __forceinline__ int3 cta_of(int c, int heads, int S, int rows) {
  const int nb = (S + rows - 1) / rows;
  return make_int3(c / heads % nb, c % heads, c / heads / nb);
}

// a shared-memory descriptor `base` advanced by `off` (16-byte units),
// computed where it is used: the empty asm keeps the compiler from
// computing a whole wgmma batch's descriptors into registers ahead of it
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t off) {
  asm volatile("" : "+l"(base));
  return base + off;
}


template <int D, int W, int BN, bool kDrop, bool kRange>
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
  // the rule: the q blocks of one (head, batch row) launch together, so
  // the K and V they all stream stay in L2; causal: the heaviest (last
  // rows) first. The frontier arrays: a 1-D grid in index order
  const int3 cta = kRange ? cta_of(blockIdx.x, a.H, a.Sq, BM)
                          : make_int3(a.causal ? gridDim.x - 1 - blockIdx.x
                                               : blockIdx.x,
                                      blockIdx.y, blockIdx.z);
  const int qb = cta.x, h = cta.y, b = cta.z;
  const int q0 = qb * BM;
  const int kvh = h / (a.H / a.KV);
  // the keys the block's rows see, [kbeg, kend), kbeg a multiple of 64:
  // every tile runs the same 64-key softmax sub-steps (a step no row sees
  // changes nothing)
  const int2 ks_ = rows_steps<kRange>(a, b, q0, BM, SN);
  const int kbeg = ks_.x, kend = ks_.y;
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
      for (int k0 = kbeg; k0 < kend; k0 += BN, ring.next()) {
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
    const bool seg = a.qseg != nullptr;
    // the thread's rows' keys (none past Sq: every tile is then masked,
    // and nothing of it is stored)
    const RowKeys<kRange> mk(a, b, r0, rA, rB);
    const int sA = (seg && rA < a.Sq) ? a.qseg[size_t(b) * a.Sq + rA] : 0;
    const int sB = (seg && rB < a.Sq) ? a.qseg[size_t(b) * a.Sq + rB] : 0;
    const float sl2 = a.scale * kLog2e;  // scores in base 2
    float o[D / 2];
    zero(o);
    float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;
    hopper::mbar_wait(bars, 0);
    Ring ring;
    for (int k0 = kbeg; k0 < kend; k0 += BN, ring.next()) {
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
        // the mask only where a key outside a row's span (or a segment
        // boundary) can fall in the tile; masked scores become -inf, so
        // their probability is exactly 0 and m never drops below kNeg
        if (seg || mk.partial(kh, SN)) {
#pragma unroll
          for (int i = 0; i < SN / 2; ++i) {
            const int key = kh + 8 * (i >> 2) + 2 * tig + (i & 1);
            const bool hi = (i >> 1) & 1;
            bool keep = mk.sees(hi, key);
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
        if constexpr (kDrop) {
          // l summed the undropped P (as the JAX _sdpa_raw drops after the
          // softmax); O takes P M / (1 - p), in f32 before the bf16 round;
          // one hash a lane for each pair of 8-key blocks
#pragma unroll
          for (int j = 0; j < SN / 8; j += 2) {
            const uint32_t bits = drop_rows(a, b, h, rA, rB, (kh >> 3) + j,
                                            tig);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              sc[4 * j + i] *= ((bits >> row_bit(i)) & 1u) ? a.keep_scale
                                                           : 0.f;
          }
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

// the CTA of q block qb, head h, batch row b (dq_wgmma's, or bwd_wgmma's
// dq role)
template <int D, bool kDrop, bool kRange>
__device__ __forceinline__ void dq_cta(const HopParams& P, int qb, int h,
                                       int b) {
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
  const int q0 = qb * BM;
  const int kvh = h / (a.H / a.KV);
  // the keys the block's rows see, [kbeg, kend)
  const int2 ks_ = rows_steps<kRange>(a, b, q0, BM, BN);
  const int kbeg = ks_.x, kend = ks_.y;
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
      for (int k0 = kbeg; k0 < kend; k0 += BN, ring.next()) {
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
    const RowKeys<kRange> mk(a, b, r0, rA, rB);
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
    for (int k0 = kbeg; k0 < kend; k0 += BN, ring.next()) {
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
      if (seg || mk.partial(k0, BN)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const bool hi = (i >> 1) & 1;
          bool keep = mk.sees(hi, key);
          if (seg && keep)
            keep = a.kseg[size_t(b) * a.Skv + key] == (hi ? sB : sA);
          if (!keep) sc[i] = neg_inf();
        }
      }
      // dropout: dP = (dO V^T) M / (1 - p), one hash a lane for each pair
      // of 8-key blocks
      if constexpr (kDrop) {
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const uint32_t bits = drop_rows(a, b, h, rA, rB, (k0 >> 3) + j,
                                          tig);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dp[4 * j + i] *= ((bits >> row_bit(i)) & 1u) ? a.keep_scale
                                                         : 0.f;
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

// the rule's dq launch: q blocks as the forward's (causal: the heaviest,
// last rows, first)
template <int D, bool kDrop>
__global__ void __launch_bounds__(kHopThreads, 1)
    dq_wgmma(const __grid_constant__ HopParams P) {
  dq_cta<D, kDrop, false>(
      P, P.a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x, blockIdx.y,
      blockIdx.z);
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

// the CTA of key block jb, KV head kvh, batch row b (dkv_wgmma's, or
// bwd_wgmma's dk/dv role)
template <int D, bool kDrop, bool kRange>
__device__ __forceinline__ void dkv_cta(const HopParams& P, int jb, int kvh,
                                        int b) {
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
  const int j0 = jb * BN;
  const int G = a.H / a.KV;
  // the q rows that see the block's keys, [qfirst, qend)
  const int2 qs_ = keys_steps<kRange>(a, b, j0, BN, BQ);
  const int qfirst = qs_.x, qend = qs_.y;
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
        for (int q0 = qfirst; q0 < qend; q0 += BQ, ring.next()) {
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
    // the q rows that see the thread's keys (none past Skv)
    const KeyRows<kRange> mk(a, b, jA, j0 + k0 + 63);
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
    for (int q0 = qfirst; q0 < qend; q0 += BQ, ring.next()) {
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
      // dropout on S^T: bit key_bit<BQ>(i) of `kbits` is element i's
      // (drop_keys; jA >> 3 is the warp's first 8-key block), hashed while
      // the tensor cores run S^T and dP^T
      uint32_t kbits = 0xFFFFFFFFu;
      if constexpr (kDrop) {
        kbits = drop_keys<BQ>(a, b, kvh * G + g, q0, jA >> 3, grp, tig);
        asm volatile("" : "+r"(kbits));
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(st);
      hopper::fence_operand(dpt);
      // rows (keys) jA, jB; columns q rows q0 + 8 j + 2 tig + e. The mask
      // only where a tile holds rows outside the keys' spans (rows past Sq,
      // keys past Skv, pairs past the frontier) or segments, as -inf scores
      // (probability 0: lse2 is finite, pad rows' 0 included), in a loop of
      // its own: the per-element tests inside the exp loop cost more than
      // the tiles that need them
      if (seg || mk.partial(a, q0, BQ)) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int r = q0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const bool hi = (i >> 1) & 1;
          bool keep = mk.sees(a, hi, r);
          if (seg && keep)
            keep = a.qseg[size_t(b) * a.Sq + r] == (hi ? gB : gA);
          if (!keep) st[i] = neg_inf();
        }
      }
      // P^T (dropout: P^T M / (1 - p), for dv) and dS^T = P^T (dP^T - delta)
      // (dropout: dP^T M / (1 - p))
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * tig + (i & 1);
        const float p = exp2f(fmaf(st[i], sl2, -vl[c]));
        if constexpr (kDrop) {
          const float z = ((kbits >> key_bit<BQ>(i)) & 1u) ? a.keep_scale
                                                           : 0.f;
          st[i] = p * z;
          dpt[i] = p * (dpt[i] * z - vd[c]);
        } else {
          st[i] = p;
          dpt[i] = p * (dpt[i] - vd[c]);
        }
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

// the rule's dk/dv launch: the key blocks of one (KV head, batch row)
// launch together, so the Q and dO they all stream stay in L2; causal: the
// first keys see the most q rows, so they launch first
template <int D, bool kDrop>
__global__ void __launch_bounds__(kHopThreads, 1)
    dkv_wgmma(const __grid_constant__ HopParams P) {
  dkv_cta<D, kDrop, false>(P, blockIdx.x, blockIdx.y, blockIdx.z);
}

// K2 at the frontier arrays: the dq and the dk/dv CTAs in one launch on a
// 1-D grid, so the SMs idle in dq's last wave take dk/dv CTAs. Its first
// dq_ctas CTAs are dq CTAs (id head + H (q block + blocks b), cta_of over
// DqHop::BM rows); the rest are dk/dv CTAs (id kv head + KV (key block +
// blocks b) over DkvHop::BN keys). Each CTA runs its role's body as the
// separate launches would, so every element has the same bits with either
// role alone. The shared memory is the larger role's.
struct BwdHop {
  HopParams dq, dkv;  // each role's tensor maps (their boxes differ)
  int dq_ctas;
};

template <int D>
__host__ __device__ constexpr int bwd_smem() {
  return DqHop<D>::smem > DkvHop<D>::smem ? DqHop<D>::smem : DkvHop<D>::smem;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kHopThreads, 1)
    bwd_wgmma(const __grid_constant__ BwdHop P) {
  const Args& a = P.dq.a;
  if (int(blockIdx.x) < P.dq_ctas) {
    const int3 t = cta_of(blockIdx.x, a.H, a.Sq, DqHop<D>::BM);
    dq_cta<D, kDrop, true>(P.dq, t.x, t.y, t.z);
  } else {
    const int3 t = cta_of(int(blockIdx.x) - P.dq_ctas, a.KV, a.Skv,
                          DkvHop<D>::BN);
    dkv_cta<D, kDrop, true>(P.dkv, t.x, t.y, t.z);
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

// kRange: the frontier arrays' instance, on a 1-D grid
template <int D, int W, int BN, bool kDrop = false, bool kRange = false>
cudaError_t fwd_hop(const Args& a, cudaStream_t s) {
  using C = FwdHop<D, W, BN>;
  HopParams p{};
  p.a = a;
  if (!hopper_host::encode_rows(&p.tq, a.q, a.B, a.Sq, a.H, D, C::BM) ||
      !hopper_host::encode_rows(&p.tk, a.k, a.B, a.Skv, a.KV, D, C::BN) ||
      !hopper_host::encode_rows(&p.tv, a.v, a.B, a.Skv, a.KV, D, C::BN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_wgmma<D, W, BN, kDrop, kRange>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.Sq + C::BM - 1) / C::BM;
  dim3 grid(blocks, a.H, a.B);
  if constexpr (kRange) {
    static_assert(W == 2 && BN == 128,
                  "the frontier arrays' forward is the default tile's");
    grid = dim3(blocks * a.H * a.B);
  }
  fwd_wgmma<D, W, BN, kDrop, kRange><<<grid, C::kThreads, C::smem, s>>>(p);
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

// dq's and dk/dv's parameters: the tensor maps at each role's boxes
template <int D>
bool dq_params(const Args& a, const float* work, HopParams* p) {
  using C = DqHop<D>;
  p->a = a;
  p->lse2 = work;
  p->delta2 = work + size_t(a.B) * a.H * a.Sp;
  return hopper_host::encode_rows(&p->tq, a.q, a.B, a.Sq, a.H, D, C::BM) &&
         hopper_host::encode_rows(&p->tdo, a.dout, a.B, a.Sq, a.H, D, C::BM) &&
         hopper_host::encode_rows(&p->tk, a.k, a.B, a.Skv, a.KV, D, C::BN) &&
         hopper_host::encode_rows(&p->tv, a.v, a.B, a.Skv, a.KV, D, C::BN);
}

template <int D>
bool dkv_params(const Args& a, const float* work, HopParams* p) {
  using C = DkvHop<D>;
  p->a = a;
  const float* delta = work + size_t(a.B) * a.H * a.Sp;
  return hopper_host::encode_rows(&p->tq, a.q, a.B, a.Sq, a.H, D, C::BQ) &&
         hopper_host::encode_rows(&p->tdo, a.dout, a.B, a.Sq, a.H, D,
                                  C::BQ) &&
         hopper_host::encode_rows(&p->tk, a.k, a.B, a.Skv, a.KV, D, C::BN) &&
         hopper_host::encode_rows(&p->tv, a.v, a.B, a.Skv, a.KV, D, C::BN) &&
         hopper_host::encode_f32_rows(&p->tlse, work, a.B * a.H, a.Sp,
                                      C::BQ) &&
         hopper_host::encode_f32_rows(&p->tdelta, delta, a.B * a.H, a.Sp,
                                      C::BQ);
}

template <int D, bool kDrop>
cudaError_t dq_hop(const Args& a, const float* work, cudaStream_t s) {
  using C = DqHop<D>;
  HopParams p{};
  if (!dq_params<D>(a, work, &p)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dq_wgmma<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + C::BM - 1) / C::BM, a.H, a.B);
  dq_wgmma<D, kDrop><<<grid, kHopThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t dkv_hop(const Args& a, const float* work, cudaStream_t s) {
  using C = DkvHop<D>;
  HopParams p{};
  if (!dkv_params<D>(a, work, &p)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_wgmma<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Skv + C::BN - 1) / C::BN, a.KV, a.B);
  dkv_wgmma<D, kDrop><<<grid, kHopThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

// K2's `parts` DQ (2) and DKV (4) at the frontier arrays: one bwd_wgmma
// launch of the selected roles' CTAs
template <int D, bool kDrop>
cudaError_t bwd_hop_range(const Args& a, const float* work, int parts,
                          cudaStream_t s) {
  BwdHop p{};
  if (!dq_params<D>(a, work, &p.dq) || !dkv_params<D>(a, work, &p.dkv))
    return cudaErrorInvalidValue;
  p.dq_ctas = (parts & 2) ? (a.Sq + DqHop<D>::BM - 1) / DqHop<D>::BM *
                                a.H * a.B
                          : 0;
  const int ctas = p.dq_ctas + ((parts & 4) ? (a.Skv + DkvHop<D>::BN - 1) /
                                                  DkvHop<D>::BN * a.KV * a.B
                                            : 0);
  if (ctas == 0) return cudaSuccess;
  constexpr int smem = bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_wgmma<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bwd_wgmma<D, kDrop><<<ctas, kHopThreads, smem, s>>>(p);
  return cudaGetLastError();
}

dim3 row_grid(const Args& a, int rows_per_cta) {
  return dim3((a.Sq + rows_per_cta - 1) / rows_per_cta, a.H, a.B);
}

dim3 key_grid(const Args& a, int keys_per_cta) {
  return dim3((a.Skv + keys_per_cta - 1) / keys_per_cta, a.KV, a.B);
}


// the mma bodies (bf16, D = 16 and 32)
template <int D, bool kDrop>
cudaError_t fwd_mma_run(const Args& a, cudaStream_t s) {
  constexpr int bytes = fwd_mma_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fwd_mma<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  fwd_mma<D, kDrop><<<row_grid(a, kFwdRows), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// K2's roles in one launch: `parts` 2 the dq CTAs, 4 the dk/dv ones
template <int D, bool kDrop>
cudaError_t bwd_mma_run(const Args& a, int parts, cudaStream_t s) {
  const int dkv = (parts & 4) ? (a.Skv + kKvKeys - 1) / kKvKeys * a.KV * a.B
                              : 0;
  const int dq = (parts & 2) ? (a.Sq + kDqRows - 1) / kDqRows * a.H * a.B
                             : 0;
  if (dkv + dq == 0) return cudaSuccess;
  constexpr int bytes = bwd_mma_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_mma<D, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  bwd_mma<D, kDrop><<<dkv + dq, kThreads, bytes, s>>>(a, dkv);
  return cudaGetLastError();
}

cudaError_t fwd_mma_launch(const Args& a, bool drop, cudaStream_t s) {
  switch (a.D) {
    case 16: return drop ? fwd_mma_run<16, true>(a, s)
                         : fwd_mma_run<16, false>(a, s);
    case 32: return drop ? fwd_mma_run<32, true>(a, s)
                         : fwd_mma_run<32, false>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_mma_launch(const Args& a, bool drop, int parts,
                           cudaStream_t s) {
  switch (a.D) {
    case 16: return drop ? bwd_mma_run<16, true>(a, parts, s)
                         : bwd_mma_run<16, false>(a, parts, s);
    case 32: return drop ? bwd_mma_run<32, true>(a, parts, s)
                         : bwd_mma_run<32, false>(a, parts, s);
    default: return cudaErrorInvalidValue;
  }
}

// zero `elems` bf16 of x (an even count) and set `rows` lse entries to
// -1e30 (no_pairs)
cudaError_t fill_no_pairs(void* x, size_t elems, float* lse, size_t rows,
                          cudaStream_t s) {
  const size_t n = elems / 2 + rows;
  if (n == 0) return cudaSuccess;
  const size_t blocks = (n + 255) / 256;
  no_pairs<<<unsigned(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<uint32_t*>(x), elems / 2, lse, rows);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t bwd_hop(const Args& a, const float* work, int parts,
                    cudaStream_t s) {
  if (parts & 2) {
    cudaError_t e = dq_hop<D, kDrop>(a, work, s);
    if (e != cudaSuccess) return e;
  }
  return (parts & 4) ? dkv_hop<D, kDrop>(a, work, s) : cudaSuccess;
}

// the Hopper backward's instance: (D, dropout, frontier arrays)
template <int D>
cudaError_t bwd_hop_any(const Args& a, const float* work, int parts,
                        bool drop, cudaStream_t s) {
  if (a.qrange)
    return drop ? bwd_hop_range<D, true>(a, work, parts, s)
                : bwd_hop_range<D, false>(a, work, parts, s);
  return drop ? bwd_hop<D, true>(a, work, parts, s)
              : bwd_hop<D, false>(a, work, parts, s);
}

// the Hopper forward with the frontier arrays: the default tile only
template <int D>
cudaError_t fwd_hop_range(const Args& a, bool drop, cudaStream_t s) {
  return drop ? fwd_hop<D, 2, 128, true, true>(a, s)
              : fwd_hop<D, 2, 128, false, true>(a, s);
}

template <int NI, bool kDrop>
cudaError_t fwd_f(const Args& a, cudaStream_t s) {
  fwd_fma<NI, kDrop><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NI, bool kDrop>
cudaError_t bwd_f(const Args& a, int parts, cudaStream_t s) {
  if ((parts & 2) && a.Sq > 0) {
    dq_fma<NI, kDrop><<<row_grid(a, kWarps * kTR), kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (!(parts & 4) || a.Skv <= 0) return cudaSuccess;
  dkv_fma<NI, kDrop><<<key_grid(a, kWarps * fma_keys(kDrop)), kThreads, 0,
                        s>>>(a);
  return cudaGetLastError();
}

// the fp32 bodies at NI = D / 32 head-dim elements a lane (at least 1)
template <bool kDrop>
cudaError_t fwd_f32(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 16:
    case 32: return fwd_f<1, kDrop>(a, s);
    case 64: return fwd_f<2, kDrop>(a, s);
    case 128: return fwd_f<4, kDrop>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDrop>
cudaError_t bwd_f32(const Args& a, int parts, cudaStream_t s) {
  switch (a.D) {
    case 16:
    case 32: return bwd_f<1, kDrop>(a, parts, s);
    case 64: return bwd_f<2, kDrop>(a, parts, s);
    case 128: return bwd_f<4, kDrop>(a, parts, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dropout runs in every body: the Hopper ones (bf16, D = 64 and 128, K1
// at its default tile), the bf16 mma.sync ones (D = 16 and 32) and the fp32
// ones. A call with no q row or no key has no pair to drop.
cudaError_t run_fwd(const Args& a, int dtype, int bq, int bkv, bool drop,
                    cudaStream_t s) {
  drop = drop && a.Skv > 0;
  if (a.qrange && hop_ok(a, dtype)) {
    // the frontier arrays' instances are the default tiles'
    if (bq != 0 || bkv != 0) return cudaErrorInvalidValue;
    return a.D == 64 ? fwd_hop_range<64>(a, drop, s)
                     : fwd_hop_range<128>(a, drop, s);
  }
  if (drop) {
    // the dropout instances are the default tiles'
    if (bq != 0 || bkv != 0) return cudaErrorInvalidValue;
    if (hop_ok(a, dtype))
      return a.D == 64 ? fwd_hop<64, 2, 128, true>(a, s)
                       : fwd_hop<128, 2, 128, true>(a, s);
    if (dtype == 0) return fwd_f32<true>(a, s);
    return fwd_mma_launch(a, true, s);
  }
  if (hop_ok(a, dtype)) return fwd_hop_tile(a, bq, bkv, s);
  // the mma and FMA bodies have one tile each: (0, 0)
  if (bq != 0 || bkv != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return fwd_f32<false>(a, s);
  if (a.D <= 32) return fwd_mma_launch(a, false, s);
  // D = 64 or 128 with no key
  return fill_no_pairs(a.out, size_t(a.B) * a.Sq * a.H * a.D, a.lse,
                       size_t(a.B) * a.H * a.Sq, s);
}

cudaError_t run_prepass(const Args& a, int dtype, const void* out,
                        float* work, cudaStream_t s) {
  if (dtype == 1) {
    switch (a.D) {
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
                    int parts, bool drop, cudaStream_t s) {
  drop = drop && a.Sq > 0 && a.Skv > 0;
  // the mma bodies compute delta in their own CTAs: no pre-pass
  if (dtype == 1 && a.D <= 32) return bwd_mma_launch(a, drop, parts, s);
  if (dtype == 1 && !hop_ok(a, dtype)) {  // D = 64 or 128, no row or no key
    cudaError_t e = cudaSuccess;
    if ((parts & 2) && a.Skv == 0)
      e = fill_no_pairs(a.dq, size_t(a.B) * a.Sq * a.H * a.D, nullptr, 0, s);
    const size_t kv = size_t(a.B) * a.Skv * a.KV * a.D;
    if (e == cudaSuccess && (parts & 4) && a.Sq == 0)
      e = fill_no_pairs(a.dk, kv, nullptr, 0, s);
    if (e == cudaSuccess && (parts & 4) && a.Sq == 0)
      e = fill_no_pairs(a.dv, kv, nullptr, 0, s);
    return e;
  }
  if ((parts & 1) && a.Sq > 0) {
    cudaError_t e = run_prepass(a, dtype, out, work, s);
    if (e != cudaSuccess) return e;
  }
  if (hop_ok(a, dtype))
    return a.D == 64 ? bwd_hop_any<64>(a, work, parts, drop, s)
                     : bwd_hop_any<128>(a, work, parts, drop, s);
  return drop ? bwd_f32<true>(a, parts, s) : bwd_f32<false>(a, parts, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out share it). lse [B, H, Sq].
// qrange int32 [B, Sq, 2] and krange [B, Skv, 2]: the per-sequence
// frontiers (both or neither; null: the causal / segment rule).
// (block_q, block_kv): a tile flash_attention_fwd_tiles lists for (D,
// dtype), or (0, 0) for the body's default; any other pair, or a pair on a
// call the Hopper body does not take (no key), returns
// cudaErrorInvalidValue without a launch.
namespace {

int fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
               const void* kseg, const void* qrange, const void* krange,
               void* out, void* lse, int B, int Sq, int Skv,
               int H, int KV, int D, int causal, float scale, int dtype,
               int block_q, int block_kv, bool drop, uint32_t seed0,
               uint32_t seed1, uint32_t threshold, float keep_scale, int h0,
               void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.qrange = static_cast<const int2*>(qrange);
  a.krange = static_cast<const int2*>(krange);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KV = KV; a.D = D;
  a.causal = causal;
  a.scale = scale;
  a.seed0 = seed0; a.seed1 = seed1; a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.h0 = h0;
  return static_cast<int>(run_fwd(a, dtype, block_q, block_kv, drop,
                                  static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* qrange, const void* krange, void* out,
    void* lse, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    float scale, int dtype, int block_q, int block_kv, void* stream) {
  return fwd_launch(q, k, v, qseg, kseg, qrange, krange, out, lse, B, Sq,
                    Skv, H, KV, D, causal, scale, dtype, block_q, block_kv,
                    false, 0, 0, 0, 1.f, 0, stream);
}

// K1 with attention dropout (the JAX _sdpa_raw's, after the softmax): O =
// (P M / (1 - p)) V with l and lse over the undropped P. The mask M is
// Philox4x32-10 keyed by (seed0, seed1) over the counter layout of
// philox.cuh; an element is kept iff its 16-bit half of a word >=
// threshold = round(p 2^16) (at most 65536: none kept); keep_scale =
// 1 / (1 - p); h0, the global index of head 0 (a tensor-parallel rank's
// first head; 0 at degree 1). The default tile only.
extern "C" int flash_attention_fwd_dropout_launch(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* qrange, const void* krange, void* out,
    void* lse, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    float scale, int dtype, unsigned seed0, unsigned seed1,
    unsigned threshold, float keep_scale, int h0, void* stream) {
  return fwd_launch(q, k, v, qseg, kseg, qrange, krange, out, lse, B, Sq,
                    Skv, H, KV, D, causal, scale, dtype, 0, 0, true, seed0,
                    seed1, threshold, keep_scale, h0, stream);
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
namespace {

int bwd_launch(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* work,
               const void* qseg, const void* kseg, const void* qrange,
               const void* krange, void* dq, void* dk,
               void* dv, int B, int Sq, int Skv, int H, int KV, int D,
               int causal, float scale, int dtype, int parts, bool drop,
               uint32_t seed0, uint32_t seed1, uint32_t threshold,
               float keep_scale, int h0, void* stream) {
  if (B <= 0 || H <= 0 || (Sq <= 0 && Skv <= 0)) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out = const_cast<void*>(out);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(work) +
            size_t(B) * H * ((Sq + kPad - 1) / kPad * kPad);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.qrange = static_cast<const int2*>(qrange);
  a.krange = static_cast<const int2*>(krange);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.KV = KV; a.D = D;
  a.Sp = (Sq + kPad - 1) / kPad * kPad;
  a.causal = causal;
  a.scale = scale;
  a.seed0 = seed0; a.seed1 = seed1; a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.h0 = h0;
  return static_cast<int>(run_bwd(a, dtype, out, static_cast<float*>(work),
                                  parts, drop,
                                  static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, const void* qseg,
    const void* kseg, const void* qrange, const void* krange, void* dq,
    void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
    int causal, float scale, int dtype, int parts, void* stream) {
  return bwd_launch(q, k, v, out, dout, lse, work, qseg, kseg, qrange,
                    krange, dq, dk, dv, B, Sq, Skv, H, KV, D, causal, scale,
                    dtype, parts, false, 0, 0, 0, 1.f, 0, stream);
}

// K2 of K1's dropout call, from the same seed, threshold and keep_scale:
// dV = (P M / (1 - p))^T dO, dP = (dO V^T) M / (1 - p), dS = P (dP - delta)
// with delta = rowsum(dO o O) from the pre-pass (still exact with dropout).
extern "C" int flash_attention_bwd_dropout_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, const void* qseg,
    const void* kseg, const void* qrange, const void* krange, void* dq,
    void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
    int causal, float scale, int dtype, int parts, unsigned seed0,
    unsigned seed1, unsigned threshold, float keep_scale, int h0,
    void* stream) {
  return bwd_launch(q, k, v, out, dout, lse, work, qseg, kseg, qrange,
                    krange, dq, dk, dv, B, Sq, Skv, H, KV, D, causal, scale,
                    dtype, parts, true, seed0, seed1, threshold, keep_scale,
                    h0, stream);
}
