// K4, K5 and K6: attention over a paged or contiguous KV cache for Hopper
// (sm_90a).
//
// Replaces three TPU kernels:
//   K4 paddle_tpu/ops/pallas/ragged_paged_attention.py:
//      ragged_paged_attention -> _ragged_kernel (mixed prefill-chunk and
//      decode rows; slot i of row b sits at starts[b] + i, slots
//      i >= seq_lens[b] are dead and output exactly 0)
//   K5 paddle_tpu/ops/pallas/decode_attention.py:
//      paged_decode_attention -> _paged_kernel (every slot live, rows at
//      lengths[b] .. lengths[b] + Sq - 1)
//   K6 paddle_tpu/ops/pallas/decode_attention.py:
//      decode_attention -> _kernel (K5's rows against the contiguous
//      head-major cache [B, KV, M, D] of static-cache generation)
// K5 is K4 with seq_lens = Sq, and K6 is K5 with direct addressing; a null
// seq_lens pointer means "every slot live", a null table pointer
// "contiguous cache".
//
// Layouts: q and out [B, Sq, H, D]; k/v pools [P, KV, page, D]; block
// tables [B, >= npages] int32 with row stride tbl_stride (a column slice
// of a wider table is fine); starts and seq_lens [B] int32. K6's caches
// are [B, KV, M, D]: key t of (b, kv) sits at ((b * KV + kv) * M + t) * D,
// and M (the caller's max length) need not be a multiple of the 8-key or
// 64-key steps, so every K6 load is bounded by M and keys past it are
// masked. Query head h reads KV head h / (H / KV) (GQA). A tile's rows
// are (slot, q head of the group) pairs r = slot * G + g.
//
// Bound on this card: bytes. Each (row, KV head) must read the K and V
// pages its frontier reaches once: sum over rows b of 2 * KV * (start_b +
// last_live_slot_b + 1) * D * itemsize, plus q and out once. The flops (4
// * D per (q head, key) pair) stay below the tensor-core rate even for a
// 256-slot chunk.
//
// Routes (paged_attention_plan tells the caller which one a shape takes;
// all three are hand-written bodies of this file):
//   wgmma_split  bf16, D = 64 or 128, pages that divide 64 or are a
//                multiple of it: every K4 and K5 call of the serving and
//                paged-generation paths, chunks and decode rows alike.
//   mma          bf16 with other head dims (16, 32) or pages, >= 16 rows:
//                the mma.sync tile below (and every K6 prefill).
//   fma          everything else (fp32, D up to 256, K6 decode).
// K6 always takes mma or fma.
//
// The Hopper body (design):
//   One CTA per (128 rows, KV head, batch row): two consumer warpgroups of
//   64 rows and one producer warp. Pages arrive by TMA: one 4-D tensor map
//   over each pool, boxes of min(page, 64) keys x 64 columns of one (page,
//   KV head) plane with the 128-byte swizzle, so a 64-key tile is 64 /
//   page boxes (or a part of one page) laid out as the wgmma descriptors
//   expect. The producer reads the block table 32 entries at a time and
//   issues each tile's K and V into a 4-stage ring guarded by mbarriers, so
//   a page is read once for the tile's 128 rows (the G q heads of a KV
//   head share it). Q is staged once in shared memory (swizzled by hand,
//   zero for dead rows). S = Q K^T runs from shared memory (SS), P V with P
//   from registers (RS). Online softmax in f32, base 2; masks are -inf
//   scores written only on tiles a row's frontier cuts. Tried on the H100
//   and not kept, each no faster: overlapping a warpgroup's softmax with
//   its pending P V (ptxas serialised the wgmmas, C7515), ping-pong issue
//   between the two warpgroups, and thin tiles whose two warpgroups take
//   alternate key tiles (decode rows are bound by the pool's bytes).
//   Split-K (flash-decoding) for thin tiles: the last live tile of a (batch
//   row, KV head) with at most 16 live rows -- a decode row and its G q
//   heads, a short chunk -- splits its key range into 512-key pieces. The
//   grid's split axis is sized from what the host knows (npages * page /
//   512), so no device-to-host read is needed and a CUDA graph can capture
//   the call; a split past its tile's frontier exits at once. Each split
//   writes f32 partials (m in base 2, l, unnormalised acc) to a workspace
//   the wrapper allocates, nsplit * B * KV * 16 * (D + 2) * 4 bytes (8.5 MB
//   at [8, 256, 32, 128] over 2048 keys); a merge kernel combines them in
//   split order (deterministic: no atomics). Full tiles walk their range
//   in one CTA and write their output directly. Dead slots are written 0
//   by split 0.
//
// FMA body: one CTA of 4 warps per (tile of up to 8
// (slot, q-head-in-group) rows, KV head, batch row). The tile's rows
// live in registers (q, f32 accumulator, online-softmax m and l); each
// lane owns head-dim elements d = lane + 32*n, so a warp reads one key
// row with one coalesced load per n. The 4 warps split the key range in
// groups of 8 keys (4 for D > 128) and stream K and V straight from the
// pool into registers: every K/V byte a tile needs is read once and is
// shared by all the tile's rows (the G q heads of a KV head share each
// page load, as at ragged_paged_attention.py:79). The CTA reads the
// physical page id from the block table itself (K6: computes the address
// directly) and stops at the frontier of its last live row, clamped at M
// for K6, so a decode row reads only its own history. The
// four warps' partial softmax states are merged through shared memory at
// the end. A tile whose slots are all dead writes zeros and exits.
// Scores, softmax state and accumulation are f32; masking uses -1e30 and
// the final l is clamped at 1e-30, so dead slots give exactly 0.
//
// mma body: one CTA of 4 warps per (64 rows, KV head, batch
// row), 16 rows per warp held as mma A fragments. The CTA stages K and V
// 64 keys at a time in shared memory (read once per CTA from the pages
// the block table names, or K6's cache rows, up to the tile's frontier;
// K6 rows past M stage as zeros) and every warp runs
// S = Q K^T and acc += P V on mma.sync m16n8k16; the same masking,
// online softmax and dead-slot rules hold.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;    // null: contiguous [B, KV, M, D] cache (K6)
  const int* starts;
  const int* seq_lens;  // null: every slot live (K5, K6)
  void* out;
  int B, Sq, H, KV, D, page, npages, tbl_stride;
  int P;                // pool pages (the tensor maps' outer dimension)
  int M;                // K6: cache length
  float scale;
};

// The addressing policy: element offset of cache key `key` of (batch row
// b, KV head kv). Paged (K4, K5): through the block table; a key past the
// table reads its last page, as the TPU kernel's clamped index map does,
// and is masked. Contiguous (K6): direct, no lookup.
template <bool kContig>
__device__ __forceinline__ size_t key_offset(const Args& a, int b, int kv,
                                             int key) {
  if constexpr (kContig) {
    return ((size_t(b) * a.KV + kv) * a.M + key) * size_t(a.D);
  } else {
    const int j = min(key / a.page, a.npages - 1);
    const int pid = a.tables[size_t(b) * a.tbl_stride + j];
    const size_t plane = size_t(a.page) * a.D;  // one [page, D] head plane
    return (size_t(pid) * a.KV + kv) * plane + size_t(key % a.page) * a.D;
  }
}

// keys at or past this position do not exist (K6: the cache length)
template <bool kContig>
__device__ __forceinline__ int key_limit(const Args& a) {
  return kContig ? a.M : INT_MAX;
}

// element offset of the [D] vector of tile row i (slot, q head) in q/out
__device__ __forceinline__ size_t row_offset(const Args& a, int b, int kv,
                                             int G, int r) {
  const int slot = r / G;
  const int g = r - slot * G;
  return ((size_t(b) * a.Sq + slot) * a.H + size_t(kv) * G + g) *
         size_t(a.D);
}

// One warp step's K and V rows, KB keys from element offset `base`, into
// registers as f32 (lane holds d = lane + 32 * n). kGuard: only the first
// `nk` keys exist (K6's last group before M); the others read as 0, and
// whole groups take the unguarded form. Every raw value is loaded before
// any is converted: were the conversion beside its guarded load, the
// compiler may wrap each load and its use in one branch region and wait
// for each load in turn (measured on the H100: K6's bf16 decode 8.6x
// slower; PERF.md, K6 findings).
template <typename T, int NI, int KB, bool kGuard>
__device__ __forceinline__ void load_keys(const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          size_t base, int D, int lane,
                                          int nk, float (&kf)[KB][NI],
                                          float (&vf)[KB][NI]) {
  T kr[KB][NI], vr[KB][NI];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      const bool ok = d < D && (!kGuard || kk < nk);
      kr[kk][n] = ok ? kp[base + size_t(kk) * D + d] : from_f<T>(0.f);
      vr[kk][n] = ok ? vp[base + size_t(kk) * D + d] : from_f<T>(0.f);
    }
  }
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      kf[kk][n] = to_f(kr[kk][n]);
      vf[kk][n] = to_f(vr[kk][n]);
    }
  }
}

// NI: head-dim elements per lane; TR: rows per CTA; KB: keys per warp step
template <typename T, int NI, int TR, int KB, bool kContig>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kp = static_cast<const T*>(a.k_pool);
  const T* __restrict__ vp = static_cast<const T*>(a.v_pool);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int G = a.H / a.KV;
  const int R = a.Sq * G;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int D = a.D;
  const int start = a.starts[b];
  const int nv = a.seq_lens ? a.seq_lens[b] : a.Sq;
  const int nrows = min(TR, R - r0);
  const int slot_lo = r0 / G;
  const int last_live = min((r0 + nrows - 1) / G, nv - 1);
  const int klim = key_limit<kContig>(a);

  if (last_live < slot_lo) {  // every slot of this tile is dead
    for (int i = warp; i < nrows; i += kWarps) {
      const size_t o = row_offset(a, b, kv, G, r0 + i);
      for (int d = lane; d < D; d += 32) out[o + d] = from_f<T>(0.f);
    }
    return;
  }

  float qr[TR][NI], acc[TR][NI], m[TR], l[TR];
  int qpos[TR];  // last key position row i may attend; -1 when dead
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int slot = (r0 + i) / G;
    const bool live = i < nrows && slot < nv;
    qpos[i] = live ? min(start + slot, klim - 1) : -1;
    m[i] = kNeg;
    l[i] = 0.f;
    const size_t o = live ? row_offset(a, b, kv, G, r0 + i) : 0;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      qr[i][n] = (live && d < D) ? to_f(q[o + d]) : 0.f;
      acc[i][n] = 0.f;
    }
  }

  const int nkeys = min(start + last_live + 1, klim);
  const int ngroups = (nkeys + KB - 1) / KB;
  for (int gi = warp; gi < ngroups; gi += kWarps) {
    // KB divides page: a paged group never straddles pages; a contiguous
    // group may run past M, and those keys are neither read nor seen
    const int k0 = gi * KB;
    const size_t base = key_offset<kContig>(a, b, kv, k0);
    float kf[KB][NI], vf[KB][NI];
    if (!kContig || k0 + KB <= klim)
      load_keys<T, NI, KB, false>(kp, vp, base, D, lane, KB, kf, vf);
    else
      load_keys<T, NI, KB, true>(kp, vp, base, D, lane, klim - k0, kf, vf);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (qpos[i] < k0) continue;  // warp-uniform: no visible key here
      float s[KB];
      float mx = m[i];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < NI; ++n) part += qr[i][n] * kf[kk][n];
        s[kk] = warp_sum(part) * a.scale;
        if (k0 + kk > qpos[i]) s[kk] = kNeg;
        mx = fmaxf(mx, s[kk]);
      }
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        s[kk] = (k0 + kk <= qpos[i]) ? expf(s[kk] - mx) : 0.f;
        psum += s[kk];
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        float v = acc[i][n] * corr;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) v += s[kk] * vf[kk][n];
        acc[i][n] = v;
      }
      m[i] = mx;
    }
  }

  // merge the warps' partial states (each warp saw a disjoint key set)
  __shared__ float sm_m[kWarps][TR];
  __shared__ float sm_l[kWarps][TR];
  __shared__ float sm_acc[kWarps][TR][NI * 32];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) sm_acc[warp][i][lane + 32 * n] = acc[i][n];
  }
  __syncthreads();
  for (int i = warp; i < nrows; i += kWarps) {
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][i]);
    float f[kWarps];
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      f[w] = expf(sm_m[w][i] - M);
      L += sm_l[w][i] * f[w];
    }
    L = fmaxf(L, 1e-30f);
    const size_t o = row_offset(a, b, kv, G, r0 + i);
    for (int d = lane; d < D; d += 32) {
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) A += sm_acc[w][i][d] * f[w];
      out[o + d] = from_f<T>(A / L);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core tile: 64 (slot, q-head) rows per CTA, 16 per warp.
// Scores S = Q K^T and the update acc += P V run on mma.sync m16n8k16
// (bf16 in, f32 accumulate); K and V are staged in shared memory 64 keys
// at a time and shared by the four warps. Softmax state stays f32; P
// enters the PV product as two bf16 parts (split_bf16), l is summed from
// the f32 P.
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;
constexpr int kMmaKeys = 64;

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

// P as the sum of two bf16 fragments, hi + lo, so the P V product keeps
// about 16 bits of P instead of 8: the output then rounds to bf16 once,
// as the plain version's does
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, bool kContig>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(Args a) {
  constexpr int KT = D / 16;          // k-steps over the head dim (Q K^T)
  constexpr int NT = D / 8;           // n-tiles over the head dim (P V)
  constexpr int LD = D + 8;           // padded smem row: conflict-free frags
  constexpr int CH = kMmaKeys * D / 8 / kThreads;  // 16 B chunks a thread
  __shared__ __align__(16) __nv_bfloat16 sk[kMmaKeys * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[kMmaKeys * LD];

  const __nv_bfloat16* __restrict__ q =
      static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* __restrict__ kp =
      static_cast<const __nv_bfloat16*>(a.k_pool);
  const __nv_bfloat16* __restrict__ vp =
      static_cast<const __nv_bfloat16*>(a.v_pool);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(a.out);

  const int G = a.H / a.KV;
  const int R = a.Sq * G;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.x * kMmaRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;          // fragment row within 8
  const int tig = lane & 3;           // fragment column pair
  const int start = a.starts[b];
  const int nv = a.seq_lens ? a.seq_lens[b] : a.Sq;
  const int nrows = min(kMmaRows, R - r0);
  const int slot_lo = r0 / G;
  const int last_live = min((r0 + nrows - 1) / G, nv - 1);
  const int klim = key_limit<kContig>(a);

  if (last_live < slot_lo) {  // every slot of this tile is dead
    for (int i = warp; i < nrows; i += kWarps) {
      const size_t o = row_offset(a, b, kv, G, r0 + i);
      for (int d = lane; d < D; d += 32) out[o + d] = __float2bfloat16(0.f);
    }
    return;
  }

  // this lane's two rows: grp and grp + 8 of the warp's 16
  const int rA = r0 + warp * 16 + grp;
  const int rB = rA + 8;
  const int qpA = (rA < R && rA / G < nv) ? min(start + rA / G, klim - 1)
                                          : -1;
  const int qpB = (rB < R && rB / G < nv) ? min(start + rB / G, klim - 1)
                                          : -1;
  int wmax = max(qpA, qpB);  // the warp's last visible key
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  const size_t oA = rA < R ? row_offset(a, b, kv, G, rA) : 0;
  const size_t oB = rB < R ? row_offset(a, b, kv, G, rB) : 0;

  uint32_t qa[KT][4];  // Q as mma A fragments
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const int c = s * 16 + tig * 2;
    qa[s][0] = rA < R ? ld32(q + oA + c) : 0u;
    qa[s][1] = rB < R ? ld32(q + oB + c) : 0u;
    qa[s][2] = rA < R ? ld32(q + oA + c + 8) : 0u;
    qa[s][3] = rB < R ? ld32(q + oB + c + 8) : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int v = 0; v < NT; ++v)
    acc[v][0] = acc[v][1] = acc[v][2] = acc[v][3] = 0.f;
  float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;

  const int nkeys = min(start + last_live + 1, klim);
  const unsigned short* sv16 = reinterpret_cast<const unsigned short*>(sv);
  for (int k0 = 0; k0 < nkeys; k0 += kMmaKeys) {
    __syncthreads();  // the previous block's readers are done
    uint4 tk[CH], tv[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int key = k0 + c / (D / 8);
      if (kContig && key >= klim) {  // past M: zeros, hidden by the mask
        tk[i] = tv[i] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const size_t src = key_offset<kContig>(a, b, kv, key) +
                         (c % (D / 8)) * 8;
      tk[i] = *reinterpret_cast<const uint4*>(kp + src);
      tv[i] = *reinterpret_cast<const uint4*>(vp + src);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int dst = (c / (D / 8)) * LD + (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(sk + dst) = tk[i];
      *reinterpret_cast<uint4*>(sv + dst) = tv[i];
    }
    __syncthreads();
    if (wmax < k0) continue;  // warp-uniform: no row of it sees this block

    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int t = 0; t < kMmaKeys / 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      const __nv_bfloat16* krow = sk + (t * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks)
        mma_bf16(s[t], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }
    float bmA = kNeg, bmB = kNeg;
#pragma unroll
    for (int t = 0; t < kMmaKeys / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + t * 8 + tig * 2 + e;
        s[t][e] = key <= qpA ? s[t][e] * a.scale : kNeg;
        s[t][2 + e] = key <= qpB ? s[t][2 + e] * a.scale : kNeg;
        bmA = fmaxf(bmA, s[t][e]);
        bmB = fmaxf(bmB, s[t][2 + e]);
      }
    }
    const float nmA = fmaxf(mA, quad_max(bmA));
    const float nmB = fmaxf(mB, quad_max(bmB));
    const float cA = expf(mA - nmA);
    const float cB = expf(mB - nmB);
    float psA = 0.f, psB = 0.f;
#pragma unroll
    for (int t = 0; t < kMmaKeys / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + t * 8 + tig * 2 + e;
        s[t][e] = key <= qpA ? expf(s[t][e] - nmA) : 0.f;
        s[t][2 + e] = key <= qpB ? expf(s[t][2 + e] - nmB) : 0.f;
        psA += s[t][e];
        psB += s[t][2 + e];
      }
    }
    lA = lA * cA + psA;  // per-lane partial sums; the quad adds them last
    lB = lB * cB + psB;
    mA = nmA;
    mB = nmB;
#pragma unroll
    for (int v = 0; v < NT; ++v) {
      acc[v][0] *= cA;
      acc[v][1] *= cA;
      acc[v][2] *= cB;
      acc[v][3] *= cB;
    }
#pragma unroll
    for (int u = 0; u < kMmaKeys / 16; ++u) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * u][0], s[2 * u][1], ph[0], pl[0]);
      split_bf16(s[2 * u][2], s[2 * u][3], ph[1], pl[1]);
      split_bf16(s[2 * u + 1][0], s[2 * u + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * u + 1][2], s[2 * u + 1][3], ph[3], pl[3]);
      const unsigned short* vk = sv16 + (u * 16 + tig * 2) * LD + grp;
#pragma unroll
      for (int v = 0; v < NT; ++v) {
        const unsigned short* p = vk + v * 8;
        const uint32_t b0 = uint32_t(p[0]) | (uint32_t(p[LD]) << 16);
        const uint32_t b1 = uint32_t(p[8 * LD]) | (uint32_t(p[9 * LD]) << 16);
        mma_bf16(acc[v], ph, b0, b1);
        mma_bf16(acc[v], pl, b0, b1);
      }
    }
  }

  lA = fmaxf(quad_sum(lA), 1e-30f);
  lB = fmaxf(quad_sum(lB), 1e-30f);
#pragma unroll
  for (int v = 0; v < NT; ++v) {
    const int d = v * 8 + tig * 2;
    if (rA < R)
      *reinterpret_cast<uint32_t*>(out + oA + d) =
          pack_bf16(acc[v][0] / lA, acc[v][1] / lA);
    if (rB < R)
      *reinterpret_cast<uint32_t*>(out + oB + d) =
          pack_bf16(acc[v][2] / lB, acc[v][3] / lB);
  }
}

template <int D, bool kContig>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const int R = a.Sq * (a.H / a.KV);
  dim3 grid((R + kMmaRows - 1) / kMmaRows, a.KV, a.B);
  paged_attention_mma_kernel<D, kContig><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int NI, int TR, bool kContig>
cudaError_t launch_tile(const Args& a, cudaStream_t s) {
  constexpr int KB = NI >= 8 ? 4 : 8;
  const int R = a.Sq * (a.H / a.KV);
  dim3 grid((R + TR - 1) / TR, a.KV, a.B);
  paged_attention_kernel<T, NI, TR, KB, kContig><<<grid, kThreads, 0, s>>>(
      a);
  return cudaGetLastError();
}

template <typename T, int NI, bool kContig>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  constexpr int kMaxRows = NI >= 8 ? 4 : 8;  // register budget
  const int R = a.Sq * (a.H / a.KV);
  if (R >= kMaxRows) return launch_tile<T, NI, kMaxRows, kContig>(a, s);
  if (R >= 4) return launch_tile<T, NI, 4, kContig>(a, s);
  if (R >= 2) return launch_tile<T, NI, 2, kContig>(a, s);
  return launch_tile<T, NI, 1, kContig>(a, s);
}

template <typename T, bool kContig>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch_rows<T, 1, kContig>(a, s);
  if (a.D <= 64) return launch_rows<T, 2, kContig>(a, s);
  if (a.D <= 128) return launch_rows<T, 4, kContig>(a, s);
  if (a.D <= 256) return launch_rows<T, 8, kContig>(a, s);
  return cudaErrorInvalidValue;
}

template <bool kContig>
int run(const Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = a.Sq * (a.H / a.KV);
  cudaError_t e;
  if (dtype == 1 && R >= 16 && a.D == 128)
    e = launch_mma<128, kContig>(a, s);
  else if (dtype == 1 && R >= 16 && a.D == 64)
    e = launch_mma<64, kContig>(a, s);
  else if (dtype == 1 && R >= 16 && a.D == 32)
    e = launch_mma<32, kContig>(a, s);
  else if (dtype == 1 && R >= 16 && a.D == 16)
    e = launch_mma<16, kContig>(a, s);
  else
    e = dtype == 0 ? launch<float, kContig>(a, s)
                   : launch<__nv_bfloat16, kContig>(a, s);
  return static_cast<int>(e);
}


// ---------------------------------------------------------------------------
// Hopper body (bf16, D = 64 and 128): TMA page loads, split-K, wgmma.
// Accumulator layout of a wgmma d[64 x N] (warp w of the warpgroup, lane =
// 4 grp + tig): d[4 j + 2 hi + e] is row 16 w + grp + 8 hi, column 8 j +
// 2 tig + e.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using hopper::kmajor;
using hopper::mnmajor;
using hopper::neg_inf;
using hopper::swz_chunk;

constexpr int kTileKeys = 64;    // keys a TMA stage (a [64, D] K and V tile)
constexpr int kTileRows = 128;   // rows a CTA: two consumer warpgroups
constexpr int kTileStages = 4;
constexpr int kThin = 16;        // a tile with at most this many live rows
                                 // splits its key range
constexpr int kSplitKeys = 512;  // keys a split
constexpr int kConsumers = 256;
constexpr int kHopThreads = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

enum Route { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

struct SplitParams {
  CUtensorMap tk, tv;  // the pools: boxes of min(page, 64) keys x 64 columns
  Args a;
  float* ws;           // acc [nsplit][B][KV][kThin][D], then (m, l) [...][2]
  int nsplit;
};

// The work of one (row tile, KV head, batch row): rows [r0, r0 + nrows) of
// the KV head's R = Sq * G, the first nl of them live; f the last key the
// tile's live rows see; nsp its number of splits (1: the tile writes its
// output directly). Only the last live tile of a (batch row, KV head) can
// be thin. The tile kernel and the merge compute it the same way.
struct Plan {
  int r0, nrows, nl, f, nsp;
};

__device__ __forceinline__ int live_slots(const Args& a, int b) {
  return a.seq_lens ? min(max(a.seq_lens[b], 0), a.Sq) : a.Sq;
}

__device__ __forceinline__ Plan make_plan(const Args& a, int b, int tile,
                                          int nsplit) {
  const int G = a.H / a.KV;
  Plan p;
  p.r0 = tile * kTileRows;
  p.nrows = min(kTileRows, a.Sq * G - p.r0);
  p.nl = min(max(live_slots(a, b) * G - p.r0, 0), p.nrows);
  p.f = p.nl > 0 ? a.starts[b] + (p.r0 + p.nl - 1) / G : -1;
  p.nsp = (p.nl > 0 && p.nl <= kThin && nsplit > 1)
              ? min(max(p.f, 0) / kSplitKeys + 1, nsplit)
              : 1;
  return p;
}

__device__ __forceinline__ size_t ws_row(const Args& a, int s, int b, int kv,
                                         int i) {
  return ((size_t(s) * a.B + b) * a.KV + kv) * kThin + i;
}

__device__ __forceinline__ float* ws_ml(const SplitParams& P) {
  return P.ws + size_t(P.nsplit) * P.a.B * P.a.KV * kThin * P.a.D;
}

// Physical page ids of one batch row, read by a whole warp 32 table
// entries at a time (lane i holds entry base + i); a logical page past the
// table reads its last entry, as the TPU kernel's clamped index map does.
struct PageWindow {
  int base = INT_MIN / 2;
  int pid = 0;
  __device__ __forceinline__ int get(const Args& a, int b, int lg, int lane) {
    lg = min(lg, a.npages - 1);
    if (lg < base || lg >= base + 32) {  // warp-uniform
      base = lg;
      pid = lg + lane < a.npages
                ? a.tables[size_t(b) * a.tbl_stride + lg + lane]
                : 0;
    }
    return __shfl_sync(0xffffffffu, pid, lg - base);
  }
};

// TMA the [64, D] K and V tiles of keys k0 .. k0 + 63 of (b, kv) into kdst
// and vdst (D / 64 swizzled panels each) on barrier `bar`: 64 / page boxes
// of one page each, or one box inside a larger page. Called by a whole
// warp; lane 0 issues.
template <int D>
__device__ __forceinline__ void load_tile(bf16* kdst, bf16* vdst,
                                          const SplitParams& P, uint64_t* bar,
                                          int b, int kv, int k0,
                                          PageWindow& win, int lane) {
  const Args& a = P.a;
  const int box = min(a.page, kTileKeys);
  for (int j = 0; j < kTileKeys; j += box) {
    const int key = k0 + j;
    const int pid = win.get(a, b, key / a.page, lane);
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        const int off = p * kTileKeys * 64 + j * 64;
        hopper::tma_load_4d(kdst + off, &P.tk, bar, p * 64, key % a.page, kv,
                            pid);
        hopper::tma_load_4d(vdst + off, &P.tv, bar, p * 64, key % a.page, kv,
                            pid);
      }
    }
  }
}

template <int D>
struct TileCfg {
  static constexpr int QE = kTileRows * D;   // elements of the Q tile
  static constexpr int TE = kTileKeys * D;   // elements of a K or V tile
  static constexpr uint32_t TB = TE * 2;
  static constexpr int smem = QE * 2 + kTileStages * 2 * TB + 128 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    tile_wgmma_kernel(const __grid_constant__ SplitParams P) {
  using C = TileCfg<D>;
  const Args& a = P.a;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int ntiles = (a.Sq * G + kTileRows - 1) / kTileRows;
  // x < ntiles: split 0 of tile ntiles - 1 - x (the longest range of the
  // row first); x >= ntiles: split x - ntiles + 1 of the last live tile,
  // which splits when it is thin. (Launching the last tiles of every batch
  // row first measured ~5% slower at [8, 256, 32, 128] on the H100.)
  int tile, s;
  if (int(blockIdx.x) < ntiles) {
    tile = ntiles - 1 - blockIdx.x;
    s = 0;
  } else {
    const int nv = live_slots(a, b);
    if (nv == 0) return;
    tile = (nv * G - 1) / kTileRows;
    s = blockIdx.x - ntiles + 1;
  }
  const Plan pl = make_plan(a, b, tile, P.nsplit);
  bf16* out = static_cast<bf16*>(a.out);
  if (s == 0) {  // dead rows are exactly 0
    for (int idx = threadIdx.x; idx < (pl.nrows - pl.nl) * (D / 8);
         idx += kHopThreads) {
      const int r = pl.r0 + pl.nl + idx / (D / 8);
      *reinterpret_cast<uint4*>(out + row_offset(a, b, kv, G, r) +
                                (idx % (D / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (pl.nl == 0 || s >= pl.nsp) return;
  // keys [kb, ke) of this split; the last split runs to the frontier
  const int kb = s * kSplitKeys;
  const int ke = s == pl.nsp - 1 ? pl.f + 1 : kb + kSplitKeys;
  const int nt = (ke - kb + kTileKeys - 1) / kTileKeys;
  const int nwg = pl.nl > 64 ? 2 : 1;  // warpgroups with a live row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = sq + C::QE;  // stage st: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + kTileStages * 2 * C::TE);
  uint64_t* empty = full + kTileStages;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kTileStages; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 128 * nwg);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    const int lane = threadIdx.x & 31;
    PageWindow win;
    for (int t = 0; t < nt; ++t) {
      const int st = t % kTileStages;
      // parity ph ^ 1: the first round passes, as the slot starts empty
      hopper::mbar_wait(empty + st, ((t / kTileStages) & 1) ^ 1);
      if (lane == 0) hopper::mbar_arrive_tx(full + st, 2 * C::TB);
      bf16* kt = skv + st * 2 * C::TE;
      load_tile<D>(kt, kt + C::TE, P, full + st, b, kv, kb + t * kTileKeys,
                   win, lane);
    }
    return;
  }
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (wg >= nwg) return;  // every row of this warpgroup is dead (zeroed)
  const int w = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;

  // the warpgroup's 64 Q rows into shared memory, swizzled as TMA would
  // write them; dead rows are 0
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
    const int rl = wg * 64 + idx / (D / 8), c = idx % (D / 8);
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (rl < pl.nl)
      u = *reinterpret_cast<const uint4*>(
          q + row_offset(a, b, kv, G, pl.r0 + rl) + c * 8);
    *reinterpret_cast<uint4*>(smem + swz_chunk(kTileRows, rl, c)) = u;
  }
  hopper::fence_proxy_async();
  hopper::named_sync(1 + wg, 128);

  // rows (in the tile) of this lane; a dead row borrows the last live
  // row's frontier, so it needs no mask of its own (its output is dropped)
  const int rA = wg * 64 + w * 16 + grp, rB = rA + 8;
  const int start = a.starts[b];
  const int fA = start + (pl.r0 + min(rA, pl.nl - 1)) / G;
  const int fB = start + (pl.r0 + min(rB, pl.nl - 1)) / G;
  const int f0 = start + (pl.r0 + wg * 64) / G;  // the warpgroup's smallest
  const float sl2 = a.scale * kLog2e;
  float o[D / 2], sc[kTileKeys / 2];
  uint32_t pa[kTileKeys / 16][4];
  hopper::zero(o);
  float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int st = t % kTileStages;
    hopper::mbar_wait(full + st, (t / kTileStages) & 1);
    const bf16* ks = skv + st * 2 * C::TE;
    const bf16* vs = ks + C::TE;
    const int k0 = kb + t * kTileKeys;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::ss<kTileKeys>(sc, kmajor(sq, kTileRows, wg * 64, kk),
                            kmajor(ks, kTileKeys, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sc);
    // masked scores become -inf: their probability is exactly 0 and m
    // never drops below kNeg
    if (k0 + kTileKeys - 1 > f0) {
#pragma unroll
      for (int i = 0; i < kTileKeys / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (key > (((i >> 1) & 1) ? fB : fA)) sc[i] = neg_inf();
      }
    }
    float bA = neg_inf(), bB = neg_inf();
#pragma unroll
    for (int jj = 0; jj < kTileKeys / 8; ++jj) {
      bA = fmaxf(bA, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
      bB = fmaxf(bB, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
    }
    const float nA = fmaxf(mA, quad_max(bA) * sl2);
    const float nB = fmaxf(mB, quad_max(bB) * sl2);
    const float cA = exp2f(mA - nA), cB = exp2f(mB - nB);
    float pA = 0.f, pB = 0.f;
#pragma unroll
    for (int jj = 0; jj < kTileKeys / 8; ++jj) {
      sc[4 * jj] = exp2f(fmaf(sc[4 * jj], sl2, -nA));
      sc[4 * jj + 1] = exp2f(fmaf(sc[4 * jj + 1], sl2, -nA));
      sc[4 * jj + 2] = exp2f(fmaf(sc[4 * jj + 2], sl2, -nB));
      sc[4 * jj + 3] = exp2f(fmaf(sc[4 * jj + 3], sl2, -nB));
      pA += sc[4 * jj] + sc[4 * jj + 1];
      pB += sc[4 * jj + 2] + sc[4 * jj + 3];
    }
    lA = lA * cA + pA;  // per-lane partial sums; the quad adds them last
    lB = lB * cB + pB;
    mA = nA;
    mB = nB;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o[4 * jj] *= cA;
      o[4 * jj + 1] *= cA;
      o[4 * jj + 2] *= cB;
      o[4 * jj + 3] *= cB;
    }
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) hopper::to_a(pa[kk], sc, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk)
      hopper::rs<D>(o, pa[kk], mnmajor(vs, kTileKeys, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
    hopper::mbar_arrive(empty + st);
  }
  lA = quad_sum(lA);
  lB = quad_sum(lB);
  const bool wA = rA < pl.nl, wB = rB < pl.nl;
  if (pl.nsp == 1) {
    const size_t oA = wA ? row_offset(a, b, kv, G, pl.r0 + rA) : 0;
    const size_t oB = wB ? row_offset(a, b, kv, G, pl.r0 + rB) : 0;
    hopper::store_rows<D>(out, o, oA, wA, 1.f / fmaxf(lA, 1e-30f), oB, wB,
                          1.f / fmaxf(lB, 1e-30f), tig);
    return;
  }
  // a thin tile: its live rows (< 16) are rows grp, grp + 8 of warp 0
  float* ml = ws_ml(P);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? wB : wA)) continue;
    const size_t wr = ws_row(a, s, b, kv, h ? rB : rA);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(P.ws + wr * D + 8 * jj + 2 * tig) =
          make_float2(o[4 * jj + 2 * h], o[4 * jj + 2 * h + 1]);
    if (tig == 0) {
      ml[wr * 2] = h ? mB : mA;
      ml[wr * 2 + 1] = h ? lB : lA;
    }
  }
}

// The splits of the thin tile of each (batch row, KV head), combined in
// split order: one CTA per (KV head, batch row), a thread per (row,
// column), 512 / D rows at a time; the partials of 8 splits are loaded
// together so their latencies overlap, and a running max rescales the sums
// between groups of 8.
constexpr int kMergeThreads = 512;

__global__ void __launch_bounds__(kMergeThreads)
    merge_splits(const __grid_constant__ SplitParams P) {
  const Args& a = P.a;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int nv = live_slots(a, b);
  if (nv == 0) return;
  const Plan pl = make_plan(a, b, (nv * G - 1) / kTileRows, P.nsplit);
  if (pl.nsp <= 1) return;
  const float* ml = ws_ml(P);
  bf16* out = static_cast<bf16*>(a.out);
  for (int idx = threadIdx.x; idx < pl.nl * a.D; idx += kMergeThreads) {
    const int g = idx / a.D, d = idx % a.D;
    float M = kNeg, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < pl.nsp; s0 += 8) {
      float m8[8], l8[8], a8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = s0 + i < pl.nsp;
        const size_t wr = ws_row(a, ok ? s0 + i : s0, b, kv, g);
        m8[i] = ok ? ml[wr * 2] : kNeg;
        l8[i] = ok ? ml[wr * 2 + 1] : 0.f;
        a8[i] = ok ? P.ws[wr * a.D + d] : 0.f;
      }
      float mx = M;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, m8[i]);
      const float c = exp2f(M - mx);
      L *= c;
      A *= c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = exp2f(m8[i] - mx);
        L += l8[i] * f;
        A += a8[i] * f;
      }
      M = mx;
    }
    out[row_offset(a, b, kv, G, pl.r0 + g) + d] =
        __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

// -- host: plan and launches -------------------------------------------------
struct HostPlan {
  int route, nsplit;
  long long ws_bytes;
};

// pages a 64-key tile can be cut from: whole pages of 8..64 keys, or 64-key
// parts of larger pages
bool tma_pages(int page) {
  return page % 8 == 0 && (page % kTileKeys == 0 || kTileKeys % page == 0);
}

HostPlan plan_for(const Args& a, int dtype) {
  HostPlan h{kRouteFma, 1, 0};
  const int R = a.Sq * (a.H / a.KV);
  if (dtype == 1 && (a.D == 64 || a.D == 128) && tma_pages(a.page) &&
      a.npages > 0 && a.P > 0) {
    h.route = kRouteWgmma;
    h.nsplit = int(((long long)a.npages * a.page + kSplitKeys - 1) /
                   kSplitKeys);
    if (h.nsplit > 1)
      h.ws_bytes = (long long)h.nsplit * a.B * a.KV * kThin * (a.D + 2) * 4;
  } else if (dtype == 1 && R >= 16 &&
             (a.D == 16 || a.D == 32 || a.D == 64 || a.D == 128)) {
    h.route = kRouteMma;
  }
  return h;
}

template <int D>
cudaError_t launch_wgmma(const Args& a, const HostPlan& h, float* ws,
                         cudaStream_t s) {
  SplitParams p{};
  p.a = a;
  p.ws = ws;
  p.nsplit = h.nsplit;
  const int box = a.page < kTileKeys ? a.page : kTileKeys;
  if (!hopper_host::encode_pool(&p.tk, a.k_pool, a.P, a.KV, a.page, D, box) ||
      !hopper_host::encode_pool(&p.tv, a.v_pool, a.P, a.KV, a.page, D, box))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tile_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TileCfg<D>::smem);
  if (e != cudaSuccess) return e;
  const int ntiles = (a.Sq * (a.H / a.KV) + kTileRows - 1) / kTileRows;
  const dim3 grid(ntiles + h.nsplit - 1, a.KV, a.B);
  tile_wgmma_kernel<D><<<grid, kHopThreads, TileCfg<D>::smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || h.nsplit == 1) return e;
  merge_splits<<<dim3(1, a.KV, a.B), kMergeThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// K4 and K5: the Hopper body where the plan routes there, else run<false>
int run_paged(const Args& a, int dtype, float* ws, void* stream) {
  if (a.B <= 0 || a.Sq <= 0) return 0;
  const HostPlan h = plan_for(a, dtype);
  if (h.route != kRouteWgmma) return run<false>(a, dtype, stream);
  if (h.nsplit > 1 && ws == nullptr) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.D == 128 ? launch_wgmma<128>(a, h, ws, s)
                                     : launch_wgmma<64>(a, h, ws, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// paged_attention_plan: the route a K4/K5 call of this shape takes and its
// split workspace: out = {route (0 fma, 1 mma, 2 wgmma_split), splits,
// keys a split, workspace bytes}. The launch takes a
// workspace of at least that many bytes (null when 0).
extern "C" int paged_attention_plan(int B, int Sq, int H, int KV, int D,
                                    int page, int npages, int P, int dtype,
                                    long long* out) {
  Args a{};
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.page = page;
  a.npages = npages;
  a.P = P;
  const HostPlan h = plan_for(a, dtype);
  out[0] = h.route;
  out[1] = h.nsplit;
  out[2] = h.route == kRouteWgmma ? kSplitKeys : 0;
  out[3] = h.ws_bytes;
  return 0;
}

extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* seq_lens, void* out, void* ws, int B,
    int Sq, int H, int KV, int D, int page, int npages, int tbl_stride, int P,
    float scale, int dtype, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
         static_cast<const int*>(starts), static_cast<const int*>(seq_lens),
         out, B, Sq, H, KV, D, page, npages, tbl_stride, P, 0, scale};
  return run_paged(a, dtype, static_cast<float*>(ws), stream);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* ws, int B, int Sq, int H, int KV,
    int D, int page, int npages, int tbl_stride, int P, float scale,
    int dtype, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
         static_cast<const int*>(lengths), nullptr, out, B, Sq, H, KV, D,
         page, npages, tbl_stride, P, 0, scale};
  return run_paged(a, dtype, static_cast<float*>(ws), stream);
}

// K6: q [B, Sq, H, D] at offsets[b] .. offsets[b] + Sq - 1 against the
// contiguous caches [B, KV, M, D]
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* offsets, void* out, int B,
                                       int Sq, int H, int KV, int D, int M,
                                       float scale, int dtype,
                                       void* stream) {
  Args a{q, k_cache, v_cache, nullptr, static_cast<const int*>(offsets),
         nullptr, out, B, Sq, H, KV, D, 0, 0, 0, 0, M, scale};
  return run<true>(a, dtype, stream);
}
