// K4, K5 and K6: attention over a paged or contiguous KV cache for Hopper
// (sm_90a).
//
// Replaces three TPU kernels that share one body:
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
// K5 is K4 with seq_lens = Sq, and K6 is K5 with direct addressing, so all
// three entry points below launch the same two bodies; a null seq_lens
// pointer means "every slot live", a null table pointer "contiguous cache".
//
// Layouts: q and out [B, Sq, H, D]; k/v pools [P, KV, page, D]; block
// tables [B, >= npages] int32 with row stride tbl_stride; starts and
// seq_lens [B] int32. K6's caches are [B, KV, M, D]: key t of (b, kv) sits
// at ((b * KV + kv) * M + t) * D, and M (the caller's max length) need not
// be a multiple of the 8-key or 64-key steps, so every K6 load is bounded
// by M and keys past it are masked. Query head h reads KV head h / (H / KV)
// (GQA).
//
// Bound on this card: bytes at decode. Each (row, KV head) must read the
// K and V pages its frontier reaches once: sum over rows b of
// 2 * KV * (start_b + last_live_slot_b + 1) * D * itemsize, plus q and
// out once. The flops (4 * D per (q head, key) pair) are far below the
// tensor-core rate for decode; a long prefill chunk moves toward the
// compute side, which the bf16 tensor-core tile below takes on with
// mma.sync (wgmma, TMA and split-K are later work).
//
// Two bodies share the entry points. bf16 with at least 16 (slot,
// q-head) rows per KV head and D in {16, 32, 64, 128} -- prefill chunks
// and the unified step -- runs the tensor-core tile (mma.sync, below).
// Everything else -- decode rows, fp32, other head dims -- runs the FMA
// body described next.
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
// Tensor-core body: one CTA of 4 warps per (64 rows, KV head, batch
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it)
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* starts, const void* seq_lens, void* out, int B, int Sq, int H,
    int KV, int D, int page, int npages, int tbl_stride, float scale,
    int dtype, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
         static_cast<const int*>(starts), static_cast<const int*>(seq_lens),
         out, B, Sq, H, KV, D, page, npages, tbl_stride, 0, scale};
  return run<false>(a, dtype, stream);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int Sq, int H, int KV, int D,
    int page, int npages, int tbl_stride, float scale, int dtype,
    void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
         static_cast<const int*>(lengths), nullptr, out, B, Sq, H, KV, D,
         page, npages, tbl_stride, 0, scale};
  return run<false>(a, dtype, stream);
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
         nullptr, out, B, Sq, H, KV, D, 0, 0, 0, M, scale};
  return run<true>(a, dtype, stream);
}
