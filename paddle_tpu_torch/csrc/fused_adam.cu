// K8: multi-tensor Adam / AdamW update with global-norm clipping and the
// AMP loss-scale protocol, for Hopper (sm_90a).
//
// A port-only kernel: the JAX package gets this fusion from XLA, which
// compiles paddle_tpu/optimizer/__init__.py Optimizer._fused_update
// (:211, the "multi-tensor fused path") into one executable, and inside
// ParallelEngine.train_step also the AMP protocol around it
// (paddle_tpu/distributed/engine.py:843-932). No pallas_call is replaced.
//
// What it computes, for every tensor i of a list (any shapes):
//   g  = (g.f32 * inv).astype(dtype)       unscale (inv = 1/scale, or 1)
//   g  = (g.f32 * coef).astype(dtype)      clip, coef = min(clip / max(norm,
//                                          1e-6), 1), norm over all the
//                                          unscaled gradients together
//   pf = master or p.f32
//   Adam:  g += wd*p (or wd*sign(p))       when the tensor decays
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   upd = (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
//   AdamW: upd += wd*p (or wd*sign(p))     when the tensor decays
//   p' = pf - lr*upd -> master (f32), p (its dtype), m, v (state dtype)
// Every operation rounds as the JAX package's f32 arithmetic does: each
// product, sum and quotient is one IEEE round-to-nearest step
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc would otherwise
// contract a*b+c into one FMA, which rounds once), and 1-b^t takes the
// power in double, rounded to f32, as the plain version does. Under a
// scaler (amp_scale set) a step whose raw gradients hold an inf or nan
// writes nothing, and the step count t and the scale follow the JAX
// engine's bookkeeping, all on the device.
//
// Bound on this card: bytes. At the main path's shape (1.881 B bf16
// parameters with f32 masters and moments) each element moves 30 bytes:
// the reduction reads g (2), the update reads g, master, m, v (2+4+4+4)
// and writes master, m, v, p (4+4+4+2); 56.4 GB, 16.8 ms at 3.35 TB/s.
// The arithmetic (~30 flops and three IEEE divisions an element) stays
// well below that.
//
// Design: three launches on PyTorch's stream, no host read between them.
//  1. reduce_kernel: one block of 256 threads per chunk of 64 K elements
//     of one tensor (a chunk table cached per parameter set); sum of
//     squares of the unscaled gradient in f32 and a nonfinite flag,
//     one partial per chunk, reduced in a fixed order inside the block.
//  2. finalize_kernel: one block sums the partials in a fixed order (two
//     runs give the same norm bit for bit), computes norm, coef, the
//     found flag, the bias corrections and the scaler's bookkeeping, and
//     writes them to a small workspace and the outputs.
//  3. update_kernel: one block per chunk; returns at once when found is
//     set; otherwise every thread streams groups of 8 elements with
//     16-byte loads and stores (two for an f32 group), neighbouring
//     threads on neighbouring groups, and updates them in place.
// The tensor table (pointers, sizes, dtype and flags) is copied to the
// device each step: gradients are reallocated after clear_grad.
//
// Under tensor parallelism (phase 1, then 2) the norm crosses ranks: the
// squared sum of a rank's shards of split tensors must be summed over its
// model-parallel group before the finalize, and the overflow flag taken
// over every rank. Phase 1 runs the reduce and a finalize that writes
// sums[0] (the sharded tensors' squared sum), sums[1] (the replicated
// ones') and sums[2] (the nonfinite flag) and stops; the caller
// all-reduces sums[0] over the mp group (and sums[2], max, over the
// world); phase 2 finalizes from sums[0] + sums[1] and updates. Phase 0,
// the degree-1 step, is the three launches above, unchanged.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 65536;
constexpr int kThreads = 256;
constexpr int kVec = 8;

enum { F32 = 0, BF16 = 1, F16 = 2 };

// one row of the tensor table: pointers as integers, the element count,
// and code = param dtype | has_master << 8 | decays << 9 | mp shard << 10
struct Desc {
  long long p, g, master, m, v, n, code;
};

struct Args {
  const Desc* descs;
  const int2* chunks;      // (tensor, chunk index within the tensor)
  float* partial;          // [n_chunks] sum of squares
  int* flags;              // [n_chunks] nonfinite
  float* scalars;          // [8] coef, inv, bc1, bc2, found
  float* out;              // [2] norm, found
  float* amp_scale;        // [1] or null
  int* amp_counts;         // [3] good, bad, applied step, or null
  const float* pre_found;  // [1] or null
  float* sums;             // [3] phases 1-2: sharded ss, replicated ss, bad
  float lr, beta1, beta2, c1, c2, eps, wd, clip, incr_ratio, decr_ratio,
      scale_cap;
  int n_chunks, l1, decoupled, step, reduce, unscale, dynamic, incr_every,
      decr_every, state_dtype, phase;
};

template <int DT>
struct IO;

template <>
struct IO<F32> {
  __device__ static void load8(long long base, long long i, float* f) {
    const float4* q = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + i);
    const float4 a = q[0], b = q[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ static void store8(long long base, long long i, const float* f) {
    float4* q = reinterpret_cast<float4*>(reinterpret_cast<float*>(base) + i);
    q[0] = make_float4(f[0], f[1], f[2], f[3]);
    q[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ static float load1(long long base, long long i) {
    return reinterpret_cast<const float*>(base)[i];
  }
  __device__ static void store1(long long base, long long i, float f) {
    reinterpret_cast<float*>(base)[i] = f;
  }
  __device__ static float round(float f) { return f; }
};

template <>
struct IO<BF16> {
  using T = __nv_bfloat16;
  __device__ static void load8(long long base, long long i, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const T*>(base) + i);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = __bfloat162float(h[e]);
  }
  __device__ static void store8(long long base, long long i, const float* f) {
    uint4 u;
    T* h = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[e] = __float2bfloat16_rn(f[e]);
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(base) + i) = u;
  }
  __device__ static float load1(long long base, long long i) {
    return __bfloat162float(reinterpret_cast<const T*>(base)[i]);
  }
  __device__ static void store1(long long base, long long i, float f) {
    reinterpret_cast<T*>(base)[i] = __float2bfloat16_rn(f);
  }
  __device__ static float round(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
};

template <>
struct IO<F16> {
  using T = __half;
  __device__ static void load8(long long base, long long i, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const T*>(base) + i);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = __half2float(h[e]);
  }
  __device__ static void store8(long long base, long long i, const float* f) {
    uint4 u;
    T* h = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[e] = __float2half_rn(f[e]);
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(base) + i) = u;
  }
  __device__ static float load1(long long base, long long i) {
    return __half2float(reinterpret_cast<const T*>(base)[i]);
  }
  __device__ static void store1(long long base, long long i, float f) {
    reinterpret_cast<T*>(base)[i] = __float2half_rn(f);
  }
  __device__ static float round(float f) {
    return __half2float(__float2half_rn(f));
  }
};

// sum over the block in a fixed order: warp shuffles, then warp 0 over
// the warps' sums; every thread gets the total
__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  x = lane < nw ? red[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

template <int DT>
__device__ void reduce_chunk(const Desc& d, long long start, long long n,
                             float inv, float& ss, int& bad) {
  const long long full = n / kVec * kVec;
  for (long long j = (long long)threadIdx.x * kVec; j < full;
       j += (long long)kThreads * kVec) {
    float g[kVec];
    IO<DT>::load8(d.g, start + j, g);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bad |= !isfinite(g[e]);
      const float u = IO<DT>::round(__fmul_rn(g[e], inv));
      ss += u * u;
    }
  }
  for (long long j = full + threadIdx.x; j < n; j += kThreads) {
    const float g = IO<DT>::load1(d.g, start + j);
    bad |= !isfinite(g);
    const float u = IO<DT>::round(__fmul_rn(g, inv));
    ss += u * u;
  }
}

__global__ void __launch_bounds__(kThreads) reduce_kernel(Args a) {
  __shared__ float red[32];
  const int2 c = a.chunks[blockIdx.x];
  const Desc d = a.descs[c.x];
  const long long start = (long long)c.y * kChunk;
  const long long n = min((long long)kChunk, d.n - start);
  const float inv = (a.amp_scale && a.unscale)
                        ? __fdiv_rn(1.f, *a.amp_scale) : 1.f;
  float ss = 0.f;
  int bad = 0;
  switch (d.code & 0xff) {
    case F32: reduce_chunk<F32>(d, start, n, inv, ss, bad); break;
    case BF16: reduce_chunk<BF16>(d, start, n, inv, ss, bad); break;
    default: reduce_chunk<F16>(d, start, n, inv, ss, bad); break;
  }
  ss = block_sum(ss, red);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    a.partial[blockIdx.x] = ss;
    a.flags[blockIdx.x] = bad;
  }
}

__global__ void finalize_kernel(Args a) {
  __shared__ float red[32];
  float s = 0.f, sh = 0.f;  // sh: the mp shards' partials (phase 1)
  int bad = 0;
  if (a.reduce && a.phase != 2) {
    for (int i = threadIdx.x; i < a.n_chunks; i += blockDim.x) {
      if (a.phase == 1 && ((a.descs[a.chunks[i].x].code >> 10) & 1))
        sh += a.partial[i];
      else
        s += a.partial[i];
      bad |= a.flags[i];
    }
  }
  s = block_sum(s, red);
  if (a.phase == 1) {
    sh = block_sum(sh, red);
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      a.sums[0] = sh;
      a.sums[1] = s;
      a.sums[2] = bad ? 1.f : 0.f;
    }
    return;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x != 0) return;
  if (a.phase == 2) {
    // the mp group's shards' sum (all-reduced by the caller) + this
    // rank's replicated tensors' sum; the flag maxed over every rank
    s = __fadd_rn(a.sums[0], a.sums[1]);
    bad = a.sums[2] > 0.f;
  }
  if (a.pre_found) bad |= *a.pre_found > 0.f;
  const float norm = __fsqrt_rn(s);
  float coef = 1.f;
  if (a.clip > 0.f) coef = fminf(__fdiv_rn(a.clip, fmaxf(norm, 1e-6f)), 1.f);
  float inv = 1.f;
  int t = a.step;
  if (a.amp_scale) {
    const float scale = *a.amp_scale;
    if (a.unscale) inv = bad ? 0.f : __fdiv_rn(1.f, scale);
    int* cnt = a.amp_counts;
    const int good = cnt[0], badc = cnt[1];
    t = cnt[2] + (bad ? 0 : 1);
    float scale2;
    int good2, bad2;
    if (a.dynamic) {
      const int bad1 = bad ? badc + 1 : 0;
      const int good1 = bad ? 0 : good + 1;
      const bool dec = bad && bad1 >= a.decr_every;
      const float scale1 =
          dec ? fmaxf(__fmul_rn(scale, a.decr_ratio), 1.f) : scale;
      bad2 = dec ? 0 : bad1;
      const bool inc = !bad && good1 >= a.incr_every;
      scale2 = fminf(inc ? __fmul_rn(scale1, a.incr_ratio) : scale1,
                     a.scale_cap);
      good2 = inc ? 0 : good1;
    } else {
      scale2 = scale;
      good2 = bad ? 0 : good + 1;
      bad2 = bad ? badc + 1 : 0;
    }
    *a.amp_scale = scale2;
    cnt[0] = good2;
    cnt[1] = bad2;
    cnt[2] = t;
  }
  const float p1 = (float)pow((double)a.beta1, (double)t);
  const float p2 = (float)pow((double)a.beta2, (double)t);
  a.scalars[0] = coef;
  a.scalars[1] = inv;
  a.scalars[2] = __fsub_rn(1.f, p1);
  a.scalars[3] = __fsub_rn(1.f, p2);
  // only a scaler skips a step; without one nonfinite values flow on
  const float found = (bad && a.amp_scale) ? 1.f : 0.f;
  a.scalars[4] = found;
  a.out[0] = norm;
  a.out[1] = found;
}

struct Step {
  float inv, coef, bc1, bc2, lr, b1, b2, c1, c2, eps, wd;
  bool decay, l1, decoupled;
};

template <int PD>
__device__ __forceinline__ void adam_elem(const Step& s, float g, float& p,
                                          float& m, float& v) {
  g = IO<PD>::round(__fmul_rn(g, s.inv));
  g = IO<PD>::round(__fmul_rn(g, s.coef));
  float dt = 0.f;
  if (s.decay) {
    const float base = s.l1 ? (float)((p > 0.f) - (p < 0.f)) : p;
    dt = __fmul_rn(s.wd, base);
    if (!s.decoupled) g = __fadd_rn(g, dt);
  }
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.c2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fdiv_rn(m, s.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (s.decay && s.decoupled) upd = __fadd_rn(upd, dt);
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

template <int PD, int SD, bool MASTER>
__device__ void update_chunk(const Desc& d, long long start, long long n,
                             const Step& s) {
  const long long pw = MASTER ? d.master : d.p;
  const long long full = n / kVec * kVec;
  for (long long j = (long long)threadIdx.x * kVec; j < full;
       j += (long long)kThreads * kVec) {
    const long long i = start + j;
    float g[kVec], p[kVec], m[kVec], v[kVec];
    IO<PD>::load8(d.g, i, g);
    if (MASTER) IO<F32>::load8(pw, i, p); else IO<PD>::load8(pw, i, p);
    IO<SD>::load8(d.m, i, m);
    IO<SD>::load8(d.v, i, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) adam_elem<PD>(s, g[e], p[e], m[e], v[e]);
    if (MASTER) IO<F32>::store8(d.master, i, p);
    IO<PD>::store8(d.p, i, p);
    IO<SD>::store8(d.m, i, m);
    IO<SD>::store8(d.v, i, v);
  }
  for (long long j = full + threadIdx.x; j < n; j += kThreads) {
    const long long i = start + j;
    float p = MASTER ? IO<F32>::load1(pw, i) : IO<PD>::load1(pw, i);
    float m = IO<SD>::load1(d.m, i), v = IO<SD>::load1(d.v, i);
    adam_elem<PD>(s, IO<PD>::load1(d.g, i), p, m, v);
    if (MASTER) IO<F32>::store1(d.master, i, p);
    IO<PD>::store1(d.p, i, p);
    IO<SD>::store1(d.m, i, m);
    IO<SD>::store1(d.v, i, v);
  }
}

template <int SD>
__global__ void __launch_bounds__(kThreads) update_kernel(Args a) {
  if (a.scalars[4] > 0.f) return;  // overflow: a true no-op
  const int2 c = a.chunks[blockIdx.x];
  const Desc d = a.descs[c.x];
  const long long start = (long long)c.y * kChunk;
  const long long n = min((long long)kChunk, d.n - start);
  Step s;
  s.coef = a.scalars[0];
  s.inv = a.scalars[1];
  s.bc1 = a.scalars[2];
  s.bc2 = a.scalars[3];
  s.lr = a.lr; s.b1 = a.beta1; s.b2 = a.beta2; s.c1 = a.c1; s.c2 = a.c2;
  s.eps = a.eps; s.wd = a.wd;
  s.decay = (d.code >> 9) & 1;
  s.l1 = a.l1;
  s.decoupled = a.decoupled;
  const bool master = (d.code >> 8) & 1;
  switch (d.code & 0xff) {
    case F32:
      if (master) update_chunk<F32, SD, true>(d, start, n, s);
      else update_chunk<F32, SD, false>(d, start, n, s);
      break;
    case BF16:
      if (master) update_chunk<BF16, SD, true>(d, start, n, s);
      else update_chunk<BF16, SD, false>(d, start, n, s);
      break;
    default:
      if (master) update_chunk<F16, SD, true>(d, start, n, s);
      else update_chunk<F16, SD, false>(d, start, n, s);
      break;
  }
}

}  // namespace

// One K8 step: reduce (when clipping or under a scaler), finalize,
// update, all on `stream`; phase 1 the reduce and the split sums alone,
// phase 2 the finalize from them and the update (the header). Returns
// cudaGetLastError() after the launches. `args` points to a host struct
// Args (the ctypes mirror is _Args in ops/kernels/fused_adam.py).
extern "C" int fused_adam_launch(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.reduce && a.n_chunks > 0 && a.phase != 2) {
    reduce_kernel<<<a.n_chunks, kThreads, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_kernel<<<1, 1024, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.phase == 1) return static_cast<int>(e);
  if (a.n_chunks > 0) {
    if (a.state_dtype == 0)
      update_kernel<F32><<<a.n_chunks, kThreads, 0, s>>>(a);
    else
      update_kernel<BF16><<<a.n_chunks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
