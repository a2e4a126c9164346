// K9: the int8 / int4 weight-only linear for Hopper (sm_90a).
//
// A port-only kernel. It replaces the fusion XLA makes of
// paddle_tpu/nn/quant.py weight_only_linear (:78): the int8 -> bf16 convert
// folded into the matmul's operand read, so no dequantized weight is ever
// written to device memory. There is no pallas_call to port.
//
//   y[r, n] = round_to(T)( (sum_k x[r, k] * q[n, k]) * scale[n] + bias[n] )
//
// x [M, K] (T = bf16 or f32), q int8 [N, K] or int4 packed two a byte into
// [N, K/2] (the even k in the low nibble), scale f32 [N], bias [N] (f32 or
// T) or none. The product runs over the INTEGER weights and accumulates in
// f32; the scale multiplies the sum, then the bias adds, each rounded on
// its own (__fmul_rn / __fadd_rn: no contraction into an FMA), then one
// rounding to T, as the JAX function and the plain version do.
//
// Bound on this card. Decode rows (M <= 16): bytes. The weights are read
// once: N*K bytes int8, N*K/2 int4, against 2*M*N*K flops; at [8, 4096] x
// [11008, 4096] int8 that is 45.4 MB, 13.5 us at 3.35 TB/s. Prefill and
// unified rows (M = 2048 .. 8192): operations, 2*M*N*K over 989 TFLOP/s
// bf16 (0.187 ms at [2048, 4096] x [11008, 4096]).
//
// Four bodies, chosen by the wrapper from the shapes and the pointers'
// alignment alone:
//
// gemv_kernel (bf16 x, M <= 16): a streaming pass over the weights on the
//   tensor cores. A block of 8 warps owns 64 output columns (an n8 tile a
//   warp) and one slice of K (split K). It stages its M x K-slice of x as
//   bf16 in shared memory with cp.async (zeros past M and K). Each lane
//   loads 16 bytes of one weight row per k block, a batch of 8 blocks at a
//   time (512 contiguous bytes a row), the next batch in flight while the
//   current one computes, and converts them exactly (the 2^23 magic number: a byte
//   permute and a subtraction, then the high halves, no I2F) into its
//   mma.sync m16n8k16 B fragments under a permutation of k that the A
//   fragments read from the staged x follow. Rows past M are zeros in the
//   16-row A tile; a weight is converted once whatever M is, so the pass
//   stays bound by the weight bytes. Sums stay in the C fragments; the
//   scale + bias epilogue runs there, or, with more than one K slice,
//   split_sum_kernel adds the slices' partial sums in slice order
//   (deterministic) and runs it.
// wgmma_kernel (bf16 x, M > 16, rows of a multiple of 16 bytes and
//   16-byte-aligned x and q, as TMA needs): y^T = W x^T on the tensor
//   cores, in 128 x 256 tiles of (weight rows, x rows), K in steps of 64.
//   TMA brings x's bf16 panel and the weight bytes into a ring of 4
//   slots (zeros past M, N and K: no masks on loads). The weights must
//   become bf16 before the tensor cores can take them; a bf16 GEMM does not
//   pay that conversion, and neither the ALU work nor shared-memory
//   traffic for it may stand between two wgmmas. So the weights are
//   wgmma's A operand, which Hopper reads from registers: each thread
//   converts its own A fragments (the same exact magic-number conversion)
//   straight from the raw bytes while the previous step's m64n256k16
//   wgmmas run. Converting into a bf16 tile in shared memory for every
//   warpgroup to read would add a 16 KB store, a proxy fence and a
//   block-wide barrier to every step and a third more shared-memory
//   traffic, and measured 20% slower (PERF.md).
// tile_kernel (bf16 x, M > 16 where TMA cannot address the operands):
//   128 x 128 output tiles, 8 warps of 64 x 32, K in steps of 64. cp.async
//   brings x's bf16 tile and the int8 (or packed int4) weight tile into a
//   3-stage ring; each step the block converts the weight tile exactly
//   into a bf16 tile in shared memory (every int8 and int4 value is exact
//   in bf16) and runs mma.sync m16n8k16 with f32 accumulators; scale and
//   bias in the epilogue.
// fma_kernel (f32 x, every M in groups of up to 16 rows; the parity path):
//   f32 FMAs, no TF32, so the card's fp32 results follow the CPU's. A
//   block of 4 warps owns 4*CPW columns and one K slice; it stages x as
//   f32 (each lane's 16- or 32-value chunk padded by 4 floats so a quarter
//   warp's float4 reads hit distinct banks); each warp streams its CPW
//   weight rows, converts them as above and does the FMAs; a halving
//   butterfly reduces the CPW x MR sums of a lane across the warp.
//
// Ragged M, N and K are masked (zero fill). In the gemv, tile and fma
// bodies, rows whose byte length is not a multiple of 16 (or unaligned
// pointers) take element-wise loads instead of 16-byte ones (the wrapper's
// `vec` flag); the wgmma body refuses them (cudaErrorInvalidValue: the
// wrapper routes such shapes to the tile body). Nothing routes around the
// kernel. The launch function returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// (acc * scale) + bias, each rounded once; bias_code -1 none, 0 f32, 1 bf16
__device__ __forceinline__ float epilogue(float acc, const float* scale,
                                          const void* bias, int bias_code,
                                          int n) {
  float y = __fmul_rn(acc, scale[n]);
  if (bias_code == 0)
    y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
  else if (bias_code == 1)
    y = __fadd_rn(y, __bfloat162float(static_cast<const bf16*>(bias)[n]));
  return y;
}

// -- exact integer -> f32 conversion -----------------------------------------
// 0x4B000000 is 2^23: a float whose low mantissa byte is u is 2^23 + u
constexpr uint32_t kMagic = 0x4B000000u;

__device__ __forceinline__ float magic(uint32_t bytes, int sel) {
  return __uint_as_float(__byte_perm(bytes, kMagic, 0x7540 | sel));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the 4 weights of group g (k = 4g .. 4g+3 of the 16 bytes in v), as f32
template <bool INT4>
__device__ __forceinline__ float4 group_f32(const uint4& v, int g) {
  if constexpr (!INT4) {
    // signed byte b -> b ^ 0x80 = b + 128 (unsigned); minus 2^23 + 128
    const uint32_t u = word(v, g) ^ 0x80808080u;
    return make_float4(magic(u, 0) - 8388736.f, magic(u, 1) - 8388736.f,
                       magic(u, 2) - 8388736.f, magic(u, 3) - 8388736.f);
  } else {
    // nibble s -> s ^ 8 = s + 8; byte j holds k = 2j (low), 2j + 1 (high)
    const uint32_t u = word(v, g >> 1) ^ 0x88888888u;
    const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
    const int b = (g & 1) * 2;
    return make_float4(magic(lo, b) - 8388616.f, magic(hi, b) - 8388616.f,
                       magic(lo, b + 1) - 8388616.f,
                       magic(hi, b + 1) - 8388616.f);
  }
}

// 16 bytes of row `row` of q from byte `off`; zeros past the row or N.
// vec: rows are a multiple of 16 bytes and q is 16-byte aligned
__device__ __forceinline__ uint4 load_q16(const int8_t* q, int row, int N,
                                          int off, int rowbytes, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row >= N || off >= rowbytes) return v;
  const int8_t* p = q + static_cast<size_t>(row) * rowbytes + off;
  if (vec) {
    // read once: no L1 allocation; the L2 fetches the 256 bytes around it,
    // so a row's next 16-byte pieces (other lanes, the next k blocks) hit
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
  uint32_t w[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16 && off + i < rowbytes; ++i)
    w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                 << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// -- warp reduction: V values a lane -> sums over the 32 lanes ---------------
// While more than one value is live, each stage keeps the half its lane bit
// selects and adds the partner's copy of that half; then plain xor sums.
// Afterwards lane l holds the sums of values (l * V) / 32 .. + max(V/32, 1).
template <int V, int O>
struct LaneReduce {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (V > 1) {
      constexpr int h = V / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      LaneReduce<h, O / 2>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      LaneReduce<1, O / 2>::run(v, lane);
    }
  }
};

template <int V>
struct LaneReduce<V, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const void* bias;
  void* out;
  float* work;     // [splits, M, N] partial sums when splits > 1
  int M, N, K;
  int bias_code;
  int splits;
  int ks;          // K a slice covers (gemv)
  int vec;
};

// -- fma body (f32 x) -----------------------------------------------------------------
constexpr int kFmaWarps = 4;
constexpr int kFmaThreads = 32 * kFmaWarps;

template <int MR>
struct Fma {
  static constexpr int CPW = MR >= 16 ? 4 : 8;   // columns a warp
  static constexpr int COLS = kFmaWarps * CPW;  // columns a block
};

template <bool INT4>
struct Pack {
  static constexpr int W = INT4 ? 32 : 16;  // weights in a lane's 16 bytes
  static constexpr int STEP = 32 * W;       // k a warp covers per step
  static constexpr int LP = W + 4;          // padded floats a lane chunk
};

template <int MR, bool INT4>
__global__ void __launch_bounds__(kFmaThreads)
    fma_kernel(const Args a) {
  constexpr int CPW = Fma<MR>::CPW;
  constexpr int W = Pack<INT4>::W, STEP = Pack<INT4>::STEP,
                LP = Pack<INT4>::LP;
  constexpr int V = CPW * MR;
  extern __shared__ __align__(16) float fma_smem[];
  float* xs = fma_smem;  // [MR][ks / W][LP]
  const float* x = static_cast<const float*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.z * MR;
  const int k0 = blockIdx.y * a.ks;
  const int nk = min(a.ks, a.K - k0);
  const int nsteps = (nk + STEP - 1) / STEP;
  const int pitch = (a.ks / W) * LP;
  const int nbase = (blockIdx.x * kFmaWarps + warp) * CPW;
  const int rowbytes = INT4 ? a.K / 2 : a.K;
  const bool vec = a.vec;
  const int lane_k = lane * W;  // this lane's first k inside a step

  // the first step's weights are in flight while x is staged
  uint4 nxt[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
    nxt[c] = load_q16(a.q, nbase + c, a.N,
                      (INT4 ? (k0 + lane_k) / 2 : k0 + lane_k), rowbytes, vec);

  const int span = nsteps * STEP;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r = r0 + m;
    for (int kk = threadIdx.x; kk < span; kk += kFmaThreads) {
      const int k = k0 + kk;
      float v = 0.f;
      if (r < a.M && kk < nk) v = x[static_cast<size_t>(r) * a.K + k];
      xs[m * pitch + (kk / W) * LP + (kk % W)] = v;
    }
  }
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    uint4 cur[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) cur[c] = nxt[c];
    if (s + 1 < nsteps) {
      const int k = k0 + (s + 1) * STEP + lane_k;
#pragma unroll
      for (int c = 0; c < CPW; ++c)
        nxt[c] = load_q16(a.q, nbase + c, a.N, INT4 ? k / 2 : k, rowbytes,
                          vec);
    }
    const float* xl = xs + ((s * STEP + lane_k) / W) * LP;
#pragma unroll
    for (int g = 0; g < W / 4; ++g) {
      float4 wf[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) wf[c] = group_f32<INT4>(cur[c], g);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xl + m * pitch +
                                                           4 * g);
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          float t = acc[c * MR + m];
          t = fmaf(wf[c].x, xv.x, t);
          t = fmaf(wf[c].y, xv.y, t);
          t = fmaf(wf[c].z, xv.z, t);
          t = fmaf(wf[c].w, xv.w, t);
          acc[c * MR + m] = t;
        }
      }
    }
  }

  LaneReduce<V, 16>::run(acc, lane);
  constexpr int HELD = V >= 32 ? V / 32 : 1;
  if (V < 32 && ((lane * V) & 31)) return;
  const int first = (lane * V) >> 5;
#pragma unroll
  for (int i = 0; i < HELD; ++i) {
    const int v = first + i;
    const int n = nbase + v / MR, r = r0 + v % MR;
    if (n >= a.N || r >= a.M) continue;
    const size_t o = static_cast<size_t>(r) * a.N + n;
    if (a.splits > 1)
      a.work[static_cast<size_t>(blockIdx.y) * a.M * a.N + o] = acc[i];
    else
      static_cast<float*>(a.out)[o] =
          epilogue(acc[i], a.scale, a.bias, a.bias_code, n);
  }
}

// the K slices' partial sums, added in slice order, then the epilogue
template <typename T>
__global__ void split_sum_kernel(const Args a) {
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = a.work[i];
  for (int s = 1; s < a.splits; ++s) acc += a.work[s * mn + i];
  const int n = static_cast<int>(i % a.N);
  store(static_cast<T*>(a.out) + i,
        epilogue(acc, a.scale, a.bias, a.bias_code, n));
}

template <int MR, bool INT4>
cudaError_t launch_fma_mr(const Args& a, cudaStream_t s) {
  const int smem = MR * (a.ks / Pack<INT4>::W) * Pack<INT4>::LP * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fma_kernel<MR, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + Fma<MR>::COLS - 1) / Fma<MR>::COLS, a.splits,
            (a.M + MR - 1) / MR);
  fma_kernel<MR, INT4><<<grid, kFmaThreads, smem, s>>>(a);
  if (a.splits > 1) {
    const size_t mn = static_cast<size_t>(a.M) * a.N;
    split_sum_kernel<float><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                          s>>>(a);
  }
  return cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_fma(const Args& a, int mr, cudaStream_t s) {
  switch (mr) {
    case 1: return launch_fma_mr<1, INT4>(a, s);
    case 4: return launch_fma_mr<4, INT4>(a, s);
    case 8: return launch_fma_mr<8, INT4>(a, s);
    case 16: return launch_fma_mr<16, INT4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- tile body (bf16 x, M > 16) ----------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kTileThreads = 256;
constexpr int kAP = kBK + 8;  // padded bf16 pitch: fragment reads conflict-free

template <bool INT4>
struct Tile {
  static constexpr int QB = INT4 ? kBK / 2 : kBK;  // weight bytes a row a step
  static constexpr int A_BYTES = kStages * kBM * kAP * 2;
  static constexpr int Q_BYTES = kStages * kBN * QB;
  static constexpr int D_BYTES = kBN * kAP * 2;
  static constexpr int smem = A_BYTES + Q_BYTES + D_BYTES;
};

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two exact small-integer floats -> one bf16x2 word (their high halves)
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <bool INT4>
__device__ __forceinline__ void load_stage(const Args& a, bf16* As,
                                           uint8_t* Bq, int m0, int n0,
                                           int kt) {
  constexpr int QB = Tile<INT4>::QB;
  const bf16* x = static_cast<const bf16*>(a.x);
  const int k = kt * kBK;
  const int rowbytes = INT4 ? a.K / 2 : a.K;
  const int kb = INT4 ? k / 2 : k;
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kTileThreads) {
    const int r = i / (kBK / 8), ch = i % (kBK / 8);
    const int gr = m0 + r, gk = k + ch * 8;
    bf16* dst = As + r * kAP + ch * 8;
    if (a.vec) {
      const bool ok = gr < a.M && gk < a.K;
      cp_async16(dst, ok ? x + static_cast<size_t>(gr) * a.K + gk : x, ok);
    } else {
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < a.M && gk + e < a.K)
                     ? x[static_cast<size_t>(gr) * a.K + gk + e]
                     : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < kBN * (QB / 16); i += kTileThreads) {
    const int r = i / (QB / 16), ch = i % (QB / 16);
    const int gn = n0 + r, gb = kb + ch * 16;
    uint8_t* dst = Bq + r * QB + ch * 16;
    const int8_t* src = a.q + static_cast<size_t>(gn) * rowbytes + gb;
    if (a.vec) {
      const bool ok = gn < a.N && gb < rowbytes;
      cp_async16(dst, ok ? src : a.q, ok);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gn < a.N && gb + e < rowbytes)
                     ? static_cast<uint8_t>(src[e])
                     : 0;
    }
  }
}

template <bool INT4>
__global__ void __launch_bounds__(kTileThreads, 2) tile_kernel(const Args a) {
  constexpr int QB = Tile<INT4>::QB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  uint8_t* Bq = smem + Tile<INT4>::A_BYTES;
  bf16* Bd = reinterpret_cast<bf16*>(smem + Tile<INT4>::A_BYTES +
                                     Tile<INT4>::Q_BYTES);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (a.K + kBK - 1) / kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles)
      load_stage<INT4>(a, As + st * kBM * kAP, Bq + st * kBN * QB, m0, n0,
                       st);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; step kt - 1 is done with its tiles
    const int nx = kt + kStages - 1;
    if (nx < ktiles)
      load_stage<INT4>(a, As + (nx % kStages) * kBM * kAP,
                       Bq + (nx % kStages) * kBN * QB, m0, n0, nx);
    cp_async_commit();

    // the weight tile -> bf16: thread t converts 32 values of row t / 2
    {
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      const uint8_t* src = Bq + (kt % kStages) * kBN * QB + r * QB;
      uint4* dst = reinterpret_cast<uint4*>(Bd + r * kAP + half * 32);
      uint4 raw[2];
      if constexpr (INT4) {
        raw[0] = *reinterpret_cast<const uint4*>(src + half * 16);
      } else {
        raw[0] = *reinterpret_cast<const uint4*>(src + half * 32);
        raw[1] = *reinterpret_cast<const uint4*>(src + half * 32 + 16);
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) {  // 8 weights -> one 16-byte store
        const uint4& v = raw[INT4 ? 0 : o >> 1];
        const int g0 = INT4 ? 2 * o : 2 * (o & 1);
        const float4 f0 = group_f32<INT4>(v, g0);
        const float4 f1 = group_f32<INT4>(v, g0 + 1);
        dst[o] = make_uint4(pack_hi(f0.x, f0.y), pack_hi(f0.z, f0.w),
                            pack_hi(f1.x, f1.y), pack_hi(f1.z, f1.w));
      }
    }
    __syncthreads();

    const bf16* At = As + (kt % kStages) * kBM * kAP;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int kb = ks * 16 + 2 * t;
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = At + (wm * 64 + i * 16 + g) * kAP + kb;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAP);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAP + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = Bd + (wn * 32 + j * 8 + g) * kAP + kb;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
      if (n >= a.N) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * 64 + i * 16 + g + 8 * h;
          if (r < a.M)
            store(out + static_cast<size_t>(r) * a.N + n,
                  epilogue(acc[i][j][2 * h + e], a.scale, a.bias,
                           a.bias_code, n));
        }
      }
    }
  }
}

template <bool INT4>
cudaError_t launch_tile(const Args& a, cudaStream_t s) {
  constexpr int smem = Tile<INT4>::smem;
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  tile_kernel<INT4><<<grid, kTileThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// -- wgmma body (bf16 x, M > 16, operands TMA can address) -------------------
// The product runs transposed, y^T tile = W tile x^T, so that the weights
// are wgmma's A operand, which may come from registers: each thread
// converts its own weights straight from the raw bytes into A-fragment
// registers, and no converted tile is written to shared memory, read back
// by every warpgroup, or fenced and guarded by a barrier.
//
// One CTA: 128 weight rows (two warpgroups of 64) x 256 x rows (wgmma's
// n), K in steps of 64. A ring of kWgStages slots holds, per step, the x
// panel [256, 64] (bf16, 128-byte swizzle, K-major: wgmma's B as TMA
// writes it) and the weight bytes [128, 64] int8 (64-byte swizzle) or
// [128, 32] int4 (32-byte swizzle), both brought by TMA (zeros past M, N
// and K). Each step, every thread:
//
//   issues wgmma(kt)        m64n256k16 x 4, A = fragments `cur`
//   waits for wgmma(kt - 1) its fragments `nxt` and its ring slot are free
//   barrier                 then thread 0 refills the slot of step kt - 1
//                           with step kt + kWgStages - 1
//   converts step kt + 1    raw bytes -> `nxt`, while wgmma(kt) runs
//
// The accumulators hold y^T: thread (warp w, lane 4 g + t) of warpgroup
// wg has weight rows 64 wg + 16 w + g (+ 8) against x rows 8 j + 2 t (+ 1).
constexpr int kWgRows = 256;        // x rows a CTA (wgmma's n)
constexpr int kWgCols = 128;        // weight rows a CTA: 64 a warpgroup
constexpr int kWgThreads = 256;
constexpr int kWgStages = 4;        // ring slots of (x, weight bytes)
constexpr int kWgGroupRows = 2048;  // x rows a raster group keeps in L2

template <bool INT4>
struct Wg {
  static constexpr int QB = INT4 ? kBK / 2 : kBK;      // weight bytes a row
  static constexpr uint32_t XT = kWgRows * kBK * 2;    // x tile
  static constexpr uint32_t QT = kWgCols * QB;         // raw weight tile
  static constexpr int smem = kWgStages * (XT + QT) + kWgStages * 8 + 1024;
  static_assert(smem <= 232448, "wgmma body: shared memory over 227 KB");
};

struct WgParams {
  CUtensorMap tx, tq;  // x bf16 rows (swizzled panels), q byte rows
  Args a;
};

// the A fragments of one step (4 k16 blocks) for rows r0 and r0 + 8 of
// the raw weight tile (TMA's 64-byte swizzle for int8 rows of 64 bytes:
// 16-byte chunk c of row r at c ^ ((r >> 1) & 3); the 32-byte swizzle for
// int4 rows of 32: c ^ ((r >> 2) & 1)): f[kk] = {(r0, k 2t, 2t + 1), (r0 +
// 8, same), (r0, 2t + 8, 2t + 9), (r0 + 8, same)} of block kk, t = lane % 4,
// each pair converted exactly (group_f32's magic number) and packed to
// bf16x2. The 8 rows a warp reads at once fall in distinct banks.
template <bool INT4>
__device__ __forceinline__ void frag_step(const unsigned char* q, int r0,
                                          int tig, uint32_t (&f)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if constexpr (!INT4) {
      const int sel = 2 * (tig & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            q + r * 64 + ((kk ^ ((r >> 1) & 3)) << 4));
        // bytes 2t, 2t + 1 and 2t + 8, 2t + 9 of the block, as b + 128
        const uint32_t lo = ((tig >> 1) ? v.y : v.x) ^ 0x80808080u;
        const uint32_t hi = ((tig >> 1) ? v.w : v.z) ^ 0x80808080u;
        f[kk][h] = pack_hi(magic(lo, sel) - 8388736.f,
                           magic(lo, sel + 1) - 8388736.f);
        f[kk][h + 2] = pack_hi(magic(hi, sel) - 8388736.f,
                               magic(hi, sel + 1) - 8388736.f);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // a 16-byte chunk: blocks 2c, 2c + 1
        const uint4 v = *reinterpret_cast<const uint4*>(
            q + r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // byte t holds k = 2t (low nibble) and 2t + 1; byte 4 + t the
          // same 8 further on; nibble s as s + 8
          const uint32_t w0 = (e ? v.z : v.x) ^ 0x88888888u;
          const uint32_t w1 = (e ? v.w : v.y) ^ 0x88888888u;
          f[2 * c + e][h] =
              pack_hi(magic(w0 & 0x0F0F0F0Fu, tig) - 8388616.f,
                      magic((w0 >> 4) & 0x0F0F0F0Fu, tig) - 8388616.f);
          f[2 * c + e][h + 2] =
              pack_hi(magic(w1 & 0x0F0F0F0Fu, tig) - 8388616.f,
                      magic((w1 >> 4) & 0x0F0F0F0Fu, tig) - 8388616.f);
        }
      }
    }
  }
}

// keep A fragments in their registers until here: a wgmma reading them
// may still run
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

template <bool INT4>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ WgParams P) {
  using C = Wg<INT4>;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* xs = hopper::align1024(wg_smem_raw);  // [stages] x panels
  unsigned char* qs = xs + kWgStages * C::XT;          // [stages] raw bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + kWgStages * C::QT);
  const Args& a = P.a;
  // grouped raster: the CTAs in flight share a group's kWgGroupRows rows
  // of x (kept in L2) and walk the weight tiles, each read once a group
  constexpr int G = kWgGroupRows / kWgRows;
  const int mt = (a.M + kWgRows - 1) / kWgRows;
  const int nt = (a.N + kWgCols - 1) / kWgCols;
  const int g0 = static_cast<int>(blockIdx.x) / (G * nt) * G;
  const int gsz = min(mt - g0, G);
  const int local = static_cast<int>(blockIdx.x) % (G * nt);
  const int m0 = (g0 + local % gsz) * kWgRows, n0 = local / gsz * kWgCols;
  const int steps = (a.K + kBK - 1) / kBK;
  const int t = threadIdx.x;

  // step kt into its ring slot (thread 0 only)
  auto load = [&](int kt) {
    const int s = kt % kWgStages;
    hopper::mbar_arrive_tx(full + s, C::XT + C::QT);
    hopper::tma_load_4d(xs + s * C::XT, &P.tx, full + s, kt * kBK, 0, m0, 0);
    hopper::tma_load_2d(qs + s * C::QT, &P.tq, full + s, kt * C::QB, n0);
  };
  if (t == 0) {
    for (int s = 0; s < kWgStages; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_fence_init();
    for (int kt = 0; kt < min(steps, kWgStages - 1); ++kt) load(kt);
  }
  __syncthreads();

  const int wg = t >> 7, w = (t & 127) >> 5;
  const int grp = (t & 31) >> 2, tig = t & 3;
  const int r0 = wg * 64 + 16 * w + grp;  // this thread's weight rows r0, +8
  float acc[2 * kWgRows / 4];
  hopper::zero(acc);
  uint32_t fa[4][4], fb[4][4];
  hopper::mbar_wait(full, 0);
  frag_step<INT4>(qs, r0, tig, fa);

  auto step = [&](int kt, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
    const bf16* xt =
        reinterpret_cast<const bf16*>(xs + (kt % kWgStages) * C::XT);
    hopper::fence_operand(acc);
    fence_frag(cur);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_rs256(acc, cur[kk], hopper::kmajor(xt, kWgRows, 0, kk),
                          kt > 0 || kk > 0);
    hopper::wgmma_commit();
    hopper::fence_operand(acc);
    hopper::wgmma_wait<1>();
    fence_frag(nxt);
    hopper::fence_operand(acc);
    if (kt + kWgStages - 1 < steps) {
      __syncthreads();  // every warp is past wgmma(kt - 1)
      if (t == 0) load(kt + kWgStages - 1);
    }
    if (kt + 1 < steps) {
      const int s1 = (kt + 1) % kWgStages;
      hopper::mbar_wait(full + s1, ((kt + 1) / kWgStages) & 1);
      frag_step<INT4>(qs + s1 * C::QT, r0, tig, nxt);
    }
  };
  for (int kt = 0; kt < steps; kt += 2) {
    step(kt, fa, fb);
    if (kt + 1 < steps) step(kt + 1, fb, fa);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
  fence_frag(fa);
  fence_frag(fb);

  // acc[4 j + 2 hi + e]: weight row r0 + 8 hi (column n of y), x row 8 j +
  // 2 tig + e (row m of y)
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int n = n0 + r0 + 8 * hi;
    if (n >= a.N) continue;
    // epilogue()'s arithmetic with this column's scale and bias read once
    const float sc = a.scale[n];
    float bs = 0.f;
    if (a.bias_code == 0)
      bs = static_cast<const float*>(a.bias)[n];
    else if (a.bias_code == 1)
      bs = __bfloat162float(static_cast<const bf16*>(a.bias)[n]);
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tig + e;
        if (m >= a.M) continue;
        float y = __fmul_rn(acc[4 * j + 2 * hi + e], sc);
        if (a.bias_code >= 0) y = __fadd_rn(y, bs);
        store(out + static_cast<size_t>(m) * a.N + n, y);
      }
  }
}

// the wgmma body's launch: K a multiple of 16 (int8) or 32 (int4), so every
// row is a multiple of 16 bytes, and x and q 16-byte aligned (the tensor
// maps refuse anything else)
template <bool INT4>
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  using C = Wg<INT4>;
  WgParams p{};
  p.a = a;
  const int rowbytes = INT4 ? a.K / 2 : a.K;
  if (a.K % (INT4 ? 32 : 16) ||
      !hopper_host::encode_rows(&p.tx, a.x, 1, a.M, 1, a.K, kWgRows) ||
      !hopper_host::encode_u8_rows(&p.tq, a.q, a.N, rowbytes, kWgCols, C::QB,
                                   INT4 ? CU_TENSOR_MAP_SWIZZLE_32B
                                        : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((a.M + kWgRows - 1) / kWgRows) *
                    ((a.N + kWgCols - 1) / kWgCols);
  wgmma_kernel<INT4><<<tiles, kWgThreads, C::smem, s>>>(p);
  return cudaGetLastError();
}

// -- gemv body (bf16 x, M <= 16) ---------------------------------------------
// Tensor cores with the weights converted in registers: a lane's 16 loaded
// bytes (16 int8 or 32 int4 weights of one row) are its B fragments of 4
// (8) m16n8k16 steps under a permutation of k that the A fragments follow.
// Lane (g, t) = (lane / 4, lane % 4) holds row n0 + g at k = kb + W t .. +W,
// W = 16 (int8) or 32 (int4); in step i its fragment pairs (2t, 2t + 1)
// and (2t + 8, 2t + 9) are k = kb + W t + 4i + {0, 1} and + {2, 3}, so it
// reads x rows g and g + 8 at the same k. A k block is KB = 4 W: the 4
// lanes of a row cover it. Loads go out a batch of kGemvBatch k blocks at
// a time (512 contiguous bytes of each of the warp's 8 rows), the next
// batch in flight while the current one computes.
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvCols = kGemvWarps * 8;   // one n8 tile a warp
constexpr int kGemvBatch = 8;               // k blocks a batch

template <bool INT4>
struct GemvPack {
  static constexpr int W = INT4 ? 32 : 16;   // weights a lane a k block
  static constexpr int KB = 4 * W;           // k a block covers
  static constexpr int STEPS = W / 4;        // mma steps a k block
};

// bf16 pitch of a staged x row: ks + 8, so consecutive rows start 16 bytes
// apart modulo 128 and a quarter warp's 16-byte reads of rows g, g + 1 hit
// distinct banks
__device__ __forceinline__ int gemv_pitch(int ks) { return ks + 8; }

// 16-byte chunk p of a staged row lies at chunk p ^ swz(p): with int4 a lane
// reads chunks 4t .. 4t + 3 of a 128-k block, and t >= 2 would otherwise
// share banks with t - 2
template <bool INT4>
__device__ __forceinline__ int gemv_chunk(int p) {
  return INT4 ? p ^ (((p >> 3) & 1) << 1) : p;
}

// the weights of k blocks b * kGemvBatch .. + kGemvBatch of row n (zeros
// past the slice)
template <bool INT4>
__device__ __forceinline__ void gemv_load(uint4 (&w)[kGemvBatch],
                                          const Args& a, int n, int k0,
                                          int t, int b, int nkb) {
  using P = GemvPack<INT4>;
  const int rowbytes = INT4 ? a.K / 2 : a.K;
#pragma unroll
  for (int d = 0; d < kGemvBatch; ++d) {
    const int kb = b * kGemvBatch + d;
    const int k = k0 + kb * P::KB + P::W * t;
    w[d] = kb < nkb ? load_q16(a.q, n, a.N, INT4 ? k / 2 : k, rowbytes,
                               a.vec)
                    : make_uint4(0, 0, 0, 0);
  }
}

template <int MR, bool INT4>
__device__ __forceinline__ void gemv_batch(float (&acc)[4],
                                           const uint4 (&w)[kGemvBatch],
                                           const bf16* xs, int pitch, int g,
                                           int t, int b, int nkb) {
  using P = GemvPack<INT4>;
#pragma unroll
  for (int d = 0; d < kGemvBatch; ++d) {
    const int kb = b * kGemvBatch + d;
    if (kb >= nkb) break;
    // A: this lane's W values of rows g and g + 8 (16-byte reads)
    uint32_t xa[2][P::W / 2];
#pragma unroll
    for (int h = 0; h < P::W / 8; ++h) {
      const int c = gemv_chunk<INT4>(kb * (P::KB / 8) + (P::W / 8) * t + h);
      const uint4 lo = *reinterpret_cast<const uint4*>(xs + g * pitch + 8 * c);
      uint4 hi = make_uint4(0, 0, 0, 0);
      if constexpr (MR > 8)
        hi = *reinterpret_cast<const uint4*>(xs + (g + 8) * pitch + 8 * c);
      xa[0][4 * h] = lo.x;
      xa[0][4 * h + 1] = lo.y;
      xa[0][4 * h + 2] = lo.z;
      xa[0][4 * h + 3] = lo.w;
      xa[1][4 * h] = hi.x;
      xa[1][4 * h + 1] = hi.y;
      xa[1][4 * h + 2] = hi.z;
      xa[1][4 * h + 3] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < P::STEPS; ++i) {
      const float4 f = group_f32<INT4>(w[d], i);
      const uint32_t af[4] = {xa[0][2 * i], xa[1][2 * i], xa[0][2 * i + 1],
                              xa[1][2 * i + 1]};
      mma_bf16(acc, af, pack_hi(f.x, f.y), pack_hi(f.z, f.w));
    }
  }
}

template <int MR, bool INT4>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(const Args a) {
  using P = GemvPack<INT4>;
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  bf16* xs = reinterpret_cast<bf16*>(gemv_smem);   // [MR][ks + 8]
  const bf16* x = static_cast<const bf16*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * a.ks;
  const int nk = min(a.ks, a.K - k0);
  const int nkb = (nk + P::KB - 1) / P::KB;
  const int nbatch = (nkb + kGemvBatch - 1) / kGemvBatch;
  const int pitch = gemv_pitch(a.ks);
  const int n0 = blockIdx.x * kGemvCols + warp * 8;

  // the first batch of weights is in flight while x is staged
  uint4 wa[kGemvBatch], wb[kGemvBatch];
  gemv_load<INT4>(wa, a, n0 + g, k0, t, 0, nkb);

  // stage x rows 0 .. MR - 1, k0 .. k0 + nkb * KB (zeros past M and K)
  const int chunks = nkb * P::KB / 8;
  for (int i = threadIdx.x; i < MR * chunks; i += kGemvThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int k = k0 + 8 * c;
    bf16* dst = xs + r * pitch + 8 * gemv_chunk<INT4>(c);
    if (a.vec) {
      const bool ok = r < a.M && 8 * c < nk;
      cp_async16(dst, ok ? x + static_cast<size_t>(r) * a.K + k : x, ok);
    } else {
      for (int e = 0; e < 8; ++e)
        dst[e] = (r < a.M && 8 * c + e < nk)
                     ? x[static_cast<size_t>(r) * a.K + k + e]
                     : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < nbatch; b += 2) {
    if (b + 1 < nbatch) gemv_load<INT4>(wb, a, n0 + g, k0, t, b + 1, nkb);
    gemv_batch<MR, INT4>(acc, wa, xs, pitch, g, t, b, nkb);
    if (b + 1 < nbatch) {
      if (b + 2 < nbatch) gemv_load<INT4>(wa, a, n0 + g, k0, t, b + 2, nkb);
      gemv_batch<MR, INT4>(acc, wb, xs, pitch, g, t, b + 1, nkb);
    }
  }

  // C fragment: rows g and g + 8, columns 2t and 2t + 1 of the n8 tile
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1);
    const int n = n0 + 2 * t + (e & 1);
    if (r >= a.M || n >= a.N) continue;
    const size_t o = static_cast<size_t>(r) * a.N + n;
    if (a.splits > 1)
      a.work[static_cast<size_t>(blockIdx.y) * a.M * a.N + o] = acc[e];
    else
      store(static_cast<bf16*>(a.out) + o,
            epilogue(acc[e], a.scale, a.bias, a.bias_code, n));
  }
}

template <int MR, bool INT4>
cudaError_t launch_gemv_mr(const Args& a, cudaStream_t s) {
  const int smem = MR * (a.ks + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      gemv_kernel<MR, INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + kGemvCols - 1) / kGemvCols, a.splits);
  gemv_kernel<MR, INT4><<<grid, kGemvThreads, smem, s>>>(a);
  if (a.splits > 1) {
    const size_t mn = static_cast<size_t>(a.M) * a.N;
    split_sum_kernel<bf16><<<static_cast<unsigned>((mn + 255) / 256), 256,
                             0, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_gemv(const Args& a, int mr, cudaStream_t s) {
  if (mr == 8) return launch_gemv_mr<8, INT4>(a, s);
  if (mr == 16) return launch_gemv_mr<16, INT4>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dynamic shared memory of a launch (bytes): the fma body's staged f32 x,
// the tile body's ring and converted weight tile, the gemv body's staged
// bf16 x, the wgmma body's ring, converted tiles and barriers
extern "C" int weight_only_linear_smem(int body, int mr, int ks, int int4) {
  if (body == 1) return int4 ? Tile<true>::smem : Tile<false>::smem;
  if (body == 3) return int4 ? Wg<true>::smem : Wg<false>::smem;
  if (body == 2) return mr * (ks + 8) * 2;
  return int4 ? mr * (ks / Pack<true>::W) * Pack<true>::LP * 4
              : mr * (ks / Pack<false>::W) * Pack<false>::LP * 4;
}

// body: 0 fma (f32 x; mr rows a block: 1, 4, 8 or 16; `splits` slices of
// `ks` k each, ks a multiple of the step, 512 int8 / 1024 int4), 1 tile
// (bf16 x, M > 16), 2 gemv (bf16 x, M <= mr, mr 8 or 16; ks a multiple of
// 64 int8 / 128 int4), 3 wgmma (bf16 x, M > 16, K a multiple of 16 int8 /
// 32 int4, x and q 16-byte aligned). dtype: 0 f32, 1 bf16 (x and out). bias_code: -1
// none, 0 f32, 1 bf16. work: f32 [splits, M, N] when splits > 1.
extern "C" int weight_only_linear_launch(
    const void* x, const void* q, const void* scale, const void* bias,
    void* out, void* work, int M, int N, int K, int int4, int dtype,
    int bias_code, int body, int mr, int splits, int ks, int vec,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
         bias, out, static_cast<float*>(work), M, N, K, bias_code, splits,
         ks, vec};
  if (body == 1 || body == 3) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (body == 3)
      return static_cast<int>(int4 ? launch_wgmma<true>(a, s)
                                   : launch_wgmma<false>(a, s));
    return static_cast<int>(int4 ? launch_tile<true>(a, s)
                                 : launch_tile<false>(a, s));
  }
  const int step = body == 2 ? (int4 ? GemvPack<true>::KB
                                     : GemvPack<false>::KB)
                             : (int4 ? Pack<true>::STEP : Pack<false>::STEP);
  if ((body != 0 && body != 2) || dtype != (body == 2 ? 1 : 0) || ks <= 0 ||
      ks % step || splits < 1 ||
      static_cast<long long>(splits) * ks < K ||
      static_cast<long long>(splits - 1) * ks >= K ||
      (body == 2 && M > mr) || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (body == 2)
    e = int4 ? launch_gemv<true>(a, mr, s) : launch_gemv<false>(a, mr, s);
  else
    e = int4 ? launch_fma<true>(a, mr, s) : launch_fma<false>(a, mr, s);
  return static_cast<int>(e);
}
