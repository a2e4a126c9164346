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
// gemv_cluster_kernel (bf16 x, M <= 16): a streaming pass over the weights
//   in one launch. y^T = W x^T on mma.sync m16n8k16, the weights the A
//   operand, converted in registers straight from the raw bytes (int8: the
//   2^23 magic number below; int4: bf16 pairs straight from the nibbles,
//   128 + n - 136, exact too), x staged in shared memory as B. A block of 4
//   warps owns 128 weight rows (two 16-row tiles a warp, each its own C
//   fragments) and one K slice; each lane keeps 5 blocks of its weights in
//   flight through a private cp.async ring in shared memory, and the first
//   go out before the wait on the previous kernel (programmatic dependent
//   launch). The K slices (at most 8) of a column block run as one cluster
//   and add their partial sums in slice order through distributed shared
//   memory before one epilogue: no second launch, no f32 workspace.
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
// kernel. The launch function returns cudaGetLastError() (or the launch's
// own error: a refused cluster launch raises in the wrapper).
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

// 16 bytes read once: no L1 allocation; the L2 fetches the 256 bytes
// around them, so a row's next 16-byte pieces (other lanes, the next k
// blocks) hit
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes of row `row` of q from byte `off`; zeros past the row or N.
// vec: rows are a multiple of 16 bytes and q is 16-byte aligned
__device__ __forceinline__ uint4 load_q16(const int8_t* q, int row, int N,
                                          int off, int rowbytes, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row >= N || off >= rowbytes) return v;
  const int8_t* p = q + static_cast<size_t>(row) * rowbytes + off;
  if (vec) return ld_stream16(p);
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
// The product runs transposed, y^T = W x^T, on mma.sync m16n8k16: 16 weight
// rows are the A operand and the x rows B's n8 (rows 9 .. 16 a second n8
// tile that reuses each A fragment), so no half of a product is empty and a
// staged x value is read once per 16 weight rows.
//
// A CTA of kGvWarps warps owns kGvCols weight rows (kGvTiles 16-row tiles a
// warp, each with its own C fragments) and one K slice. A k block is
// kGvBlockBytes weight bytes a row (64 int8 or 128 int4 weights): lane (g,
// t) = (lane / 4, lane % 4) takes bytes 16 t .. 16 t + 15 of the block of
// rows g and g + 8 of each tile and converts them exactly into its A
// fragments under a permutation of k that its B fragments, 16-byte reads of
// the x slice staged in shared memory, follow (gemv_block).
//
// Bytes in flight: each lane copies its own pieces with cp.async (read
// once: L2 only, the L2 fetching the 256 bytes around) into a private ring
// of kGvStages blocks in shared memory, kGvStages - 1 blocks ahead of the
// one it converts, so the depth costs no registers and no barrier. x is
// staged in windows of at most kGvXBytes (one window at the decode shapes).
// The first blocks go out before griddepcontrol.wait: launched with
// programmatic stream serialisation, a call's weight reads overlap the
// tail of the kernel before it; x and the outputs wait for that kernel.
//
// The K slices of a column block run as one thread-block cluster (cluster
// dimension = splits along y, at most kGvMaxSplits). Each CTA leaves its
// partial sums in its own shared memory; after a cluster barrier, the CTA of
// rank c sums each column's slices in slice order (rank 0, 1, ...) through
// distributed shared memory for rows m = c, c + splits, ..., and runs the
// epilogue once: one launch a call, no f32 workspace, and the order
// split_sum_kernel used, so the sum is deterministic.
constexpr int kGvWarps = 4;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvMinBlocks = 512 / kGvThreads;     // CTAs an SM (registers)
constexpr int kGvTiles = 2;                        // 16-row tiles a warp
constexpr int kGvCols = 16 * kGvTiles * kGvWarps;  // weight rows a CTA
constexpr int kGvPieces = 2 * kGvTiles;            // 16-byte pieces a lane
constexpr int kGvStages = 6;                       // k blocks in flight a lane
constexpr int kGvBlockBytes = 64;                  // a k block: bytes a row
constexpr int kGvRingBytes = kGvStages * kGvPieces * kGvThreads * 16;
constexpr int kGvXBytes = 48 * 1024;               // staged x a window, max
constexpr int kGvMaxSplits = 8;                    // portable cluster size
constexpr int kGvPartPitch = kGvCols + 4;          // floats a row of partials

template <bool INT4>
struct Gv {
  static constexpr int KB = INT4 ? 128 : 64;  // k a block
};

// k blocks of x a window stages: the slice's, or as many as kGvXBytes holds
__host__ __device__ __forceinline__ int gemv_window(int mr, int ks, int kb) {
  const int cap = kGvXBytes / (mr * kb * 2);
  return ks / kb < cap ? ks / kb : cap;
}

// dynamic shared memory: the ring, then the staged x window (bf16, a pitch
// of 8 more), whose room takes the partial sums [mr][kGvPartPitch] f32
// after the last product; the read form needs the ring alone
inline int gemv_smem(int mr, int ks, bool int4, bool read) {
  const int kb = int4 ? Gv<true>::KB : Gv<false>::KB;
  const int xb = mr * (gemv_window(mr, ks, kb) * kb + 8) * 2;
  const int pb = mr * kGvPartPitch * 4;
  return kGvRingBytes + (read ? 0 : xb > pb ? xb : pb);
}

// 16-byte chunk p of a staged row lies at chunk p ^ swz(p): with int4 a lane
// reads chunks 4t .. 4t + 3 of a 128-k block, and t >= 2 would otherwise
// share banks with t - 2
template <bool INT4>
__device__ __forceinline__ int gemv_chunk(int p) {
  return INT4 ? p ^ (((p >> 3) & 1) << 1) : p;
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

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the low nibbles of bytes 0 and 2 of u (signed 4-bit) as bf16 pairs, exact:
// 128 + (s ^ 8) - 136
__device__ __forceinline__ uint32_t pair_s4(uint32_t u) {
  return fma_bf16x2((u & 0x000F000Fu) ^ 0x43084308u, 0x3F803F80u,
                    0xC308C308u);
}

// one k block of a warp: w holds rows g and g + 8 of each tile, bl is the
// block's index in the staged window. int8: step i takes the lane's weights
// at lane-local k 4i .. 4i + 3 (group_f32) as the pairs (2t, 2t + 1), (2t +
// 8, 2t + 9). int4: each word of 8 nibbles (k 8h .. 8h + 7) makes two steps
// of bf16 pairs straight from the nibbles, (0, 4), (1, 5) then (2, 6), (3,
// 7), and the x pairs are permuted to match
template <int NT, bool INT4>
__device__ __forceinline__ void gemv_block(float (&acc)[kGvTiles][NT][4],
                                           const uint4 (&w)[kGvTiles][2],
                                           const bf16* xs, int pitch, int g,
                                           int t, int bl) {
  constexpr int KB = Gv<INT4>::KB;
#pragma unroll
  for (int hs = 0; hs < KB / 32; ++hs) {  // a 16-byte chunk of x
    const int c = gemv_chunk<INT4>(bl * (KB / 8) + (KB / 32) * t + hs);
    uint4 xv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xv[j] = *reinterpret_cast<const uint4*>(xs + (g + 8 * j) * pitch +
                                              8 * c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (INT4) {
        uint32_t b0[NT], b1[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t x0 = e ? xv[j].y : xv[j].x;
          const uint32_t x1 = e ? xv[j].w : xv[j].z;
          b0[j] = __byte_perm(x0, x1, 0x5410);
          b1[j] = __byte_perm(x0, x1, 0x7632);
        }
#pragma unroll
        for (int r = 0; r < kGvTiles; ++r) {
          const uint32_t u0 = word(w[r][0], hs) >> (8 * e);
          const uint32_t u1 = word(w[r][1], hs) >> (8 * e);
          const uint32_t af[4] = {pair_s4(u0), pair_s4(u1), pair_s4(u0 >> 4),
                                  pair_s4(u1 >> 4)};
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[r][j], af, b0[j], b1[j]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGvTiles; ++r) {
          const float4 f0 = group_f32<INT4>(w[r][0], 2 * hs + e);
          const float4 f1 = group_f32<INT4>(w[r][1], 2 * hs + e);
          const uint32_t af[4] = {pack_hi(f0.x, f0.y), pack_hi(f1.x, f1.y),
                                  pack_hi(f0.z, f0.w), pack_hi(f1.z, f1.w)};
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[r][j], af, e ? xv[j].z : xv[j].x,
                     e ? xv[j].w : xv[j].y);
        }
      }
    }
  }
}

// READ: the same grid, cluster and weight loads and nothing else
// (chip_smoke.py's read ceiling): the loaded words are XOR-ed into a sum
// kept live by a store that never happens in practice
template <int MR, bool INT4, bool READ>
__global__ void __launch_bounds__(kGvThreads, kGvMinBlocks)
    gemv_cluster_kernel(const Args a) {
  constexpr int KB = Gv<INT4>::KB;
  constexpr int NT = MR / 8;
  extern __shared__ __align__(16) unsigned char gv_smem[];
  // [stage][piece][thread]: a lane's pieces are its own, so its cp.async
  // groups alone order them (no barrier)
  uint4* ring = reinterpret_cast<uint4*>(gv_smem) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * a.ks;
  const int nk = min(a.ks, a.K - k0);
  const int nkb = (nk + KB - 1) / KB;
  const int rowbytes = INT4 ? a.K / 2 : a.K;
  const int n0 = blockIdx.x * kGvCols;
  const int row = n0 + warp * 16 * kGvTiles + g;  // tile r: row + 16 r (+ 8)
  const int boff = (INT4 ? k0 / 2 : k0) + 16 * t;  // this lane's byte, block 0
  const bool vec = a.vec;

  // block b's pieces into its ring slot, one cp.async group (zeros past
  // the slice, K and N; element by element without vec)
  auto issue = [&](int b) {
    if (b < nkb) {
      uint4* slot = ring + (b % kGvStages) * kGvPieces * kGvThreads;
      const int off = boff + kGvBlockBytes * b;
#pragma unroll
      for (int p = 0; p < kGvPieces; ++p) {
        const int rn = row + 16 * (p >> 1) + 8 * (p & 1);
        if (vec) {
          const bool ok = rn < a.N && off < rowbytes;
          cp_async16_stream(slot + p * kGvThreads,
                            ok ? a.q + static_cast<size_t>(rn) * rowbytes + off
                               : a.q,
                            ok);
        } else {
          slot[p * kGvThreads] = load_q16(a.q, rn, a.N, off, rowbytes, false);
        }
      }
    }
    cp_async_commit();
  };
  auto fetch = [&](uint4(&w)[kGvTiles][2], int b) {
    const uint4* slot = ring + (b % kGvStages) * kGvPieces * kGvThreads;
#pragma unroll
    for (int p = 0; p < kGvPieces; ++p)
      w[p >> 1][p & 1] = slot[p * kGvThreads];
  };

  if constexpr (READ) {
    for (int s = 0; s < kGvStages - 1; ++s) issue(s);
    uint32_t sum = 0;
    for (int b = 0; b < nkb; ++b) {
      cp_async_wait<kGvStages - 2>();
      uint4 w[kGvTiles][2];
      fetch(w, b);
      issue(b + kGvStages - 1);
#pragma unroll
      for (int r = 0; r < kGvTiles; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sum ^= w[r][h].x ^ w[r][h].y ^ w[r][h].z ^ w[r][h].w;
    }
    if (sum == 0x9E3779B9u) static_cast<uint32_t*>(a.out)[threadIdx.x] = sum;
    return;
  }

  const int wk = gemv_window(MR, a.ks, KB);  // k blocks a window
  const int pitch = wk * KB + 8;
  bf16* xs = reinterpret_cast<bf16*>(gv_smem + kGvRingBytes);
  float* part = reinterpret_cast<float*>(xs);  // after the last product
  const bf16* x = static_cast<const bf16*>(a.x);
  // x rows 0 .. MR - 1 of the window's k blocks wb .. wb + wk (zeros past
  // M and the slice), one cp.async group
  auto stage = [&](int wb) {
    const int chunks = wk * (KB / 8);
    for (int i = threadIdx.x; i < MR * chunks; i += kGvThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int kk = wb * KB + 8 * c;  // k inside the slice
      const size_t src = static_cast<size_t>(r) * a.K + k0 + kk;
      bf16* dst = xs + r * pitch + 8 * gemv_chunk<INT4>(c);
      if (vec) {
        const bool ok = r < a.M && kk < nk;
        cp_async16(dst, ok ? x + src : x, ok);
      } else {
        for (int e = 0; e < 8; ++e)
          dst[e] = (r < a.M && kk + e < nk) ? x[src + e]
                                            : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  // the weights read nothing an earlier kernel of the stream writes: the
  // first kGvStages - 1 blocks go out before the wait on that kernel
  // (programmatic dependent launch), then the next kernel may start;
  // x and the outputs only after the wait
  for (int s = 0; s < kGvStages - 1; ++s) issue(s);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage(0);
  cp_async_wait<0>();
  __syncthreads();

  float acc[kGvTiles][NT][4];
#pragma unroll
  for (int r = 0; r < kGvTiles; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
  int wb = 0;
  for (int b = 0; b < nkb; ++b) {
    if (b == wb + wk) {  // the next x window (long K only)
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the last window
      wb = b;
      stage(wb);
      cp_async_wait<0>();
      __syncthreads();
    }
    uint4 w[kGvTiles][2];
    fetch(w, b);
    issue(b + kGvStages - 1);
    gemv_block<NT, INT4>(acc, w, xs, pitch, g, t, b - wb);
    cp_async_wait<kGvStages - 2>();  // block b + 1 has landed
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with x: its room takes the sums

  // C fragment (r, j): weight rows 16 r + g (+ 8), x rows 8 j + 2 t (+ 1)
#pragma unroll
  for (int r = 0; r < kGvTiles; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * j + 2 * t + (e & 1)) * kGvPartPitch + warp * 16 * kGvTiles +
             16 * r + g + 8 * (e >> 1)] = acc[r][j][e];
  hopper::cluster_sync();
  // this CTA's share of the outputs: rows m = rank, rank + splits, ... of
  // every column; each sum's slices loaded first, then added in order
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int mine = rank < a.M ? (a.M - rank + a.splits - 1) / a.splits : 0;
  for (int i = threadIdx.x; i < mine * kGvCols; i += kGvThreads) {
    const int m = rank + a.splits * (i / kGvCols), col = i % kGvCols;
    const int n = n0 + col;
    if (n >= a.N) continue;
    const float* p = part + m * kGvPartPitch + col;
    float v[kGvMaxSplits];
#pragma unroll
    for (int c = 0; c < kGvMaxSplits; ++c)
      v[c] = c < a.splits ? hopper::ld_cluster(p, c) : 0.f;
    float sum = v[0];
#pragma unroll
    for (int c = 1; c < kGvMaxSplits; ++c)
      if (c < a.splits) sum += v[c];
    store(static_cast<bf16*>(a.out) + static_cast<size_t>(m) * a.N + n,
          epilogue(sum, a.scale, a.bias, a.bias_code, n));
  }
  hopper::cluster_sync();  // no CTA leaves while another reads its sums
}

template <int MR, bool INT4, bool READ>
cudaError_t launch_gemv_mr(const Args& a, cudaStream_t s) {
  const int smem = gemv_smem(MR, a.ks, INT4, READ);
  void (*kern)(const Args) = gemv_cluster_kernel<MR, INT4, READ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the blocks may start while the kernel
  // before them finishes; they wait for it before touching x and out
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kGvCols - 1) / kGvCols, a.splits, 1);
  cfg.blockDim = dim3(kGvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = READ ? 1 : 2;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool INT4, bool READ = false>
cudaError_t launch_gemv(const Args& a, int mr, cudaStream_t s) {
  if (mr == 8) return launch_gemv_mr<8, INT4, READ>(a, s);
  if (mr == 16) return launch_gemv_mr<16, INT4, READ>(a, s);
  return cudaErrorInvalidValue;
}

// -- read ceiling (chip_smoke.py): a coalesced stream of the same bytes ----
// Consecutive threads read consecutive 16 bytes; a block reads
// kStreamUnroll pieces of kStreamThreads * 16 bytes, all in flight at once.
constexpr int kStreamThreads = 256;
constexpr int kStreamUnroll = 8;

__global__ void __launch_bounds__(kStreamThreads)
    read_stream_kernel(const int8_t* q, size_t chunks, uint32_t* sink) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kStreamThreads *
                          kStreamUnroll + threadIdx.x;
  uint4 v[kStreamUnroll];
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u) {
    const size_t i = base + static_cast<size_t>(u) * kStreamThreads;
    v[u] = i < chunks ? ld_stream16(q + 16 * i) : make_uint4(0, 0, 0, 0);
  }
  uint32_t sum = 0;
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u)
    sum ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  if (sum == 0x9E3779B9u) sink[threadIdx.x] = sum;
}

}  // namespace

// dynamic shared memory of a launch (bytes): the fma body's staged f32 x,
// the tile body's ring and converted weight tile, the gemv body's staged
// bf16 x window and partial sums, the wgmma body's ring and barriers
extern "C" int weight_only_linear_smem(int body, int mr, int ks, int int4) {
  if (body == 1) return int4 ? Tile<true>::smem : Tile<false>::smem;
  if (body == 3) return int4 ? Wg<true>::smem : Wg<false>::smem;
  if (body == 2) return gemv_smem(mr, ks, int4, false);
  return int4 ? mr * (ks / Pack<true>::W) * Pack<true>::LP * 4
              : mr * (ks / Pack<false>::W) * Pack<false>::LP * 4;
}

namespace {
// K slices a split body (fma 0, gemv 2) refuses: ks not a whole number of
// its steps, slices that do not cover K exactly once, a gemv cluster over
// kGvMaxSplits
bool bad_slices(int body, int K, int int4, int splits, int ks) {
  const int step = body == 2 ? (int4 ? Gv<true>::KB : Gv<false>::KB)
                             : (int4 ? Pack<true>::STEP : Pack<false>::STEP);
  return ks <= 0 || ks % step || splits < 1 ||
         static_cast<long long>(splits) * ks < K ||
         static_cast<long long>(splits - 1) * ks >= K ||
         (body == 2 && splits > kGvMaxSplits);
}
}  // namespace

// body: 0 fma (f32 x; mr rows a block: 1, 4, 8 or 16; `splits` slices of
// `ks` k each, ks a multiple of the step, 512 int8 / 1024 int4), 1 tile
// (bf16 x, M > 16), 2 gemv (bf16 x, M <= mr, mr 8 or 16; at most 8 slices
// of a multiple of 64 int8 / 128 int4 k, one cluster), 3 wgmma (bf16 x, M >
// 16, K a multiple of 16 int8 / 32 int4, x and q 16-byte aligned). dtype: 0
// f32, 1 bf16 (x and out). bias_code: -1 none, 0 f32, 1 bf16. work: f32
// [splits, M, N] when the fma body has splits > 1 (no other body takes it).
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
  if ((body != 0 && body != 2) || dtype != (body == 2 ? 1 : 0) ||
      bad_slices(body, K, int4, splits, ks) || (body == 2 && M > mr) ||
      (body == 0 && splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (body == 2)
    e = int4 ? launch_gemv<true>(a, mr, s) : launch_gemv<false>(a, mr, s);
  else
    e = int4 ? launch_fma<true>(a, mr, s) : launch_fma<false>(a, mr, s);
  return static_cast<int>(e);
}

// The read ceiling chip_smoke.py measures the gemv body against: the
// weight bytes of q [N, K] (int8, or int4 packed [N, K / 2]; 16-byte rows
// and base) read and nothing else. form 0: the gemv body's grid, cluster
// and loads at the slices (mr, splits, ks) it would take; form 1: a
// coalesced stream of the same bytes, a block a 32 KB piece. sink: 256
// uint32, written only if an XOR of the bytes hits a constant.
extern "C" int weight_only_read_launch(const void* q, void* sink, int N,
                                       int K, int int4, int mr, int splits,
                                       int ks, int form, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rowbytes = int4 ? K / 2 : K;
  if (N <= 0 || rowbytes % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1) {
    const size_t chunks = static_cast<size_t>(N) * rowbytes / 16;
    const size_t per = static_cast<size_t>(kStreamThreads) * kStreamUnroll;
    read_stream_kernel<<<static_cast<unsigned>((chunks + per - 1) / per),
                         kStreamThreads, 0, s>>>(
        static_cast<const int8_t*>(q), chunks, static_cast<uint32_t*>(sink));
    return static_cast<int>(cudaGetLastError());
  }
  if (form != 0 || bad_slices(2, K, int4, splits, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{nullptr, static_cast<const int8_t*>(q), nullptr, nullptr, sink,
         nullptr, mr, N, K, -1, splits, ks, 1};
  return static_cast<int>(int4 ? launch_gemv<true, true>(a, mr, s)
                               : launch_gemv<false, true>(a, mr, s));
}
