// fused_linear_w8: y = act(x · (q · s)ᵀ + b), weight-only int8.
//
// Replaces the TPU kernel `_linear_w8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear_w8`.  x (B, K) f32;
// q (O, Kp) int8 per-output-channel codes with zero codes past K; s (O,) and
// b (O,) f32.
//
// Precision, as the TPU body states it: each code is dequantized in f32,
// __fmul_rn(float(q), s[row]).  At "default" both x and the dequantized
// weight are then rounded to bf16 and their products (exact in f32: 8 x 8
// mantissa bits) are summed in f32; at "highest" everything stays f32, in
// IEEE fp32 FMA.
//
// What bounds it on the H100: the codes, O·K bytes read once, and the
// launch.  At the flagship's layers (266 KB of codes in all) a request is
// bound by latency: how many SMs pull the codes and x, and how many memory
// round trips lie on the way.  So the wrapper's plan (`w8_plan` in
// ops/kernels.py) picks one of three instances and a split of K:
//  0 gemv (B <= 16: the serving buckets).  Two warps per output column (each
//    half of its 16-code groups), 4 columns a block, so O columns make O / 4
//    blocks; only a long K is split over gridDim.z blocks (a split costs one
//    more round trip through L2 for its partials, which the flagship's K <=
//    784 does not repay).  Each lane issues all of its 16-byte code loads of
//    a chunk before the block stages the chunk's rows of x (rounded to bf16
//    at "default") in shared memory, so the two latencies overlap; the lane
//    then dequantizes its 16 codes and takes R x 16 FMAs, an xor butterfly
//    adds the lanes' sums and shared memory the two halves', in a fixed
//    order.  At these sizes a warp's serial instructions set the pace, so
//    the staging has no runtime division and rows past B are skipped.
//  1 mma (B > 16 at "default").  32 x 32 output tiles of 4 warps on the
//    bf16 tensor cores (mma.sync m16n8k16): each 32-deep stage of x is
//    rounded to bf16 and each of the codes dequantized once, into shared
//    memory, with the next stage's loads in registers meanwhile.  Each
//    product of 16 k lands in a fresh accumulator and is added to the
//    running f32 sum by an IEEE add (the tensor core's own accumulation
//    truncates).  bf16 operands with exact products and f32 sums are the TPU
//    body's own numerics; only the order of the f32 sums differs from the
//    plain version's.
//  2 simt (B > 16 at "highest").  The fp32 SIMT tile of simt_tile.cuh (32 x
//    64, 4 x 4 per thread), its weight loader dequantizing 8 codes per
//    8-byte load.
// A split of K writes each block's partial tile to scratch, and the last
// block of the tile to arrive adds them in split order (simt::split_k_reduce),
// so a rerun is bit-equal.  No float atomics.
#include <cuda_bf16.h>

#include "int8_linear.cuh"
#include "simt_tile.cuh"

namespace {

using int8k::kAlign;
using int8k::kFull;

constexpr int kGemvWarps = 4;  // output columns of one gemv block
constexpr int kGemvThreads = 256;  // two warps a column
static_assert(kGemvThreads == 64 * kGemvWarps, "two warps a column");
constexpr int kMmaTile = 32;   // rows, columns and k of one mma tile stage
constexpr int kMmaThreads = 128;
constexpr int kMmaStride = kMmaTile + 8;  // bf16 per staged row: conflict-free
using SimtTile = simt::Tile<32, 64, 16, 4, 4>;  // instance 2, 128 threads

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte e of the 16 codes in v, dequantized (and rounded to bf16 when BF16).
template <bool BF16>
__device__ __forceinline__ float dequant(unsigned word, int byte, float s) {
  const int q = static_cast<signed char>(word >> (8 * byte));
  const float d = __fmul_rn(static_cast<float>(q), s);
  return BF16 ? to_bf16(d) : d;
}

// x[k .. k + 3] of a row (k a multiple of 4), zeros at and past kend: one
// 16-byte load when vec (rows 16-byte aligned and kend % 4 == 0).
__device__ __forceinline__ float4 load_x4(const float* __restrict__ xr, int k,
                                          int kend, bool vec) {
  if (vec)
    return k < kend ? __ldg(reinterpret_cast<const float4*>(xr + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < kend ? __ldg(xr + k + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The gemv's output as split_k_reduce sees it: after the halves of k are
// added, lane r of warp w < kGemvWarps holds row r of column w of the block.
template <int R>
struct GemvOut {
  static constexpr int TM = 1, TN = 1;
  __device__ static bool leader() {
    return threadIdx.x < 32 * kGemvWarps && threadIdx.x % 32 < R;
  }
  __device__ static int row(int) { return threadIdx.x % 32; }
  __device__ static int col(int) { return threadIdx.x / 32; }
};

// Sum acc[0..R) over the warp's lanes in a fixed order; afterwards lane L
// holds in acc[0] the sum for row L % R (fused_linear.cu's butterfly).
template <int R>
__device__ __forceinline__ void warp_rows_sum(float (&acc)[R], int lane) {
#pragma unroll
  for (int off = 16; off >= R; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
#pragma unroll
  for (int off = R / 2; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? acc[i] : acc[i + off];
      const float keep = upper ? acc[i + off] : acc[i];
      acc[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
}

// Instance 0.  R (1, 4, 8 or 16) >= B rows; rows past B are skipped.  Warp w
// takes column w % kGemvWarps of the block and the 16-code groups 2 lane +
// w / kGemvWarps (+ 64 j) of each chunk: two warps a column, so that a lane
// holds one or two groups of a chunk, and their sums are added in a fixed
// order.  The block's k range is [z·kchunk, min(K, (z + 1)·kchunk)).
template <int R, bool BF16>
__global__ void __launch_bounds__(kGemvThreads)
w8_gemv_kernel(const float* __restrict__ x, const signed char* __restrict__ wq,
               const float* __restrict__ scale, const float* __restrict__ b,
               float* __restrict__ y, int B, int K, int Kp, int O, int act,
               int vec, int kchunk, float* __restrict__ part,
               int* __restrict__ counters) {
  constexpr int kGemvChunk = R <= 4 ? 2048 : 8192 / R;  // codes per chunk
  constexpr int kGroups = kGemvChunk / kAlign;           // 16-code groups
  constexpr int kLoads = (kGroups + 63) / 64;            // groups per lane
  constexpr int kRowUnits = 4 * kGroups;                 // x float4s per row
  constexpr int kStage = R * kRowUnits / kGemvThreads;   // x float4s per thread
  // the chunk's rows of x as float4s in the order [row][v][group]: float4 v
  // of group c (x[16c + 4v .. 16c + 4v + 3]) at (r * 4 + v) * kGroups + c
  __shared__ float4 xs[R * kRowUnits];
  __shared__ float halves[kGemvWarps][R];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = warp % kGemvWarps, half = warp / kGemvWarps;
  const int o = blockIdx.x * kGemvWarps + col;
  // a warp past O still helps stage x; it reads row O - 1 and stores nothing
  const signed char* wrow = wq + static_cast<int64_t>(min(o, O - 1)) * Kp;
  const float s = __ldg(scale + min(o, O - 1));
  const float bias = __ldg(b + min(o, O - 1));  // loaded with the operands
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemvChunk) {
    const int groups = (min(kGemvChunk, kend - k0) + kAlign - 1) / kAlign;
    int4 wv[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = 2 * lane + half + 64 * j;
      wv[j] = c < groups
                  ? __ldg(reinterpret_cast<const int4*>(wrow + k0) + c)
                  : make_int4(0, 0, 0, 0);
    }
    // this thread's share of the chunk's x, every load issued before the
    // first store: rows of 2^shift float4s (the least power of two that
    // holds the chunk's), so a short K stages in fewer steps
    int shift = 2;
    while ((1 << shift) < 4 * groups) ++shift;
    const int steps = ((R << shift) + kGemvThreads - 1) / kGemvThreads;
    float4 xv[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = threadIdx.x + u * kGemvThreads;
      const int r = e >> shift, k4 = e & ((1 << shift) - 1);
      xv[u] = u < steps && r < B && k4 < 4 * groups
                  ? load_x4(x + static_cast<int64_t>(r) * K, k0 + 4 * k4, kend, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the previous chunk's reads of xs are done
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = threadIdx.x + u * kGemvThreads;
      const int r = e >> shift, k4 = e & ((1 << shift) - 1);
      if (u < steps && r < R && k4 < 4 * groups)
        xs[(r * 4 + k4 % 4) * kGroups + k4 / 4] =
            BF16 ? make_float4(to_bf16(xv[u].x), to_bf16(xv[u].y),
                               to_bf16(xv[u].z), to_bf16(xv[u].w))
                 : xv[u];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = 2 * lane + half + 64 * j;
      if (c >= groups) continue;
      const unsigned words[4] = {static_cast<unsigned>(wv[j].x),
                                 static_cast<unsigned>(wv[j].y),
                                 static_cast<unsigned>(wv[j].z),
                                 static_cast<unsigned>(wv[j].w)};
      float w[kAlign];
#pragma unroll
      for (int i = 0; i < kAlign; ++i) w[i] = dequant<BF16>(words[i / 4], i % 4, s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= B) break;
        float a = acc[r];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 xq = xs[(r * 4 + v) * kGroups + c];
          a = fmaf(xq.x, w[4 * v + 0], a);
          a = fmaf(xq.y, w[4 * v + 1], a);
          a = fmaf(xq.z, w[4 * v + 2], a);
          a = fmaf(xq.w, w[4 * v + 3], a);
        }
        acc[r] = a;
      }
    }
  }
  warp_rows_sum<R>(acc, lane);
  // the upper half of k hands its sums to the lower: half 0 + half 1
  if (half == 1 && lane < R) halves[col][lane] = acc[0];
  __syncthreads();
  float out[1][1] = {{half == 0 && lane < R ? acc[0] + halves[col][lane] : 0.f}};
  if (gridDim.z > 1 &&
      !simt::split_k_reduce<GemvOut<R>>(out, part, blockIdx.z, gridDim.z, 0,
                                        blockIdx.x * kGemvWarps, B, O,
                                        counters + blockIdx.x))
    return;
  if (half == 0 && o < O && lane < R && lane < B)
    y[static_cast<int64_t>(lane) * O + o] =
        int8k::apply_act(act, out[0][0] + bias);
}

// D += A · B on the bf16 tensor cores (one m16n8k16 product, f32 sums).
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The mma tile's output as split_k_reduce sees it: warp (wm, wn) = (w % 2,
// w / 2) holds rows 16 wm + g + 8 h and columns 16 wn + 8 (j / 2) + 2 t +
// j % 2 of the 32 x 32 tile, (g, t) = (lane / 4, lane % 4).
struct MmaOut {
  static constexpr int TM = 2, TN = 4;
  __device__ static bool leader() { return true; }
  __device__ static int row(int h) {
    return 16 * (threadIdx.x / 32 % 2) + threadIdx.x % 32 / 4 + 8 * h;
  }
  __device__ static int col(int j) {
    return 16 * (threadIdx.x / 64) + 8 * (j / 2) + 2 * (threadIdx.x % 4) + j % 2;
  }
};

// Instance 1: one 32 x 32 tile (blockIdx.x, blockIdx.y) over the k range of
// split blockIdx.z (kchunk each, a multiple of 32).
__global__ void __launch_bounds__(kMmaThreads)
w8_mma_kernel(const float* __restrict__ x, const signed char* __restrict__ wq,
              const float* __restrict__ scale, const float* __restrict__ b,
              float* __restrict__ y, int B, int K, int Kp, int O, int act,
              int vec, int kchunk, float* __restrict__ part,
              int* __restrict__ counters) {
  // [buffer][row][k] in bf16, x rows and dequantized weight rows
  __shared__ __align__(16) __nv_bfloat16 xs[2][kMmaTile][kMmaStride];
  __shared__ __align__(16) __nv_bfloat16 ws[2][kMmaTile][kMmaStride];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * kMmaTile, n0 = blockIdx.x * kMmaTile;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int n_stages = (kend - kbeg + kMmaTile - 1) / kMmaTile;
  // loader: x as 2 float4 a thread (rows tid / 8 and 16 + tid / 8, k 4 (tid
  // % 8)); codes as 8 bytes a thread (row tid / 4, k 8 (tid % 4))
  const int xr = tid / 8, xk = 4 * (tid % 8);
  const int wr = tid / 4, wk = 8 * (tid % 4);
  const bool w_in = n0 + wr < O;
  const signed char* wrow = wq + static_cast<int64_t>(min(n0 + wr, O - 1)) * Kp;
  const float s = __ldg(scale + min(n0 + wr, O - 1));
  float4 rx[2];
  uint2 rw;
  auto fetch = [&](int k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + xr + 16 * h;
      rx[h] = m < B ? load_x4(x + static_cast<int64_t>(m) * K, k + xk, kend, vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // a stage never crosses a split's end, and codes past K are zero
    rw = w_in && k + wk < Kp
             ? __ldg(reinterpret_cast<const uint2*>(wrow + k + wk))
             : make_uint2(0u, 0u);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint2*>(&xs[buf][xr + 16 * h][xk]) =
          make_uint2(pack_bf16(rx[h].x, rx[h].y), pack_bf16(rx[h].z, rx[h].w));
    unsigned v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned word = i < 2 ? rw.x : rw.y;
      // dequantized in f32, then rounded to bf16 once, as the TPU body does
      v[i] = pack_bf16(dequant<false>(word, 2 * (i % 2), s),
                       dequant<false>(word, 2 * (i % 2) + 1, s));
    }
    *reinterpret_cast<uint4*>(&ws[buf][wr][wk]) = make_uint4(v[0], v[1], v[2], v[3]);
  };

  float acc[2][4], bias[4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) bias[j] = __ldg(b + min(n0 + MmaOut::col(j), O - 1));
  const int wm = warp % 2, wn = warp / 2, g = lane / 4, t = lane % 4;
  if (n_stages > 0) {
    fetch(kbeg);
    store(0);
    __syncthreads();
  }
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    fetch(kbeg + (st + 1) * kMmaTile);  // past the last stage it loads nothing
#pragma unroll
    for (int kk = 0; kk < kMmaTile; kk += 16) {
      const __nv_bfloat16* xa = &xs[cur][16 * wm + g][kk + 2 * t];
      const unsigned a0 = *reinterpret_cast<const unsigned*>(xa);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(xa + 8 * kMmaStride);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(xa + 8);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(xa + 8 * kMmaStride + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // each product of 16 into a fresh accumulator, then one IEEE add:
        // the tensor core truncates a long running sum, and a one-ulp
        // difference in a hidden value can flip its bf16 rounding in the
        // next layer
        const __nv_bfloat16* wb = &ws[cur][16 * wn + 8 * j + g][kk + 2 * t];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part, a0, a1, a2, a3, *reinterpret_cast<const unsigned*>(wb),
                 *reinterpret_cast<const unsigned*>(wb + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], part[i]);
      }
    }
    if (st + 1 < n_stages) store(cur ^ 1);
    __syncthreads();
  }
  // acc[j][i]: row 16 wm + g + 8 (i / 2), column 16 wn + 8 j + 2 t + i % 2
  float out[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[h][j] = acc[j / 2][2 * h + j % 2];
  if (gridDim.z > 1 &&
      !simt::split_k_reduce<MmaOut>(out, part, blockIdx.z, gridDim.z, m0, n0,
                                    B, O, counters + blockIdx.y * gridDim.x + blockIdx.x))
    return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + MmaOut::row(h);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + MmaOut::col(j);
      if (n < O)
        y[static_cast<int64_t>(m) * O + n] =
            int8k::apply_act(act, out[h][j] + bias[j]);
    }
  }
}

// The SIMT tile's weight operand: the BX x BK block of dequantized codes
// (n0 + i, k0 + kk), 8 codes a thread per 8-byte load, written k-major into
// shared memory (the simt::Stage interface).
template <int BX, int BK, int NT>
struct CodeStage {
  static constexpr int kS = BX + simt::kPad;
  static constexpr int kRuns = BK / 8;  // 8-code runs per row of a stage
  static constexpr int kPer = BX * kRuns / NT;
  static constexpr int kRegs = 8 * kPer;
  static_assert(BX * kRuns % NT == 0 && BK % 8 == 0, "stage shape");

  const signed char* q;
  const float* scale;
  int64_t ld;  // Kp
  int rows;    // O
  int kend;

  __device__ __forceinline__ void fetch(float (&r)[kRegs], int i0, int k0) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = threadIdx.x + j * NT;
      const int i = i0 + v / kRuns, k = k0 + 8 * (v % kRuns);
      uint2 u = make_uint2(0u, 0u);
      float s = 0.f;
      // k < kend: a stage never crosses a split's end, codes past K are 0
      if (i < rows && k < kend) {
        u = __ldg(reinterpret_cast<const uint2*>(q + i * ld + k));
        s = __ldg(scale + i);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        r[8 * j + e] = dequant<false>(e < 4 ? u.x : u.y, e % 4, s);
    }
  }

  __device__ __forceinline__ void store(const float (&r)[kRegs], float* s) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = threadIdx.x + j * NT;
      const int i = v / kRuns, k = 8 * (v % kRuns);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[(k + e) * kS + i] = r[8 * j + e];
    }
  }
};

// Instance 2: one 32 x 64 tile over the k range of split blockIdx.z.
template <bool VEC>
__global__ void __launch_bounds__(SimtTile::NT)
w8_simt_kernel(const float* __restrict__ x, const signed char* __restrict__ wq,
               const float* __restrict__ scale, const float* __restrict__ b,
               float* __restrict__ y, int B, int K, int Kp, int O, int act,
               int kchunk, float* __restrict__ part, int* __restrict__ counters) {
  using TL = SimtTile;
  __shared__ __align__(16) float smem[TL::kSmemFloats];
  const int n0 = blockIdx.x * TL::BN, m0 = blockIdx.y * TL::BM;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int n_stages = (kend - kbeg + TL::BK - 1) / TL::BK;
  const simt::Stage<float, TL::BM, TL::BK, TL::NT, true, VEC, false> la{x, K, B, kend};
  const CodeStage<TL::BN, TL::BK, TL::NT> lb{wq, scale, Kp, O, kend};
  float acc[TL::TM][TL::TN], bias[TL::TN];
#pragma unroll
  for (int j = 0; j < TL::TN; ++j) bias[j] = __ldg(b + min(n0 + TL::col(j), O - 1));
  TL::run(acc, la, lb, m0, n0, kbeg, n_stages, smem);
  if (gridDim.z > 1 &&
      !simt::split_k_reduce<TL>(acc, part, blockIdx.z, gridDim.z, m0, n0, B, O,
                                counters + blockIdx.y * gridDim.x + blockIdx.x))
    return;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int m = m0 + TL::row(i);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int n = n0 + TL::col(j);
      if (n < O)
        y[static_cast<int64_t>(m) * O + n] =
            int8k::apply_act(act, acc[i][j] + bias[j]);
    }
  }
}

template <int R>
void launch_gemv(bool bf16, dim3 grid, cudaStream_t s, const float* x,
                 const signed char* q, const float* sc, const float* b,
                 float* y, int B, int K, int Kp, int O, int act, int vec,
                 int kchunk, float* part, int* counters) {
  if (bf16)
    w8_gemv_kernel<R, true><<<grid, kGemvThreads, 0, s>>>(
        x, q, sc, b, y, B, K, Kp, O, act, vec, kchunk, part, counters);
  else
    w8_gemv_kernel<R, false><<<grid, kGemvThreads, 0, s>>>(
        x, q, sc, b, y, B, K, Kp, O, act, vec, kchunk, part, counters);
}

}  // namespace

// Plain C entry point for ctypes.  `instance` (0 gemv, 1 mma, 2 simt),
// `vec` (16-byte loads of x: K % 4 == 0), `rows` (the gemv's row bound: 1,
// 4, 8 or 16), the grid (gx, gy, gz) and `kchunk` (k per split) are the
// plan of `w8_plan` in ops/kernels.py; with gz > 1, `part` holds gz x B x O
// floats and `counters` gx x gy zeroed ints (left zeroed).  highest is 1
// for "highest" (f32 throughout), 0 for "default" (bf16 operands); the mma
// instance is "default" only, the simt instance "highest" only.  Kp is K
// rounded up to 16.  Returns cudaGetLastError() after the launch: 0 on
// success.
extern "C" int fused_linear_w8_f32(const void* x, const void* wq,
                                   const void* scale, const void* b, void* y,
                                   int B, int K, int Kp, int O, int act,
                                   int instance, int vec, int rows, int gx,
                                   int gy, int gz, int kchunk, void* part,
                                   void* counters, int highest,
                                   void* stream) {
  if (B < 1 || K < 1 || O < 1 || Kp < K || Kp % kAlign != 0 || gz < 1 ||
      kchunk < 1 || static_cast<int64_t>(gz) * kchunk < K ||
      static_cast<int64_t>(gz - 1) * kchunk >= K ||
      (gz > 1 && (part == nullptr || counters == nullptr)) ||
      act < int8k::kIdentity || act > int8k::kTanh ||
      (vec && K % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const signed char* q = static_cast<const signed char*>(wq);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz);
  switch (instance) {
    case 0:
      // a warp per column, the splits a multiple of 16 codes
      if (static_cast<int64_t>(gx) * kGemvWarps < O || gy != 1 || B > rows ||
          (gz > 1 && kchunk % kAlign != 0))
        return static_cast<int>(cudaErrorInvalidValue);
      switch (rows) {
        case 1: launch_gemv<1>(!highest, grid, s, xf, q, sf, bf, yf, B, K, Kp, O, act, vec, kchunk, pf, cnt); break;
        case 4: launch_gemv<4>(!highest, grid, s, xf, q, sf, bf, yf, B, K, Kp, O, act, vec, kchunk, pf, cnt); break;
        case 8: launch_gemv<8>(!highest, grid, s, xf, q, sf, bf, yf, B, K, Kp, O, act, vec, kchunk, pf, cnt); break;
        case 16: launch_gemv<16>(!highest, grid, s, xf, q, sf, bf, yf, B, K, Kp, O, act, vec, kchunk, pf, cnt); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    case 1:
      if (highest || static_cast<int64_t>(gx) * kMmaTile < O ||
          static_cast<int64_t>(gy) * kMmaTile < B ||
          (gz > 1 && kchunk % kMmaTile != 0))
        return static_cast<int>(cudaErrorInvalidValue);
      w8_mma_kernel<<<grid, kMmaThreads, 0, s>>>(xf, q, sf, bf, yf, B, K, Kp,
                                                  O, act, vec, kchunk, pf, cnt);
      break;
    case 2:
      if (!highest || static_cast<int64_t>(gx) * SimtTile::BN < O ||
          static_cast<int64_t>(gy) * SimtTile::BM < B ||
          (gz > 1 && kchunk % SimtTile::BK != 0))
        return static_cast<int>(cudaErrorInvalidValue);
      if (vec)
        w8_simt_kernel<true><<<grid, SimtTile::NT, 0, s>>>(
            xf, q, sf, bf, yf, B, K, Kp, O, act, kchunk, pf, cnt);
      else
        w8_simt_kernel<false><<<grid, SimtTile::NT, 0, s>>>(
            xf, q, sf, bf, yf, B, K, Kp, O, act, kchunk, pf, cnt);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
