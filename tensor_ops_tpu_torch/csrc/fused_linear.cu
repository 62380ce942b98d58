// fused_linear: y = act(x · wᵀ + b), optionally also z = x · wᵀ + b.
//
// Replaces the TPU kernel `_linear_act_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear` ->
// `_fused_linear_fwd_impl` -> `_fused_linear_padded`.
//
// Shapes: x (B, K) row-major, w (O, K) in the ffLayer layout, b (O,) f32, z
// (B, O) f32; x, w and y are all f32 (fused_linear_f32) or all bf16
// (fused_linear_bf16).  Both operands are contracted on their contiguous
// second axis; no transposed or padded copy is made.  bf16 operands are
// widened to f32 on load (a bf16 x bf16 product is exact in f32), z is f32,
// and y = act(z) is rounded once with __float2bfloat16_rn.
//
// What bounds it on the H100 depends on the shape, so the wrapper's plan
// (`linear_plan` in ops/kernels.py) picks one of three instances:
//  0 gemv (B <= 16: serving buckets, the identity layer).  Bound by latency:
//    the work (2·B·K·O <= 7.5 MFLOP at 784->300) is far below what one SM
//    does in a microsecond, and the weight (<= 1 MB) is read once.  One
//    warp per output column, 4 warps a block, so O outputs make O / 4
//    blocks (75 at 784->300) instead of one 64-row tile that was 7/8
//    masked rows.  The block stages its <= 16 rows of x in shared memory
//    in chunks of 512 k; each lane issues all of its chunk's 16-byte
//    weight loads before the chunk's x is staged, so the weight latency
//    and the x latency overlap; an xor butterfly adds the lanes' partials
//    in a fixed order, transposing so that lane r ends with row r.
//  1 tile (the training and bucket-64/512 shapes, e.g. B = 100 at
//    784 -> 300).  Bound by latency and by filling the card: 32 x 64
//    output tiles, 128 threads with 4 x 4 accumulators, 16-deep stages
//    double-buffered (csrc/simt_tile.cuh).  Where the tiles alone leave
//    SMs idle, the plan splits K over gridDim.z blocks; each writes its
//    partial tile to a scratch slot, and the last block of a tile to
//    arrive (an integer counter per tile) adds the partials in split order
//    and runs the epilogue.  The order of the sum is fixed; only which
//    block adds it varies.
//  2 large (4096^3 and up: enough 128 x 128 tiles for every SM).  Bound by
//    f32 FMA (2.05 ms at 67 TFLOP/s for 4096^3): 128 x 128 tiles, 256
//    threads with 8 x 8 accumulators in two quadrants (16-byte, broadcast
//    shared-memory reads: 4 per 64 FMAs), 8-deep stages double-buffered,
//    16-byte global loads transposed into k-major shared memory from
//    registers (cp.async cannot transpose).
// Each instance has a scalar-load variant for K % 4 != 0 or an unaligned
// pointer (vec = 0).  Ragged edges are masked and nothing is padded.  No
// float atomics: each output is summed by one thread (or added from the
// split partials in split order by one thread), so a rerun is bit-equal.
//
// Precision: both precision names ("default" and "highest") compute in IEEE
// fp32 FMA on the CUDA cores, with no contraction into TF32; tensor cores
// at "default" are a numerics decision of their own (ROADMAP.md).
#include "simt_tile.cuh"

namespace {

using simt::Stage;
using simt::Tile;

constexpr int kGemvWarps = 4;      // output columns per gemv block
constexpr int kGemvChunk = 512;    // k per staged chunk of x
constexpr int kGemvVecs = kGemvChunk / 4 / 32;  // 16-byte weight loads a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

using MidTile = Tile<32, 64, 16, 4, 4>;      // instance 1, 128 threads
using LargeTile = Tile<128, 128, 8, 8, 8>;   // instance 2, 256 threads

// Sum acc[0..R) over the warp's 32 lanes in a fixed order; afterwards lane
// L holds in acc[0] the sum for row L % R.
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

template <typename T>
__device__ __forceinline__ void epilogue(T* y, float* z, int64_t at,
                                         float zz, int act) {
  if (z != nullptr) z[at] = zz;
  simt::put(y + at, simt::apply_act(act, zz));
}

// Instance 0.  R (1, 4, 8 or 16) >= B rows; rows past B are staged as 0.
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(32 * kGemvWarps)
linear_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ z, int B, int K, int O, int act) {
  __shared__ __align__(16) float xs[R][kGemvChunk];
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  // a warp past O still helps stage x; it reads row O - 1 and stores nothing
  const T* wc = w + static_cast<int64_t>(c < O ? c : O - 1) * K;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemvChunk) {
    const int kn = min(kGemvChunk, K - k0);
    if constexpr (VEC) {
      float4 wv[kGemvVecs];
#pragma unroll
      for (int j = 0; j < kGemvVecs; ++j) {
        const int q = 4 * (lane + 32 * j);
        wv[j] = q < kn ? simt::load4<false>(wc + k0 + q)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // this thread's share of the chunk's x: every load issued before the
      // first store
      const int nq = kn / 4;
      float4 xv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int e = threadIdx.x + j * 32 * kGemvWarps;
        const int r = e / nq, q = 4 * (e - r * nq);
        xv[j] = (e < R * nq && r < B)
                    ? simt::load4<false>(x + static_cast<int64_t>(r) * K + k0 + q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // the previous chunk's reads of xs are done
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int e = threadIdx.x + j * 32 * kGemvWarps;
        const int r = e / nq, q = 4 * (e - r * nq);
        if (e < R * nq) *reinterpret_cast<float4*>(&xs[r][q]) = xv[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kGemvVecs; ++j) {
        const int q = 4 * (lane + 32 * j);
        if (q < kn) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(&xs[r][q]);
            acc[r] = fmaf(v.x, wv[j].x, acc[r]);
            acc[r] = fmaf(v.y, wv[j].y, acc[r]);
            acc[r] = fmaf(v.z, wv[j].z, acc[r]);
            acc[r] = fmaf(v.w, wv[j].w, acc[r]);
          }
        }
      }
    } else {
      __syncthreads();
      for (int e = threadIdx.x; e < R * kn; e += 32 * kGemvWarps) {
        const int r = e / kn, k = e - r * kn;
        xs[r][k] = r < B ? simt::load1<false>(
                               x + static_cast<int64_t>(r) * K + k0 + k)
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = lane; k < kn; k += 32) {
        const float wk = simt::load1<false>(wc + k0 + k);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[r][k], wk, acc[r]);
      }
    }
  }
  warp_rows_sum<R>(acc, lane);
  if (c < O && lane < R && lane < B)
    epilogue(y, z, static_cast<int64_t>(lane) * O + c, acc[0] + b[c], act);
}

// Instances 1 and 2: one BM x BN tile per (blockIdx.x, blockIdx.y) over the
// k range of split blockIdx.z (kchunk each).
template <class TL, typename T, bool VEC>
__global__ void __launch_bounds__(TL::NT, TL::BM == 128 ? 2 : 4)
linear_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ z, int B, int K, int O, int act,
                   int kchunk, float* __restrict__ part,
                   int* __restrict__ counters) {
  __shared__ __align__(16) float smem[TL::kSmemFloats];
  const int n0 = blockIdx.x * TL::BN, m0 = blockIdx.y * TL::BM;
  const int nsplit = gridDim.z;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int n_stages = (kend - kbeg + TL::BK - 1) / TL::BK;
  const Stage<T, TL::BM, TL::BK, TL::NT, true, VEC, false> la{x, K, B, kend};
  const Stage<T, TL::BN, TL::BK, TL::NT, true, VEC, false> lb{w, K, O, kend};
  float acc[TL::TM][TL::TN];
  TL::run(acc, la, lb, m0, n0, kbeg, n_stages, smem);
  // split K: the last block of the tile adds the splits' partials in split
  // order (the 8 x 8 tile is never split)
  if constexpr (TL::kSplit) {
    if (nsplit > 1 &&
        !simt::split_k_reduce<TL>(acc, part, blockIdx.z, nsplit, m0, n0, B, O,
                                  counters + blockIdx.y * gridDim.x + blockIdx.x))
      return;
  }
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int m = m0 + TL::row(i);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int n = n0 + TL::col(j);
      if (n < O)
        epilogue(y, z, static_cast<int64_t>(m) * O + n, acc[i][j] + b[n], act);
    }
  }
}

template <typename T, int R>
void launch_gemv(bool vec, const T* x, const T* w, const float* b, T* y,
                 float* z, int B, int K, int O, int act, dim3 grid,
                 cudaStream_t s) {
  if (vec)
    linear_gemv_kernel<T, R, true><<<grid, 32 * kGemvWarps, 0, s>>>(
        x, w, b, y, z, B, K, O, act);
  else
    linear_gemv_kernel<T, R, false><<<grid, 32 * kGemvWarps, 0, s>>>(
        x, w, b, y, z, B, K, O, act);
}

template <class TL, typename T>
void launch_tile(bool vec, const T* x, const T* w, const float* b, T* y,
                 float* z, int B, int K, int O, int act, dim3 grid,
                 int kchunk, float* part, int* counters, cudaStream_t s) {
  if (vec)
    linear_tile_kernel<TL, T, true><<<grid, TL::NT, 0, s>>>(
        x, w, b, y, z, B, K, O, act, kchunk, part, counters);
  else
    linear_tile_kernel<TL, T, false><<<grid, TL::NT, 0, s>>>(
        x, w, b, y, z, B, K, O, act, kchunk, part, counters);
}

template <typename T>
int dispatch(const void* xp, const void* wp, const void* bp, void* yp,
             void* zp, int B, int K, int O, int act, int instance, int vec,
             int rows, int gx, int gy, int gz, int kchunk, void* part,
             void* counters, void* stream) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const float* b = static_cast<const float*>(bp);
  T* y = static_cast<T*>(yp);
  float* z = static_cast<float*>(zp);
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz);
  if (act < simt::kIdentity || act > simt::kTanh || B < 1 || O < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (instance) {
    case 0:
      // the grid must cover O with one warp per column
      if (static_cast<int64_t>(gx) * kGemvWarps < O || gy != 1 || gz != 1 ||
          B > rows)
        return static_cast<int>(cudaErrorInvalidValue);
      switch (rows) {
        case 1: launch_gemv<T, 1>(vec, x, w, b, y, z, B, K, O, act, grid, s); break;
        case 4: launch_gemv<T, 4>(vec, x, w, b, y, z, B, K, O, act, grid, s); break;
        case 8: launch_gemv<T, 8>(vec, x, w, b, y, z, B, K, O, act, grid, s); break;
        case 16: launch_gemv<T, 16>(vec, x, w, b, y, z, B, K, O, act, grid, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    case 1:
    case 2: {
      const int bm = instance == 1 ? MidTile::BM : LargeTile::BM;
      const int bn = instance == 1 ? MidTile::BN : LargeTile::BN;
      // the grid must cover the output once and K with its splits (the
      // large instance is never split)
      if (static_cast<int64_t>(gx) * bn < O || static_cast<int64_t>(gy) * bm < B ||
          gz < 1 || (instance == 2 && gz != 1) || kchunk < 1 ||
          static_cast<int64_t>(gz) * kchunk < K ||
          (gz > 1 && (part == nullptr || counters == nullptr ||
                      static_cast<int64_t>(gz - 1) * kchunk >= K)))
        return static_cast<int>(cudaErrorInvalidValue);
      if (instance == 1)
        launch_tile<MidTile, T>(vec, x, w, b, y, z, B, K, O, act, grid, kchunk,
                                pf, cnt, s);
      else
        launch_tile<LargeTile, T>(vec, x, w, b, y, z, B, K, O, act, grid,
                                  kchunk, pf, cnt, s);
      break;
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: f32 operands and y, or bf16 operands and
// y; b and z are f32 in both.  `z` may be null (no pre-activation out).
// `instance` (0 gemv, 1 tile, 2 large), `vec` (16-byte loads), `rows` (the
// gemv's row bound: 1, 4, 8 or 16), the grid (gx, gy, gz) and `kchunk` (k
// per split) are the plan of `linear_plan` in ops/kernels.py; with gz > 1,
// `part` holds gz x B x O floats and `counters` gx x gy zeroed ints (left
// zeroed).  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int fused_linear_f32(const void* x, const void* w, const void* b,
                                void* y, void* z, int B, int K, int O,
                                int act, int instance, int vec, int rows,
                                int gx, int gy, int gz, int kchunk,
                                void* part, void* counters, void* stream) {
  return dispatch<float>(x, w, b, y, z, B, K, O, act, instance, vec, rows, gx,
                         gy, gz, kchunk, part, counters, stream);
}

extern "C" int fused_linear_bf16(const void* x, const void* w, const void* b,
                                 void* y, void* z, int B, int K, int O,
                                 int act, int instance, int vec, int rows,
                                 int gx, int gy, int gz, int kchunk,
                                 void* part, void* counters, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, b, y, z, B, K, O, act, instance, vec,
                                 rows, gx, gy, gz, kchunk, part, counters,
                                 stream);
}
