// fused_linear_w8a8: y = act((q(x) · wqᵀ) · sx · swᵀ + b), int8 x int8 -> int32.
//
// Replaces the TPU kernel `_linear_w8a8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear_w8a8`.  x (B, K) f32
// is quantized per row (symmetric, amax / 127, round half to even); wq (O, Kp)
// int8 holds per-output-channel codes with zero codes past K; sw (O,) and b
// (O,) f32.
//
// What bounds it on the H100: the weight codes, read once (O·K bytes), and the
// launch.  At the flagship's layers (784->300->100->10, B <= 512) the codes
// are 266 KB in all, so a request is bound by launch and memory latency; at a
// 4096-wide layer and B = 16 the 16.8 MB of codes take 5.0 us at 3.35 TB/s.
//
// The product runs on the int8 tensor cores (int8_mma.cuh: mma.sync m16n8k32,
// int32 sums, the permuted k order of its fragments).  The weights are the
// A operand: each warp owns one m16 tile of 16 output columns and loads its
// fragments straight from global memory into registers (16 bytes of each of
// two weight rows per lane and 64-byte chunk of k), two buffers of kBatch
// chunks in flight, the first two issued before the block waits for its
// codes; the activation codes of the block's rows are the B operand, n8
// tiles of 8 rows read from shared memory (rows past B are zero codes).  So
// at B <= 8 one n8 tile wastes nothing, and a block takes R = 8, 16, 32 or 64
// rows (NT n8 tiles) at larger B.  A block owns `tiles` m16 tiles (16 x tiles
// columns) and a k-slice; its 8 warps are `tiles` column tiles x 8 / tiles
// groups of k, whose int32 partial tiles meet in shared memory (integer
// atomics: exact in any order).
//
// No quantizer launch in series before the product (`instance`, chosen per
// shape by `w8a8_plan` in ops/kernels.py, which gives the numbers):
//  1 pdl: two launches under programmatic dependent launch.
//    quantize_rows_kernel (one block per row, the row in registers: maximum,
//    scale, codes) lets the product launch at once
//    (griddepcontrol.launch_dependents); the product
//    issues its first weight fragments and loads its epilogue's scales and
//    biases, then waits for the codes (griddepcontrol.wait) and copies its
//    slice of them into shared memory.  Each (row, k) is quantized once.
//  0 fused: one launch, for one n8 tile of rows (B <= 8) of at most 1,024
//    values (the flagship at bucket 8).  A block reads its rows whole, takes
//    each row's maximum and scale (row_scale) and encodes the rows
//    (code_byte) in shared memory before the product; every block repeats
//    those divisions, which is why more rows or longer ones take the pair.
//    Launched from the host one layer at a time, as a request launches it,
//    the pair's second launch comes after its quantizer has finished, so
//    there the one launch saves a launch and a kernel in series.
//
// Filling the card: the plan takes the fewest columns a block that keeps the
// blocks within the SMs, and splits K over the `split` blocks of one thread
// block cluster (grid.x, <= 8: a portable cluster) where K is long and the
// blocks few, or where a block's codes would not fit its shared memory.  The
// cluster's blocks add their int32 partial tiles through distributed shared
// memory after a cluster barrier; each finishes its share of the tile's
// elements (no scratch in global memory, no float atomics).
//
// Bit for bit: the scale and codes are int8_linear.cuh's row_scale and
// code_byte of the row maximum, the int32 sums do not depend on their order,
// and the epilogue is apply_act(epilogue(acc, sx, sw, b)), as in
// fused_mlp_w8a8_forward.cu: the kernel equals its plain version for relu and
// identity, and kernel 6 equals the chain of these launches.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "int8_linear.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using int8k::kFull;
using int8mma::kChunk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 16;  // columns of one m16 tile
constexpr int kMaxSplit = 8;   // blocks of a split of K: one portable cluster
constexpr int kBatch = 4;      // chunks of k in one of a warp's two buffers
constexpr int kLoads = 8;      // 16-byte loads a thread issues at once
constexpr int kRowRegs = 4;    // quantizer: float4s of a row a thread holds
constexpr int kPartPad = 4;    // ints past each row of the partial tile

enum Instance { kFused = 0, kPdl = 1 };

struct Args {
  const float* x;
  const signed char* wq;
  const float* sw;
  const float* b;
  float* y;
  const signed char* xq;  // pdl: the quantizer's codes (B, Kp) and scales
  const float* sxq;
  int B, K, Kp, O, act, tiles, kslice;
};

// Bytes of one row of codes in shared memory: the slice, padded so that the
// rows of a quarter-warp's two fragment loads fall in different banks.
__host__ __device__ inline int codes_stride(int kslice) {
  return kslice % 128 ? kslice : kslice + 64;
}

// Bytes of shared memory of one block: (fused) its rows of x in f32, the
// slice's codes, the int32 partial tile (rows of tiles x 16 + kPartPad) and
// the row scales.  ops/kernels.py mirrors this.
inline int64_t smem_bytes(int fused, int rows, int tiles, int kslice) {
  return (fused ? 4ll * rows * kslice : 0) + int64_t{rows} * codes_stride(kslice) + 4ll * rows * (kTileCols * tiles + kPartPad) + 4ll * rows;
}

// The weight fragments of chunks u0 .. u0 + kBatch - 1 of this warp's list
// (chunk u at byte k0 + u·step of both rows), zeros past the warp's chunks
// and past Kp.  Every load is issued before any is used.
__device__ __forceinline__ void fetch(uint4 (&lo)[kBatch], uint4 (&hi)[kBatch],
                                      const signed char* wlo,
                                      const signed char* whi, int k0, int step,
                                      int u0, int mine, int Kp) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int k = k0 + (u0 + u) * step;
    const bool in = u0 + u < mine && k < Kp;
    lo[u] = in ? __ldg(reinterpret_cast<const uint4*>(wlo + k)) : make_uint4(0, 0, 0, 0);
    hi[u] = in ? __ldg(reinterpret_cast<const uint4*>(whi + k)) : make_uint4(0, 0, 0, 0);
  }
}

// The products of those chunks into acc: the codes of n8 tile j, row g, at
// `cb` + j·8 rows (cb: this lane's row g and 16-byte column t of chunk 0 of
// the warp's list; its chunks `step` bytes apart).
template <int NT>
__device__ __forceinline__ void compute(int (&acc)[NT][4],
                                        const uint4 (&lo)[kBatch],
                                        const uint4 (&hi)[kBatch],
                                        const unsigned char* cb, int cstride,
                                        int step, int u0, int mine) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (u0 + u < mine) {
      const unsigned char* p = cb + (u0 + u) * step;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        int8mma::mma_chunk(acc[j], lo[u], hi[u],
                           *reinterpret_cast<const uint4*>(p + j * 8 * cstride));
    }
  }
}

template <int NT, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_kernel(const __grid_constant__ Args a) {
  constexpr int R = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int S = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int CT = a.tiles, KG = kWarps / CT, ct = warp % CT, kg = warp / CT;
  const int cols = kTileCols * CT, pstride = cols + kPartPad;
  const int col0 = blockIdx.y * cols, row0 = blockIdx.z * R;
  const int kbeg = rank * a.kslice;
  // this block's k: whole chunks up to the chunk that holds K - 1
  const int kfull = (a.K + kChunk - 1) / kChunk * kChunk;
  const int klen = min(a.kslice, kfull - kbeg);
  const int cstride = codes_stride(a.kslice);
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* codes = smem + (FUSED ? 4 * R * a.kslice : 0);
  int* part = reinterpret_cast<int*>(codes + R * cstride);
  float* sx = reinterpret_cast<float*>(part + R * pstride);

  // This warp's chunks of the slice: kg, kg + KG, ...; its weight rows (a
  // column past O reads row O - 1 and is never stored).
  const int nch = klen / kChunk;
  const int mine = (nch - kg + KG - 1) / KG;
  const int o = col0 + ct * kTileCols + g;
  const signed char* wlo = a.wq + int64_t{min(o, a.O - 1)} * a.Kp;
  const signed char* whi = a.wq + int64_t{min(o + 8, a.O - 1)} * a.Kp;
  const int k0 = kbeg + kg * kChunk + 16 * t, step = KG * kChunk;
  uint4 alo0[kBatch], ahi0[kBatch], alo1[kBatch], ahi1[kBatch];
  fetch(alo0, ahi0, wlo, whi, k0, step, 0, mine, a.Kp);
  fetch(alo1, ahi1, wlo, whi, k0, step, kBatch, mine, a.Kp);

  // the first element this thread finishes: its scale and bias, loaded now
  const int E = R * cols;
  const int e_first = rank * kThreads + tid;
  float sw_first = 0.0f, b_first = 0.0f;
  if (e_first < E && col0 + e_first % cols < a.O) {
    sw_first = __ldg(a.sw + col0 + e_first % cols);
    b_first = __ldg(a.b + col0 + e_first % cols);
  }
  if (KG > 1)
    for (int e = tid; e < R * pstride; e += kThreads) part[e] = 0;

  if (FUSED) {
    // the block's rows of x (zeros past K and for rows past B) into xs
    const int per = klen / 4, n4 = R * per;
    float4* xs4 = reinterpret_cast<float4*>(xs);
    for (int e0 = tid; e0 < n4; e0 += kThreads * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, r = e / per;
        v[u] = e < n4 && row0 + r < a.B
                   ? int8k::load4(a.x + int64_t{row0 + r} * a.K,
                                  4 * (e - r * per), a.K)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, r = e / per;
        if (e < n4) xs4[e] = v[u];
      }
    }
    __syncthreads();
    // each row's maximum (warp w: rows w, w + 8, ...) and its scale
    for (int r = warp; r < R; r += kWarps) {
      float m = 0.0f;
      for (int k4 = lane; k4 < per; k4 += 32)
        m = int8k::abs_max4(m, xs4[r * per + k4]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) sx[r] = int8k::row_scale(m);
    }
    __syncthreads();
    for (int e = tid; e < n4; e += kThreads) {
      const int r = e / per, k4 = e - r * per;
      *reinterpret_cast<unsigned*>(codes + r * cstride + 4 * k4) =
          int8k::code_word(xs4[e], sx[r]);
    }
  } else {
    // the quantizer's codes and scales are complete and visible after this
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (tid < R) sx[tid] = row0 + tid < a.B ? __ldcg(a.sxq + row0 + tid) : 1.0f;
    const int per = klen / 16, n16 = R * per;
    for (int e0 = tid; e0 < n16; e0 += kThreads * kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, r = e / per;
        const int k = kbeg + 16 * (e - r * per);
        v[u] = e < n16 && row0 + r < a.B && k < a.Kp
                   ? __ldcg(reinterpret_cast<const uint4*>(
                         a.xq + int64_t{row0 + r} * a.Kp + k))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, r = e / per;
        if (e < n16)
          *reinterpret_cast<uint4*>(codes + r * cstride + 16 * (e - r * per)) = v[u];
      }
    }
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const unsigned char* cb = codes + g * cstride + kg * kChunk + 16 * t;
  for (int u0 = 0; u0 < mine; u0 += 2 * kBatch) {
    compute<NT>(acc, alo0, ahi0, cb, cstride, step, u0, mine);
    fetch(alo0, ahi0, wlo, whi, k0, step, u0 + 2 * kBatch, mine, a.Kp);
    compute<NT>(acc, alo1, ahi1, cb, cstride, step, u0 + kBatch, mine);
    fetch(alo1, ahi1, wlo, whi, k0, step, u0 + 3 * kBatch, mine, a.Kp);
  }
  // Accumulator i of n8 tile j: column ct·16 + g + 8 (i / 2) of the block,
  // row j·8 + 2t + i % 2.
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int* p = part + (j * 8 + 2 * t + i % 2) * pstride + ct * kTileCols + g + 8 * (i / 2);
      if (KG > 1) atomicAdd(p, acc[j][i]);
      else *p = acc[j][i];
    }
  // the cluster's partial tiles, added (int32: exact in any order); block
  // `rank` finishes elements rank·256 + tid, then every S·256-th
  if (S > 1) cl.sync(); else __syncthreads();
  for (int e = e_first; e < E; e += S * kThreads) {
    const int r = e / cols, c = e - r * cols;
    const int row = row0 + r, col = col0 + c;
    if (row >= a.B || col >= a.O) continue;
    int sum = part[r * pstride + c];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < S && s != rank) sum += *cl.map_shared_rank(part + r * pstride + c, s);
    const float swc = e == e_first ? sw_first : __ldg(a.sw + col);
    const float bc = e == e_first ? b_first : __ldg(a.b + col);
    a.y[int64_t{row} * a.O + col] =
        int8k::apply_act(a.act, int8k::epilogue(sum, sx[r], swc, bc));
  }
  if (S > 1) cl.sync();  // no block leaves while its tile is being read
}

// The pdl instance's first launch: one block per row of x (the divisions,
// not the loads, set its pace, so they are spread over B SMs), its row in
// registers, kRowRegs float4s a thread: the row's absolute maximum
// (shuffles, then the warps' through shared memory), its scale sx[row] and
// its codes (Kp bytes, zero past K), four to a 32-bit store, from the same
// registers; a longer row takes a second pass over x.  It lets the product
// launch at once: the product waits for this grid's writes with
// griddepcontrol.wait.
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int K, int Kp,
                     signed char* __restrict__ codes, float* __restrict__ sx) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float warp_max[kWarps];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xr = x + int64_t{row} * K;
  const int words = Kp / 4;  // float4s of a row, and 32-bit code words
  float4 v[kRowRegs];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int w = threadIdx.x + j * kThreads;
    v[j] = w < words ? int8k::load4(xr, 4 * w, K)  // zeros past the row
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    m = int8k::abs_max4(m, v[j]);
  }
  const bool held = words <= kRowRegs * kThreads;  // the whole row is in v
  if (!held)
    for (int w = threadIdx.x + kRowRegs * kThreads; w < words; w += kThreads)
      m = int8k::abs_max4(m, int8k::load4(xr, 4 * w, K));
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  const float s = int8k::row_scale(m);  // a max is exact in any order
  if (threadIdx.x == 0) sx[row] = s;
  unsigned* out = reinterpret_cast<unsigned*>(codes + int64_t{row} * Kp);
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int w = threadIdx.x + j * kThreads;
    if (w < words) out[w] = int8k::code_word(v[j], s);  // zeros past K: 0
  }
  if (!held)
    for (int w = threadIdx.x + kRowRegs * kThreads; w < words; w += kThreads)
      out[w] = int8k::code_word(int8k::load4(xr, 4 * w, K), s);
}

// The product as a cluster launch of grid = (split, column groups, row
// tiles), clusters of (split, 1, 1); the pdl instance's with programmatic
// stream serialization, so that it may start while the quantizer runs.
template <int NT, bool FUSED>
int launch_product(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  cudaError_t e = cluster::configure<w8a8_kernel<NT, FUSED>>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = FUSED ? 1 : 2;
  e = cudaLaunchKernelEx(&cfg, w8a8_kernel<NT, FUSED>, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Plain C entry point for ctypes.  `instance` (0 fused, 1 pdl), `rows` (8,
// 16, 32 or 64 rows a block; the fused instance takes 8), `tiles` (1, 2, 4 or 8 m16 tiles a block),
// `split` (blocks of one cluster along K, <= 8) and `kslice` (k a block, a
// multiple of 64; the split's blocks cover K once, each at least one chunk)
// are the plan of `w8a8_plan` in ops/kernels.py.  The pdl instance takes xq
// (B, Kp) int8 and sx (B,) f32 as scratch for the quantizer's codes and
// scales.  Kp is K rounded up to 16.  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a plan it cannot run (it never substitutes
// another).
extern "C" int fused_linear_w8a8_f32(const void* x, const void* wq,
                                     const void* sw, const void* b, void* y,
                                     void* xq, void* sx, int B, int K, int Kp,
                                     int O, int act, int instance, int rows,
                                     int tiles, int split, int kslice,
                                     void* stream) {
  if (B < 1 || K < 1 || O < 1 || Kp < K || Kp % int8k::kAlign != 0 ||
      act < int8k::kIdentity || act > int8k::kTanh ||
      (instance != kFused && instance != kPdl) ||
      (rows != 8 && rows != 16 && rows != 32 && rows != 64) ||
      (tiles != 1 && tiles != 2 && tiles != 4 && tiles != 8) || split < 1 ||
      split > kMaxSplit || (instance == kFused && (split != 1 || rows != 8)) ||
      kslice < kChunk || kslice % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t kchunks = (K + kChunk - 1) / kChunk * int64_t{kChunk};
  const int64_t gx = ((O + kTileCols - 1) / kTileCols + tiles - 1) / tiles;
  const int64_t gy = (B + rows - 1) / rows;
  const int64_t smem = smem_bytes(instance == kFused, rows, tiles, kslice);
  if (int64_t{split} * kslice < kchunks ||
      int64_t{split - 1} * kslice >= kchunks || gx > 65535 || gy > 65535 ||
      smem > cluster::kMaxSmemBytes ||
      (instance == kPdl && (xq == nullptr || sx == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.wq = static_cast<const signed char*>(wq);
  a.sw = static_cast<const float*>(sw);
  a.b = static_cast<const float*>(b);
  a.y = static_cast<float*>(y);
  a.xq = static_cast<const signed char*>(xq);
  a.sxq = static_cast<const float*>(sx);
  a.B = B;
  a.K = K;
  a.Kp = Kp;
  a.O = O;
  a.act = act;
  a.tiles = tiles;
  a.kslice = kslice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kPdl) {
    quantize_rows_kernel<<<B, kThreads, 0, s>>>(
        a.x, K, Kp, static_cast<signed char*>(xq), static_cast<float*>(sx));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(split, static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const size_t bytes = static_cast<size_t>(smem);
  if (instance == kFused) return launch_product<1, true>(a, grid, bytes, s);
  switch (rows) {
    case 8: return launch_product<1, false>(a, grid, bytes, s);
    case 16: return launch_product<2, false>(a, grid, bytes, s);
    case 32: return launch_product<4, false>(a, grid, bytes, s);
    case 64: return launch_product<8, false>(a, grid, bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
