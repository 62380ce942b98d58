// fused_mlp_w8a8_forward: a whole uniform-width int8 MLP, L layers of N x N.
//
// Replaces the TPU kernel `_mlp_w8a8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_mlp_w8a8_forward`.  For
// each layer: int8 GEMM, rescale, bias, `hidden_act`, the absolute maximum
// of each row, and requantization of the row for the next layer; the last
// layer writes raw f32 logits.
//
// What bounds it on the H100: the weight codes, L·N·N bytes, read once.  At
// the serving shape (4 x 4096, B = 16) that is 67.1 MB, more than the 50 MB
// L2, so each forward streams them from HBM: 20.0 us at 3.35 TB/s.  The
// products (2.15 G int8 operations) take about 1 us on the int8 tensor
// cores.  What sets the pace in this design is each layer boundary's chain
// of latencies (two grid barriers, the scale and code exchanges through L2),
// which the next layer's weight stream, in flight meanwhile, slows down.
//
// Design: the whole forward is ONE cooperative launch (`mlp_w8a8_plan` in
// ops/kernels.py sizes it), one block per SM.  Each block owns the same
// 32-column tiles of the output in every layer (tiles blk, blk + G, ...: one
// tile per block at N = 4096, 128 blocks) and streams its columns' weight
// rows, each a contiguous run of k, through a ring of `depth` stages in
// shared memory: one Tensor Memory Accelerator copy of a 32-row x kc box per
// stage (evict-first in L2) and one of the stage's code rows, both counted
// on the slot's mbarrier (int8_mma.cuh says why).  A layer's weights do not
// depend on its input, so the ring runs ahead across layer boundaries: a
// slot is refilled with the next item of the block's stream (the next
// stage, tile, layer or row group) as soon as every warp is done with it,
// and at N = 4096 the ring holds a whole layer's slice, so the next layer's
// weights stream in while the card requantizes.
//
// The product runs on the int8 tensor cores (int8_mma.cuh: m16n8k32, s32
// sums); a stage's activation codes ride in the same slot as its weights.
// Shared-memory bandwidth sets its pace (a stage's fragments are 48 KB a
// block), so every fragment byte is read once: warp w takes the 64-byte
// chunks w, w + 8, ... of k for all 32 columns, and the eight warps' int32
// partial tiles, exact in any order, are added in warp order through shared
// memory.
//
// Requantization, between layers and for x itself.  Every block needs every
// code of the next layer's rows, and quantizing whole rows in every block
// repeats B·N IEEE divisions per block (316 us against 77 in a chain of
// launches, an earlier design's chip_smoke.py on the H100).  So each block
//   1. writes its columns' partial row maxima of |h| to scratch; grid barrier;
//   2. takes the maximum of the partials (exact in any order, so every block
//      gets the same scale, row_scale of int8_linear.cuh);
//   3. quantizes only its own columns (code_byte) into the layer-input code
//      buffer in global memory (L2-resident); grid barrier;
//   4. copies those codes into the stages of the layer that are already in
//      the ring (the weights of those stages were issued before the
//      barriers) and into every stage issued later.
// The stream starts at the first layer's step 4, so that the first barriers
// do not wait behind it.  Two grid barriers a layer (cooperative_groups: the
// launch is refused with cudaErrorCooperativeLaunchTooLarge, which the
// wrapper raises, when the grid cannot be co-resident; it never hangs), and
// a lost mbarrier phase traps after 10 s.
//
// Rows: up to 64 a group (4 m16 tiles); a larger batch, or one whose stages
// do not fit shared memory, runs groups of rows one after another in the
// same launch, and the weights are streamed once per group.
//
// Bit for bit: the epilogue is int8_linear.cuh's (apply_act(epilogue(acc,
// sx, sw, b))), the scales and codes are row_scale and code_byte of the
// same row maxima, and int32 sums do not depend on their order, so a forward
// equals the chain of fused_linear_w8a8 launches bit for bit, and its plain
// version for relu and identity.
#include <cooperative_groups.h>

#include "int8_linear.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using int8mma::kChunk;

constexpr int kThreads = 256;  // 8 warps, each an eighth of a stage's k
constexpr int kWarps = kThreads / 32;
constexpr int kRedStride = 33;  // ints per row of a warp's partial tile
constexpr int kCols = 32;      // columns of one tile
constexpr int kMaxStages = 8;  // stages of the ring at most
constexpr int kMaxRows = 64;   // rows of one group: 4 m16 tiles
constexpr int kMaxGrid = 160;  // blocks of one launch (one per SM) at most
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  CUtensorMap wmap;       // the weights as (L N rows, N / 128, 128) bytes
  CUtensorMap cmap;       // the codes buffer `act` as (rows, N / 128, 128)
  const float* x;
  const float* sw;        // (L, N)
  const float* b;         // (L, N)
  float* y;               // (B, N)
  signed char* act;       // (rows, N): the current layer input's codes
  float* pmax;            // (rows, gridDim.x): partial row maxima
  int B, N, L, rows, kc, depth, hidden_act;
};

// Bytes of one stage: 32 weight rows and the code rows of whole m16 tiles,
// kc bytes each (the two tensor copies' boxes, dense; the code copy fills
// the group's rows, and the products of the rows past them are never read,
// so the fragment loads need no bounds).
__host__ __device__ inline int stage_bytes(int rows, int kc) {
  return (kCols + 16 * ((rows + 15) / 16)) * kc;
}

// Bytes of shared memory a block takes: the ring and 128 bytes to align it,
// the own columns' f32 values (rows x tiles x 32), the warps' int32 partial
// m16 tiles, the row scales, the ring's mbarriers and its slots' stage
// numbers.  ops/kernels.py mirrors this.
inline int64_t smem_bytes(int rows, int kc, int depth, int tiles) {
  return int64_t{depth} * stage_bytes(rows, kc) + 128 + 4ll * rows * tiles * kCols + 4ll * kWarps * 16 * kRedStride + 4ll * kMaxRows + 12ll * kMaxStages;
}

// The 64-byte chunk c of a stage into a warp's accumulators, all 32
// columns (4 n8 tiles) of every m16 tile: B (the weights) from `wrow`, the
// rows of n8 tile nt 8 kc bytes further each, A (the codes) from `arow`.
template <int MT>
__device__ __forceinline__ void product_chunk(int (&acc)[MT][4][4],
                                              const unsigned char* wrow,
                                              const unsigned char* arow, int c,
                                              int kc) {
  uint4 w[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    w[nt] = *reinterpret_cast<const uint4*>(wrow + nt * 8 * kc + c * kChunk);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const unsigned char* p = arow + mt * 16 * kc + c * kChunk;
    const uint4 lo = *reinterpret_cast<const uint4*>(p);
    const uint4 hi = *reinterpret_cast<const uint4*>(p + 8 * kc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) int8mma::mma_chunk(acc[mt][nt], lo, hi, w[nt]);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_w8a8_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int N = a.N, L = a.L, R = a.rows, D = a.depth, kc = a.kc;
  const int n_tiles = N / kCols;
  const int T = (n_tiles - blk + G - 1) / G;  // this block's tiles
  const int tmax = (n_tiles + G - 1) / G;
  const int S = (N + kc - 1) / kc;            // stages per tile and layer
  const int stage = stage_bytes(R, kc);
  const int groups = (a.B + R - 1) / R;
  const int own_row = tmax * kCols;           // floats per row of `own`
  const int total = groups * L * T * S;       // items of the block's stream

  unsigned char* ring =
      smem_raw + ((128 - cluster::smem_addr(smem_raw) % 128) % 128);
  float* own = reinterpret_cast<float*>(ring + int64_t{D} * stage);
  int* red = reinterpret_cast<int*>(own + R * own_row);
  float* sx = reinterpret_cast<float*>(red + kWarps * 16 * kRedStride);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sx + kMaxRows);
  int* slot_stage = reinterpret_cast<int*>(bars + kMaxStages);

  // The block's stream: item i is stage s of tile j of layer l of group g
  // (s fastest), in slot i % D.  Thread 0 issues it, each of its two parts
  // one of the slot's two arrivals and a whole box's bytes (past N a ragged
  // last stage reads zeros): its 32 weight rows, as soon as the slot is
  // free, and its rows of codes, once its layer's codes are complete (the
  // box's rows past the group's are never read).
  int ps = 0, pj = 0, pl = 0, pg = 0, pslot = 0, issued = 0;  // thread 0's cursor
  const uint64_t evict_first = int8mma::evict_first_policy();
  const uint64_t evict_last = int8mma::evict_last_policy();
  auto issue_weights = [&]() {
    cluster::mbar_expect(&bars[pslot], kCols * kc);
    int8mma::tma_load_3d(cluster::smem_addr(ring + pslot * stage), &a.wmap, 0,
                         ps * kc / 128, pl * N + (blk + pj * G) * kCols,
                         cluster::smem_addr(&bars[pslot]), evict_first);
    slot_stage[pslot] = ps;
  };
  auto issue_codes = [&](int slot) {
    cluster::mbar_expect(&bars[slot], R * kc);
    int8mma::tma_load_3d(cluster::smem_addr(ring + slot * stage + kCols * kc),
                         &a.cmap, 0, slot_stage[slot] * kc / 128, 0,
                         cluster::smem_addr(&bars[slot]), evict_last);
  };
  auto advance = [&]() {
    if (++ps == S) {
      ps = 0;
      if (++pj == T) {
        pj = 0;
        if (++pl == L) pl = 0, ++pg;
      }
    }
    if (++pslot == D) pslot = 0;
    ++issued;
  };
  // element c of this block's columns (tile c / 32) in a row of N
  auto column = [&](int c) {
    return (blk + c / kCols * G) * kCols + c % kCols;
  };

  if (tid == 0) {
    for (int i = 0; i < D; ++i) cluster::mbar_init(&bars[i], 2);
    cluster::mbar_init_fence();
  }

  cg::grid_group grid = cg::this_grid();
  const int g8 = lane >> 2, t4 = lane & 3;
  int cslot = 0, cphase = 0;                 // the next item to consume
  for (int g = 0; g < groups; ++g) {
    const int row0 = g * R, nr = min(R, a.B - row0);
    for (int e = tid; e < nr * T * kCols; e += kThreads) {
      const int r = e / (T * kCols), c = e % (T * kCols);
      own[r * own_row + c] = __ldg(a.x + int64_t{row0 + r} * N + column(c));
    }
    for (int l = 0; l < L; ++l) {
      // `own` holds this block's columns of the layer's f32 input
      __syncthreads();
      // 1. the maximum of |h| over this block's columns, per row
      for (int r = warp; r < nr; r += kThreads / 32) {
        float m = 0.0f;
        for (int c = lane; c < T * kCols; c += 32)
          m = fmaxf(m, fabsf(own[r * own_row + c]));
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (lane == 0) a.pmax[int64_t{r} * G + blk] = m;
      }
      grid.sync();
      // 2. every block takes the same maximum of the partials (a max is
      //    exact in any order), so gets the same scales: tpr threads a row,
      //    all of a thread's loads issued at once
      {
        int nrp = 1;
        while (nrp < nr) nrp *= 2;
        const int tpr = min(32, kThreads / nrp);
        const int r = tid / tpr, p0 = tid % tpr, per = (G + tpr - 1) / tpr;
        float m = 0.0f;
        if (r < nr) {
          const float* row = a.pmax + int64_t{r} * G;
#pragma unroll 8
          for (int i = 0; i < per; ++i)  // a clamped index repeats a partial
            m = fmaxf(m, __ldcg(row + min(p0 + i * tpr, G - 1)));
        }
        for (int off = tpr / 2; off >= 1; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (p0 == 0 && r < nr) sx[r] = int8k::row_scale(m);
      }
      __syncthreads();
      // 3. this block's columns as codes, four to a 32-bit store
      for (int e = tid; e < nr * T * (kCols / 4); e += kThreads) {
        const int r = e / (T * kCols / 4), c = 4 * (e % (T * kCols / 4));
        const float* v = own + r * own_row + c;
        const float s = sx[r];
        *reinterpret_cast<unsigned*>(a.act + int64_t{r} * N + column(c)) =
            int8k::code_byte(v[0], s) | int8k::code_byte(v[1], s) << 8 |
            int8k::code_byte(v[2], s) << 16 | int8k::code_byte(v[3], s) << 24;
      }
      int8mma::fence_async_global();  // the codes, for the tensor copies
      grid.sync();
      // the codes of this layer's items that are already in the ring
      const int layer_items = T * S;
      if (tid == 0) {
        int8mma::fence_async_global();
        if (issued == 0) {
          // the stream starts here, each item's weights then its codes: the
          // first requantization's loads and barriers would otherwise queue
          // behind it, and the first codes behind all of the ring's weights
          while (issued < (total < D ? total : D)) {
            const bool same_layer = pg == g && pl == l;
            const int slot = pslot;
            issue_weights();
            if (same_layer) issue_codes(slot);
            advance();
          }
        } else {
          // items of this layer and beyond already issued: their codes
          const int ahead = issued - (g * L + l) * layer_items;
          for (int i = 0, slot = cslot; i < min(ahead, layer_items); ++i) {
            issue_codes(slot);
            if (++slot == D) slot = 0;
          }
        }
      }

      const float* swl = a.sw + int64_t{l} * N;
      const float* bl = a.b + int64_t{l} * N;
      const bool last = l == L - 1;
      for (int j = 0; j < T; ++j) {
        // the epilogue's scales and biases (thread t finishes column t % 32),
        // loaded while the product runs
        const int col = (blk + j * G) * kCols + lane;
        const float swc = __ldg(swl + col), bc = __ldg(bl + col);
        int acc[MT][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[mt][i / 4][i % 4] = 0;
        for (int s = 0; s < S; ++s) {
          int8mma::mbar_wait_cta(&bars[cslot], static_cast<uint32_t>(cphase));
          const int chunks = min(kc, N - s * kc) / kChunk;
          const unsigned char* st = ring + cslot * stage;
          const unsigned char* wrow = st + g8 * kc + 16 * t4;
          const unsigned char* arow = st + (kCols + g8) * kc + 16 * t4;
          // warp w takes the chunks w, w + 8, ...: every fragment byte of
          // the stage is read once
          for (int c = warp; c < chunks; c += kWarps)
            product_chunk<MT>(acc, wrow, arow, c, kc);
          __syncthreads();  // every warp is done with the slot: refill it
          if (tid == 0 && issued < total) {
            const bool same_layer = pg == g && pl == l;  // its codes are ready
            const int slot = pslot;
            issue_weights();
            if (same_layer) issue_codes(slot);
            advance();
          }
          if (++cslot == D) cslot = 0, cphase ^= 1;
        }
        // The warps' partial sums, added in warp order (int32 sums are exact
        // in any order), one m16 tile at a time.  Accumulator i of n8 tile
        // nt: row g8 + 8 (i / 2), column nt*8 + 2 t4 + i % 2.
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int* mine = red + warp * 16 * kRedStride;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mine[(g8 + 8 * (i / 2)) * kRedStride + nt * 8 + 2 * t4 + i % 2] =
                  acc[mt][nt][i];
          __syncthreads();
          for (int e = tid; e < 16 * kCols; e += kThreads) {
            const int r = mt * 16 + e / kCols;
            if (r >= nr) continue;
            int sum = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += red[w * 16 * kRedStride + (e / kCols) * kRedStride + lane];
            const float z = int8k::epilogue(sum, sx[r], swc, bc);
            if (last)
              a.y[int64_t{row0 + r} * N + col] = z;
            else
              own[r * own_row + j * kCols + lane] = int8k::apply_act(a.hidden_act, z);
          }
          __syncthreads();  // `red` is free again
        }
      }
    }
  }
}

template <int MT>
int launch(const Args& a, int grid, size_t smem, cudaStream_t stream) {
  static bool configured[cluster::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= cluster::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(mlp_w8a8_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cluster::kMaxSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mlp_w8a8_kernel<MT>),
                                  dim3(grid), dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  wqs (L, N, N) int8, sws and bs (L, N)
// f32; y (B, N) f32; act (rows, N) int8 and pmax (rows, grid) f32 scratch.
// rows (<= 64, rows per group), kc (k per stage, a multiple of 128), depth
// (stages of the ring, <= 8) and grid (blocks, <= N / 32) are the plan of
// `mlp_w8a8_plan` in ops/kernels.py.  One cooperative launch; returns a
// cudaError_t: 0 on success, cudaErrorCooperativeLaunchTooLarge (720) when
// the card cannot hold the grid at once.
extern "C" int fused_mlp_w8a8_forward_f32(const void* x, const void* wqs,
                                          const void* sws, const void* bs,
                                          void* y, void* act, void* pmax,
                                          int B, int N, int L, int rows,
                                          int kc, int depth, int grid,
                                          int hidden_act, void* stream) {
  if (B < 1 || N < 128 || N % 128 != 0 || L < 1 || rows < 1 ||
      rows > kMaxRows || kc < 128 || kc % 128 != 0 || depth < 1 ||
      depth > kMaxStages || grid < 1 || grid > N / kCols || grid > kMaxGrid ||
      kc > 32768 || hidden_act < int8k::kIdentity || hidden_act > int8k::kTanh ||
      int64_t{(B + rows - 1) / rows} * L * ((N / kCols + grid - 1) / grid) *
              ((N + kc - 1) / kc) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N / kCols + grid - 1) / grid;
  const int64_t smem = smem_bytes(rows, kc, depth, tiles);
  if (smem > cluster::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const int8mma::EncodeTiled encode = int8mma::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // (total rows, N / 128, 128) bytes of a row-major (total rows, N) int8
  // array, read in boxes of (box_rows, kc / 128, 128)
  auto map = [&](CUtensorMap* m, const void* base, int64_t rows_total,
                 int box_rows) {
    const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(N / 128),
                                static_cast<cuuint64_t>(rows_total)};
    const cuuint64_t strides[2] = {128, static_cast<cuuint64_t>(N)};
    const cuuint32_t box[3] = {128, static_cast<cuuint32_t>(kc / 128),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t steps[3] = {1, 1, 1};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                  dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!map(&a.wmap, wqs, int64_t{L} * N, kCols) || !map(&a.cmap, act, rows, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(x);
  a.sw = static_cast<const float*>(sws);
  a.b = static_cast<const float*>(bs);
  a.y = static_cast<float*>(y);
  a.act = static_cast<signed char*>(act);
  a.pmax = static_cast<float*>(pmax);
  a.B = B;
  a.N = N;
  a.L = L;
  a.rows = rows;
  a.kc = kc;
  a.depth = depth;
  a.hidden_act = hidden_act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((rows + 15) / 16) {
    case 1: return launch<1>(a, grid, static_cast<size_t>(smem), s);
    case 2: return launch<2>(a, grid, static_cast<size_t>(smem), s);
    case 3: return launch<3>(a, grid, static_cast<size_t>(smem), s);
    default: return launch<4>(a, grid, static_cast<size_t>(smem), s);
  }
}
