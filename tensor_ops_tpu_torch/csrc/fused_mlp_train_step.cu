// fused_mlp_train_step: one whole SGD step of an ffLayer chain — forward,
// loss, backward, update — in one cooperative launch.
//
// Replaces the TPU kernel `_mlp_train_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_mlp_train_step`.  The loss
// is either a softmax output with cross-entropy (`loss_kind` 0, the flagship
// MNIST configuration; acts[L-1] is ignored) or acts[L-1] with squared error
// summed over the outputs (`loss_kind` 1, the autoencoder configuration).
// Both are meaned over the batch, and the gradient is the mean gradient.
//
// What bounds it on the H100.  The work is small (the flagship at B = 100:
// 0.11 GFLOP, 1.7 µs at the 67 TFLOP/s f32 peak) and sequential: every
// layer waits for the one before it, forward and then backward.  So the
// step is bound by latency, and what it can do is spread each stage's work
// over every SM.  The TPU kernel keeps every weight and gradient accumulator
// in VMEM and walks batch tiles in grid order; here no block holds the
// flagship's 1.06 MB of parameters, and blocks run at once.  So the step is
// a sequence of stages, each spread over all blocks of one persistent
// launch (one block per SM: with two, the barriers cost more than the
// second block gave), with a grid-wide barrier between stages.  For L layers, H_0 = x:
//   F_l  (l = 0..L-1)  H_{l+1} = act_l(H_l · W_lᵀ + b_l); the last layer
//        gives the logits (or acts[L-1] in the squared-error mode).  Work:
//        32 x 32 tiles of (batch rows x outputs); where they are fewer than
//        the blocks (784 -> 300 at B = 100: 40 tiles), K is split over
//        blocks and the last split of each tile adds the partials in split
//        order (an integer counter per tile; no float atomics).
//   loss  one warp per row: softmax + -Σ y·log(where(p > 0, p, 1)), or the
//        squared error; writes dz_{L-1} (÷B) and the row's loss.
//   G_l  (l = L-1..0)  new_W_l = W_l - lr·(dz_lᵀ · H_l) in 32 x 32 tiles of
//        (outputs x inputs), new_b_l = b_l - lr·Σ_r dz_l (summed beside the
//        tiles of the first 32 inputs, from the same staged dz), and for l > 0
//        dz_{l-1} = (dz_l · W_l) ∘ act'(H_l) in 32 x 32 tiles of (rows x
//        inputs), reading the old W_l (the outputs never alias it).  G_{L-1}
//        also takes the mean loss.
// That is 2L + 1 stages and 2L barriers.  The tiles are csrc/simt_tile.cuh's:
// 256 threads make one 32 x 32 tile, each 64-deep double-buffered stage's k
// split over 4 groups of 64 threads with 4 x 4 accumulators each (a 2 x 2
// tile per thread over the whole stage spends two shared-memory wavefronts
// per four FMAs: the SM's shared memory, not its FMA units, set the pace).
// The activations and dz live in a global scratch that the wrapper allocates
// once per size; at the flagship's widths it stays in the 50 MB L2.  Data
// written by other blocks in this launch is read through L2 (ld.global.cg).
// act'(z) is computed from h = act(z) (logistic h(1-h), tanh 1-h², relu
// h>0, identity 1), so z is not kept.
//
// No float atomics: every sum is taken in a fixed order (each thread over
// its k, or batch rows, in order; then the four groups' sums in group order;
// a forward stage's K splits in split order; the mean loss by a fixed tree),
// so a step repeats bit for bit at a given grid.  The forward stages' K split
// follows the grid (one block per SM), so a card with another SM count may
// round differently.  Rows past B do not exist (no padding); the scratch's
// rows are padded to 4 floats so that 16-byte loads can read them.  The
// cross-entropy is -Σ y·log(p > 0 ? p : 1), as the TPU kernel takes it (not
// FusedMLP._loss's log(p + 1e-30)).  The update is
// w - lr·g with each product and difference rounded on its own, as the
// plain version's `w - lr * g`.  The rate comes by value, or from a float on
// the card (`lr_dev`), which a CUDA graph of the step reads at each replay,
// so a graph captured once serves every rate.
//
// Precision: both precision names compute in IEEE fp32 FMA.  On the TPU
// "default" meant bf16 multiplies on the MXU.
#include <cooperative_groups.h>

#include "simt_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using simt::Stage;

constexpr int kMaxLayers = 16;
// 32 x 32 output tiles, 64-deep stages, each stage's k split over 4 groups
// of 64 threads with 4 x 4 accumulators each
using StepTile = simt::Tile<32, 32, 64, 4, 4, 4>;
constexpr int kThreads = StepTile::NT;  // 256
constexpr int TM = StepTile::TM, TN = StepTile::TN;
template <bool KMAJOR, bool VEC, bool CG>
using StepStage = Stage<float, 32, StepTile::BK, kThreads, KMAJOR, VEC, CG>;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Loss { kSoftmaxXent = 0, kSquaredError = 1 };

struct StepArgs {
  const float* y;
  const float* w[kMaxLayers];  // (dims[l+1], dims[l]) row-major
  const float* b[kMaxLayers];
  float* new_w[kMaxLayers];
  float* new_b[kMaxLayers];
  const float* h[kMaxLayers + 1];  // h[0] = x; h[l] (B, ldh[l]) in scratch
  int ldh[kMaxLayers + 1];
  float* dz[2];      // dz_l in dz[l & 1], (B, round4(dims[l+1]))
  float* row_loss;   // B
  float* loss;       // the mean
  float* part;       // split-K partials of a forward stage, part_cap floats
  int* counters;     // one per output tile, zero between launches
  int part_cap;
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  int n_layers;
  int loss_kind;
  int B;
  float lr;
  const float* lr_dev;  // when set, the rate: read by each block at its G stages
};

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// F_l: items (row tile, output tile), and where the tiles leave blocks
// idle, (K split, tile): each split walks its own stages and writes its
// partial tile, and the last split of a tile to arrive (an integer counter
// per tile) adds the partials in split order and writes act(Σ + b).
template <bool VEC>
__device__ void forward_stage(const StepArgs& a, int l, float* smem) {
  const int K = a.dims[l], O = a.dims[l + 1], B = a.B;
  const bool last = l == a.n_layers - 1;
  const int act = (last && a.loss_kind == kSoftmaxXent) ? simt::kIdentity
                                                        : a.acts[l];
  const int nt = ceil_div(O, StepTile::BN);
  const int tiles = ceil_div(B, StepTile::BM) * nt;
  const int n_k = max(1, ceil_div(K, StepTile::BK));  // stages over all K
  int split = 1;
  if (tiles < static_cast<int>(gridDim.x))  // at least 2 stages a split
    split = min(min(static_cast<int>(gridDim.x) / tiles, max(1, n_k / 2)),
                a.part_cap / (B * O));
  const int chunk = ceil_div(n_k, max(split, 1));  // stages per split
  split = ceil_div(n_k, chunk);
  const StepStage<true, VEC, true> la{a.h[l], a.ldh[l], B, K};
  const StepStage<true, VEC, false> lb{a.w[l], K, O, K};
  float* out = const_cast<float*>(a.h[l + 1]);
  const int ldo = a.ldh[l + 1];
  for (int it = blockIdx.x; it < tiles * split; it += gridDim.x) {
    const int sp = it / tiles, t = it % tiles;
    const int m0 = (t / nt) * StepTile::BM, n0 = (t % nt) * StepTile::BN;
    float acc[TM][TN];
    StepTile::run(acc, la, lb, m0, n0, sp * chunk * StepTile::BK,
                  min(chunk, n_k - sp * chunk), smem);
    if (split > 1 && !simt::split_k_reduce<StepTile>(acc, a.part, sp, split,
                                                      m0, n0, B, O,
                                                      a.counters + t))
      continue;
    if (!StepTile::leader()) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + StepTile::row(i);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int o = n0 + StepTile::col(j);
        if (r < B && o < O)
          out[static_cast<int64_t>(r) * ldo + o] =
              simt::apply_act(act, acc[i][j] + __ldg(a.b[l] + o));
      }
    }
  }
}

// The loss and the last layer's dz: one warp per row.
__device__ void loss_stage(const StepArgs& a) {
  const int L = a.n_layers, n_out = a.dims[L], B = a.B;
  const float batch = static_cast<float>(B);
  const int lane = threadIdx.x % 32;
  const int ldz = round4(n_out);
  float* dz = a.dz[(L - 1) & 1];
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < B;
       r += gridDim.x * kWarps) {
    const float* zr = a.h[L] + static_cast<int64_t>(r) * a.ldh[L];
    const float* yr = a.y + static_cast<int64_t>(r) * n_out;
    float* dzr = dz + static_cast<int64_t>(r) * ldz;
    float lsum = 0.f;
    if (a.loss_kind == kSoftmaxXent) {
      float m = -__int_as_float(0x7f800000);  // -inf
      for (int o = lane; o < n_out; o += 32) m = fmaxf(m, __ldcg(zr + o));
      m = warp_max(m);
      float s = 0.f;
      for (int o = lane; o < n_out; o += 32) s += expf(__ldcg(zr + o) - m);
      s = warp_sum(s);
      for (int o = lane; o < n_out; o += 32) {
        const float p = expf(__ldcg(zr + o) - m) / s;
        const float yv = __ldg(yr + o);
        lsum += yv * logf(p > 0.f ? p : 1.f);
        dzr[o] = (p - yv) / batch;
      }
      lsum = -warp_sum(lsum);
    } else {
      const int act = a.acts[L - 1];
      for (int o = lane; o < n_out; o += 32) {
        const float h = __ldcg(zr + o);
        const float d = h - __ldg(yr + o);
        lsum += d * d;
        dzr[o] = (2.f * d) * simt::act_grad_from_out(act, h) / batch;
      }
      lsum = warp_sum(lsum);
    }
    if (lane == 0) a.row_loss[r] = lsum;
  }
}

// The mean loss: thread t adds rows t, t + 256, ... in order, then each
// warp's butterfly, then thread 0 adds the warps' sums in order.
__device__ void mean_loss(const StepArgs& a) {
  __shared__ float warp_sums[kWarps];
  float t = 0.f;
  for (int r = threadIdx.x; r < a.B; r += kThreads) t += __ldcg(a.row_loss + r);
  t = warp_sum(t);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    *a.loss = s / static_cast<float>(a.B);
  }
}

// G_l: weight-gradient tiles (the tiles of the first 32 inputs also sum
// the bias gradient), then (l > 0) dz_{l-1} tiles, then (l = L-1) the mean
// loss.
template <bool VEC>
__device__ void backward_stage(const StepArgs& a, int l, float* smem) {
  const int K = a.dims[l], O = a.dims[l + 1], B = a.B;
  const float lr = a.lr_dev ? __ldg(a.lr_dev) : a.lr;
  const float* dz = a.dz[l & 1];
  const int ldz = round4(O);
  const int w_nt = ceil_div(K, StepTile::BN);
  const int w_items = ceil_div(O, StepTile::BM) * w_nt;
  const int d_items = l > 0 ? ceil_div(B, StepTile::BM) * w_nt : 0;
  const int items = w_items + d_items + (l == a.n_layers - 1 ? 1 : 0);
  // dW[o][k] = Σ_r dz[r][o] · h[r][k]: both operands contiguous along the
  // output axis, the contraction over the batch rows
  const StepStage<false, VEC, true> gw_a{dz, ldz, O, B};
  const StepStage<false, VEC, true> gw_b{a.h[l], a.ldh[l], K, B};
  // dz_{l-1}[r][k] = Σ_o dz[r][o] · W[o][k]
  const StepStage<true, VEC, true> gd_a{dz, ldz, B, O};
  const StepStage<false, VEC, false> gd_b{a.w[l], K, K, O};
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < w_items) {
      const int m0 = (it / w_nt) * StepTile::BM;
      const int n0 = (it % w_nt) * StepTile::BN;
      float acc[TM][TN], db[TM];
      const int n_stages = ceil_div(B, StepTile::BK);
      if (n0 == 0) {
        // db[o] = Σ_r dz[r][o], beside the tile's products
        StepTile::run<true>(acc, gw_a, gw_b, m0, n0, 0, n_stages, smem, db);
        if (StepTile::leader() && StepTile::col(0) == 0) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int o = m0 + StepTile::row(i);
            if (o < O)
              a.new_b[l][o] = __fsub_rn(__ldg(a.b[l] + o), __fmul_rn(lr, db[i]));
          }
        }
      } else {
        StepTile::run(acc, gw_a, gw_b, m0, n0, 0, n_stages, smem);
      }
      if (!StepTile::leader()) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int o = m0 + StepTile::row(i);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int k = n0 + StepTile::col(j);
          if (o < O && k < K) {
            const int64_t at = static_cast<int64_t>(o) * K + k;
            a.new_w[l][at] = __fsub_rn(__ldg(a.w[l] + at),
                                       __fmul_rn(lr, acc[i][j]));
          }
        }
      }
    } else if (it < w_items + d_items) {
      const int t = it - w_items;
      const int m0 = (t / w_nt) * StepTile::BM;
      const int n0 = (t % w_nt) * StepTile::BN;
      float acc[TM][TN];
      StepTile::run(acc, gd_a, gd_b, m0, n0, 0, ceil_div(O, StepTile::BK),
                    smem);
      if (!StepTile::leader()) continue;
      const int act_prev = a.acts[l - 1];
      float* dzn = a.dz[(l - 1) & 1];
      const int ldn = round4(K);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = m0 + StepTile::row(i);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int k = n0 + StepTile::col(j);
          if (r < B && k < K) {
            const float h = __ldcg(a.h[l] + static_cast<int64_t>(r) * a.ldh[l] + k);
            dzn[static_cast<int64_t>(r) * ldn + k] =
                acc[i][j] * simt::act_grad_from_out(act_prev, h);
          }
        }
      }
    } else {
      mean_loss(a);
    }
  }
}

// The 2L + 1 stages of the step, with a grid barrier between each two.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
mlp_train_step_kernel(StepArgs a) {
  __shared__ __align__(16) float smem[StepTile::kSmemFloats];
  const int L = a.n_layers;
  for (int s = 0; s <= 2 * L; ++s) {
    if (s > 0) cg::this_grid().sync();
    if (s < L)
      forward_stage<VEC>(a, s, smem);
    else if (s == L)
      loss_stage(a);
    else
      backward_stage<VEC>(a, 2 * L - s, smem);
  }
}

}  // namespace

// Blocks of the step kernel one card holds at once (blocks per SM x SMs; 0
// when the card cannot launch cooperatively).  Returns a cudaError_t.
extern "C" int fused_mlp_train_step_capacity(int* blocks) {
  int dev = 0, sms = 0, coop = 0, f = 0, g = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &f, mlp_train_step_kernel<true>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g, mlp_train_step_kernel<false>, kThreads, 0);
  *blocks = coop ? (f < g ? f : g) * sms : 0;
  return static_cast<int>(e);
}

// Plain C entry point for ctypes.  `ws`, `bs`, `new_ws`, `new_bs` are host
// arrays of n_layers device pointers (f32, contiguous); `dims` has
// n_layers + 1 widths; `acts` one activation code per layer (0 identity,
// 1 logistic, 2 relu, 3 tanh); `loss_kind` 0 softmax + cross-entropy, 1
// squared error.  `scratch` holds train_step_scratch_floats(B, dims) floats
// (ops/kernels.py): h_1..h_L, the two dz buffers and the row losses, each
// row padded to 4 floats.  `vec` selects 16-byte loads (every dims[l], l <
// L, a multiple of 4, and x and the weights 16-byte aligned).  `grid` blocks
// (at most fused_mlp_train_step_capacity's) run the step as one cooperative
// launch.  `loss` receives the mean loss.  `lr_dev`, when not null, points to
// the rate on the card and replaces `lr`.  Returns a cudaError_t: 0 on
// success, the first failure otherwise.
extern "C" int fused_mlp_train_step_f32(
    const void* x, const void* y, int B, int n_layers, const void* const* ws,
    const void* const* bs, void* const* new_ws, void* const* new_bs,
    const int* dims, const int* acts, int loss_kind, float lr,
    const void* lr_dev, void* scratch, void* part, void* counters,
    int part_cap, void* loss, int vec, int grid, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || grid < 1 ||
      (loss_kind != kSoftmaxXent && loss_kind != kSquaredError))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a;
  a.y = static_cast<const float*>(y);
  a.h[0] = static_cast<const float*>(x);
  a.ldh[0] = dims[0];
  float* s = static_cast<float*>(scratch);
  int widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.dims[l] = dims[l];
    if (l == 0) continue;
    const int ld = (dims[l] + 3) / 4 * 4;
    a.h[l] = s;
    a.ldh[l] = ld;
    s += static_cast<int64_t>(B) * ld;
    widest = ld > widest ? ld : widest;
  }
  a.dz[0] = s;
  a.dz[1] = s + static_cast<int64_t>(B) * widest;
  a.row_loss = a.dz[1] + static_cast<int64_t>(B) * widest;
  a.loss = static_cast<float*>(loss);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.part_cap = part_cap;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(ws[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.new_w[l] = static_cast<float*>(new_ws[l]);
    a.new_b[l] = static_cast<float*>(new_bs[l]);
    a.acts[l] = acts[l];
  }
  a.n_layers = n_layers;
  a.loss_kind = loss_kind;
  a.B = B;
  a.lr = lr;
  a.lr_dev = static_cast<const float*>(lr_dev);
  const void* kernel = vec ? reinterpret_cast<const void*>(mlp_train_step_kernel<true>)
                           : reinterpret_cast<const void*>(mlp_train_step_kernel<false>);
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
