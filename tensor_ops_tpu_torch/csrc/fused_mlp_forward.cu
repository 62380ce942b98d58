// fused_mlp_forward: a whole ffLayer chain's forward in one launch.
//
// Replaces the TPU kernel `_mlp_kernel` (tensor_ops_tpu/ops/pallas_kernels.py),
// reached there through `fused_mlp_forward`.  For each layer l,
// h <- act_l(h · W_lᵀ + b_l); with `softmax_out` the last layer is instead a
// softmax over its real output width.
//
// What bounds it on the H100: on the TPU every weight stays in VMEM for the
// whole chain.  Here a block has at most 227 KB of shared memory, and the
// flagship's 266,200 f32 parameters (about 1.06 MB) do not fit; at the
// serving buckets (B < 64) the work is a few MFLOP, so the kernel is bound by
// the latency of streaming the weights through the SMs, and by how many SMs
// stream them.  The design (the wrapper's `mlp_forward_plan` in
// ops/kernels.py sizes it):
//   * the batch is cut into tiles of `rows` <= 8 rows; each tile is one
//     thread block cluster of kCluster = 16 blocks, so a bucket-8 request
//     runs on 16 SMs and B = 63 on 8 clusters, 128 SMs;
//   * every block of a cluster keeps the tile's activations in shared memory
//     for the whole chain, in two ping-pong buffers of `rows x stride`
//     floats (stride = the widest layer rounded up to 4 floats, so rows start
//     16-byte aligned, and off a multiple of 32, so the per-row stores hit
//     distinct banks);
//   * each layer's output columns are spread over the cluster's 256 warps,
//     two adjacent columns a warp: a warp reads both weight rows with
//     16-byte loads, up to 1,024 k of each in flight at once (the weights
//     stream from L2, which holds them all), every lane keeps one f32
//     partial sum per tile row and column, each activation it reads from
//     shared memory feeding both columns, and a transposing butterfly of
//     shuffles leaves lane L with the sums for row L % rows;
//   * the lanes then send the two activated values (one 8-byte store) into
//     every block's next buffer with asynchronous stores into distributed shared memory, each
//     counted on the receiving block's mbarrier for the layer; a block goes
//     on to the next layer once the layer's whole output has arrived (no
//     cluster barrier, whose release would wait for every store);
//   * the softmax (or the copy out) spreads the tile's rows over the
//     cluster's blocks, a warp per row, over the real classes only: nothing
//     is padded, so there are no lanes to mask.
// A layer whose K % 4 != 0, or whose weight is not 16-byte aligned, reads its
// weights with scalar loads.  Each output is summed by one warp in a fixed
// order, so a rerun is bit-equal.
//
// Precision: both precision names ("default" and "highest") compute in IEEE
// fp32 FMA.  On the TPU "default" meant bf16 multiplies on the MXU.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;            // blocks per row tile
constexpr int kChunk = 1024;            // k per pass of a column's weights
constexpr int kVecs = kChunk / 4 / 32;  // 16-byte loads a lane keeps in flight
constexpr int kPair = 2;                // output columns a warp sums at once
constexpr unsigned kFull = 0xffffffffu;

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

struct MlpArgs {
  const float* w[kMaxLayers];  // (dims[l+1], dims[l]) row-major
  const float* b[kMaxLayers];  // (dims[l+1],)
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  int vec[kMaxLayers];  // 16-byte weight loads for layer l
  int n_layers;
  int softmax_out;
  int stride;  // floats per row of each activation buffer
};

__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case kLogistic: return 1.0f / (1.0f + expf(-z));
    case kRelu: return z > 0.0f ? z : 0.0f;
    case kTanh: return tanhf(z);
    default: return z;
  }
}

// Sum acc[0..R) over the warp's 32 lanes; afterwards lane L holds in acc[0]
// the sum for row L % R.  Plain butterflies over the lane bits >= R, then a
// transposing butterfly over the bits < R (R - 1 shuffles instead of
// R * log2(R)).
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

// One warp's partial sums of columns o and o + 1 over the tile's rows (w0
// and w1 their weight rows): lane `lane` takes k = 4 lane + 128 j (VEC) or
// k = lane + 32 j.  Each activation read from shared memory feeds both
// columns, which halves the reads per FMA; the loads of both rows' chunk
// are issued before the first FMA.
template <int R, bool VEC>
__device__ __forceinline__ void pair_partials(float (&acc)[kPair][R],
                                              const float* __restrict__ w0,
                                              const float* __restrict__ w1,
                                              const float* in, int stride,
                                              int K, int nrows, int lane) {
  const float* w[kPair] = {w0, w1};
#pragma unroll
  for (int c = 0; c < kPair; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
  if constexpr (VEC) {
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      float4 wv[kPair][kVecs];
#pragma unroll
      for (int c = 0; c < kPair; ++c)
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int q = k0 + 4 * (lane + 32 * j);
          wv[c][j] = q < K
                         ? __ldg(reinterpret_cast<const float4*>(w[c] + q))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int q = k0 + 4 * (lane + 32 * j);
        if (q < K) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < nrows) {
              const float4 v =
                  *reinterpret_cast<const float4*>(in + r * stride + q);
#pragma unroll
              for (int c = 0; c < kPair; ++c) {
                acc[c][r] = fmaf(v.x, wv[c][j].x, acc[c][r]);
                acc[c][r] = fmaf(v.y, wv[c][j].y, acc[c][r]);
                acc[c][r] = fmaf(v.z, wv[c][j].z, acc[c][r]);
                acc[c][r] = fmaf(v.w, wv[c][j].w, acc[c][r]);
              }
            }
          }
        }
      }
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float a0 = __ldg(w0 + k), a1 = __ldg(w1 + k);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nrows) {
          const float v = in[r * stride + k];
          acc[0][r] = fmaf(v, a0, acc[0][r]);
          acc[1][r] = fmaf(v, a1, acc[1][r]);
        }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ y, int B,
                   int rows, MlpArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int rank = static_cast<int>(cluster.block_rank());
  const int buf_floats = rows * a.stride;
  // one mbarrier per layer, after the two buffers (16-byte aligned)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * buf_floats);
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int nrows = min(rows, B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // layer l's phase completes once its nrows x O values have arrived
    for (int l = 0; l < a.n_layers; ++l) {
      cluster::mbar_init(&bars[l], 1);
      cluster::mbar_expect(&bars[l], static_cast<uint32_t>(nrows) *
                                         a.dims[l + 1] * sizeof(float));
    }
    cluster::mbar_init_fence();
  }

  // the tile's x, 16 loads a thread in flight before the first store (8
  // rows of 784 in one round)
  const int k_in = a.dims[0];
  const float* xt = x + static_cast<int64_t>(row0) * k_in;
  constexpr int kU = 16;
  for (int e0 = threadIdx.x; e0 < nrows * k_in; e0 += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < nrows * k_in ? xt[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      if (e < nrows * k_in) smem[(e / k_in) * a.stride + e % k_in] = v[u];
    }
  }
  // every block runs, with its x and armed mbarriers, before any block
  // writes into it
  cluster.sync();

  const int gw = rank * kWarps + warp;  // this warp in the cluster
  for (int l = 0; l < a.n_layers; ++l) {
    const float* in = smem + (l & 1) * buf_floats;
    float* out = smem + ((l + 1) & 1) * buf_floats;
    const int K = a.dims[l], O = a.dims[l + 1];
    const bool last = l == a.n_layers - 1;
    const int act = (last && a.softmax_out) ? kIdentity : a.acts[l];
    for (int o = kPair * gw; o < O; o += kPair * kCluster * kWarps) {
      const bool pair = o + 1 < O;  // else the second column is a copy
      float acc[kPair][R];
      const float* w0 = a.w[l] + static_cast<int64_t>(o) * K;
      const float* w1 = pair ? w0 + K : w0;
      if (a.vec[l])
        pair_partials<R, true>(acc, w0, w1, in, a.stride, K, nrows, lane);
      else
        pair_partials<R, false>(acc, w0, w1, in, a.stride, K, nrows, lane);
      warp_rows_sum<R>(acc[0], lane);
      warp_rows_sum<R>(acc[1], lane);
      const int r = lane % R;
      if (r < nrows) {
        const float v0 = apply_act(act, acc[0][0] + __ldg(a.b[l] + o));
        const float v1 =
            pair ? apply_act(act, acc[1][0] + __ldg(a.b[l] + o + 1)) : 0.0f;
        // o is even and the row stride a multiple of 4: the pair is one
        // 8-byte store
        const uint32_t dst = cluster::smem_addr(out + r * a.stride + o);
        const uint32_t bar = cluster::smem_addr(&bars[l]);
        // the lanes that hold row r share out the cluster's blocks
        for (int q = lane / R; q < kCluster; q += 32 / R) {
          const uint32_t qd = cluster::map_rank(dst, q);
          const uint32_t qb = cluster::map_rank(bar, q);
          if (pair)
            cluster::st_async2(qd, v0, v1, qb);
          else
            cluster::st_async(qd, v0, qb);
        }
      }
    }
    // the layer's whole output has arrived here; a buffer is overwritten
    // only by a block that has received the layer before, whose values
    // were each sent after their sender's reads of that buffer
    cluster::mbar_wait(&bars[l], 0);
  }

  // the tile's rows over the cluster's blocks, a warp per row
  const float* h = smem + (a.n_layers & 1) * buf_floats;
  const int n_out = a.dims[a.n_layers];
  for (int r = rank + kCluster * warp; r < nrows; r += kCluster * kWarps) {
    const float* z = h + r * a.stride;
    float* yrow = y + static_cast<int64_t>(row0 + r) * n_out;
    if (!a.softmax_out) {
      for (int o = lane; o < n_out; o += 32) yrow[o] = z[o];
      continue;
    }
    // softmax(z) = exp(z - max z) / sum exp(z - max z)
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int o = lane; o < n_out; o += 32) m = fmaxf(m, z[o]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float s = 0.0f;
    for (int o = lane; o < n_out; o += 32) s += expf(z[o] - m);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    for (int o = lane; o < n_out; o += 32) yrow[o] = expf(z[o] - m) / s;
  }
}

template <int R>
int launch(const float* x, float* y, int B, int rows, const MlpArgs& a,
           cudaStream_t stream) {
  const size_t smem =
      2ull * rows * a.stride * sizeof(float) + kMaxLayers * sizeof(uint64_t);
  return cluster::launch<mlp_forward_kernel<R>>(
      kCluster, (B + rows - 1) / rows, kThreads, smem, stream, x, y, B, rows,
      a);
}

}  // namespace

// Plain C entry point for ctypes.  `ws` and `bs` are host arrays of
// n_layers device pointers; `dims` has n_layers + 1 widths; `acts` holds one
// activation code per layer (0 identity, 1 logistic, 2 relu, 3 tanh);
// `rows` (1, 2, 4 or 8) and `stride` (a multiple of 4 at least the widest
// layer) are the plan of `mlp_forward_plan` in ops/kernels.py.  Returns a
// cudaError_t: 0 on success.
extern "C" int fused_mlp_forward_f32(const void* x, void* y, int B, int rows,
                                     int n_layers, const void* const* ws,
                                     const void* const* bs, const int* dims,
                                     const int* acts, int softmax_out,
                                     int stride, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || stride % 4 != 0 ||
      2ll * rows * stride * sizeof(float) + kMaxLayers * sizeof(uint64_t) >
          cluster::kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(ws[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.acts[l] = acts[l];
    a.vec[l] = dims[l] % 4 == 0 &&
               reinterpret_cast<uintptr_t>(ws[l]) % 16 == 0;
  }
  for (int l = 0; l <= n_layers; ++l) {
    a.dims[l] = dims[l];
    if (dims[l] > stride) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_layers = n_layers;
  a.softmax_out = softmax_out;
  a.stride = stride;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(xf, yf, B, rows, a, s);
    case 2: return launch<2>(xf, yf, B, rows, a, s);
    case 4: return launch<4>(xf, yf, B, rows, a, s);
    case 8: return launch<8>(xf, yf, B, rows, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
