// fused_rnn_step: one Elman step, z = x · Wxᵀ + s · Wsᵀ + b, written as
// y = z (the pre-activation, the reference's fullyConnected convention) and
// s' = act(z).
//
// Replaces the TPU kernel `_rnn_step_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_rnn_step` ->
// `_rnn_step_impl`, which `FusedRNN(impl="pallas")` scans over a sequence;
// here `FusedRNN` runs a whole sequence in one launch (fused_rnn_seq_f32).
//
// Shapes: x (B, I), s (B, O), Wx (O, I), Ws (O, O), b (O,), all f32 and
// row-major; y and s' (B, O) f32.  The two products are one contraction over
// K = I + O: row r of the left operand is [x_r | s_r] and row c of the right
// one is [Wx_c | Ws_c], read from the four separate tensors (no concatenated
// copy is made).
//
// What bounds it on the H100, at the recurrent slice's shapes (I = 32,
// O = 512): at B = 1 (one step of FusedRNN's sequence) the step moves
// 1.12 MB, almost all of it the weights, for 0.56 MFLOP: 0.335 µs per step
// by bytes at 3.35 TB/s, so it is bytes-bound; at B = 256 it does
// 142.6 MFLOP on 2.72 MB: 2.13 µs by f32 FMA at 67 TFLOP/s (0.81 µs by
// bytes), so it is operations-bound.  A 64-step sequence at B = 1 does
// 35.7 MFLOP on 1.26 MB read or written once: 0.53 µs by operations.
//
// What the design does about that.  The TPU kernel keeps Wx and Ws whole in
// VMEM and `FusedRNN` drives it with `lax.scan` under `jit`.  Here the weights
// are 1.06 MB against 227 KB of shared memory a block may hold, and a launch
// per step costs more host time than the step's work, so the library has two
// entries:
//  * fused_rnn_step_f32, one step (the public per-step function, and the
//    "steps" plan of a sequence too wide for the cluster):
//    - B <= kGemvRows: a GEMV.  One warp per output column c spreads the 512
//      outputs over 128 blocks of 4 warps; the lanes stride over K
//      (x_sums, s_sums: coalesced reads of the weight row, one partial sum
//      per batch row of a chunk, a butterfly of shuffles adds the 32
//      partials).  The weights stream from L2 (50 MB holds them between
//      steps).
//    - larger B: a small GEMM.  64 x 64 output tiles, the K loop staging
//      16-deep tiles of both operands in shared memory across the two K
//      segments, 4 x 4 f32 accumulators per thread.
//  * fused_rnn_seq_f32, a whole sequence at B <= 4 and O <= 512 in ONE
//    launch of one thread block cluster of 16 blocks (FusedRNN's route).
//    Spread over the cluster the weights fit on chip: each block keeps its
//    O / 16 columns of [Wx | Ws] in shared memory (70 KB at 32 -> 512) for
//    the whole sequence, and every block keeps the whole state.  A step
//    reads only shared memory and x_t, sums each column with the step
//    kernel's x_sums and s_sums (so the bits are those of n step launches),
//    and sends the block's slice of the new state into every block with
//    16-byte asynchronous stores into distributed shared memory, counted on
//    the receiving block's mbarrier; a block waits for the state it reads, not
//    for the cluster (a cluster barrier per step, whose release waits for
//    every remote store before it, made a step several times its
//    arithmetic).  Then 64 dependent
//    steps set the pace, not the 0.53 µs bound of the sequence's FLOP; the
//    weights are read from device memory once.
// Ragged edges are masked (loads give 0 outside the matrix, stores are
// skipped); nothing is padded.  Each output is summed by exactly one warp or
// thread in a fixed order, with no atomics and no cross-block reduction, so
// a rerun is bit-equal.  The epilogue writes y and s' in f32 (logistic,
// relu, tanh or identity).
//
// Precision: both precision names compute in IEEE fp32 FMA on the CUDA
// cores, as the port's other f32 kernels do; tensor cores are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGemvRows = 16;      // B at or below this takes the GEMV path
constexpr int kRowChunk = 4;       // GEMV: batch rows per pass of the K loop
constexpr int kGemvWarps = 4;      // GEMV: output columns (warps) per block
constexpr int kTileB = 64;         // GEMM: rows of [x | s] per block
constexpr int kTileO = 64;         // GEMM: output columns per block
constexpr int kTileK = 16;         // GEMM: contraction depth per stage
constexpr int kThreads = 256;      // GEMM: threads per block
constexpr int kPad = 4;            // GEMM: breaks shared-memory bank conflicts
constexpr unsigned kFullMask = 0xffffffffu;
// The sequence kernel (one launch per sequence, weights resident):
constexpr int kCluster = 16;       // blocks of its one cluster (non-portable)
constexpr int kSeqThreads = 1024;  // threads per block: a warp per column
constexpr int kSeqWarps = kSeqThreads / 32;
constexpr int kSeqRows = 4;        // rows (B) it takes at most (instances 1, 4)
static_assert(kCluster + kSeqRows <= 32, "a warp's lanes store both");

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float apply_act(float z) {
  if (ACT == kLogistic) return 1.0f / (1.0f + expf(-z));
  if (ACT == kRelu) return z > 0.0f ? z : 0.0f;
  if (ACT == kTanh) return tanhf(z);
  return z;
}

// One warp's sums for output column c over rows r < nr of the left operand
// [x | s] (row r of x at x + r * ldx, of s at s + r * lds), in two parts:
// x_sums starts the sums over segment x (x · Wx_c), s_sums adds segment s
// (s · Ws_c).  Lane `lane` takes k = lane, lane + 32, ... of each segment,
// one fmaf per product in that order, and an xor butterfly adds the 32
// partials in a fixed order, leaving every lane with each row's whole sum.
// The step kernel's GEMV and the sequence kernel both sum through these, so
// one sequence launch gives the bits of n step launches (the sequence
// kernel runs x_sums before its state has arrived).
template <int R>
__device__ __forceinline__ void x_sums(float (&acc)[R], int nr,
                                       const float* x, int ldx,
                                       const float* wx_c, int I, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < I; k += 32) {
    const float w = wx_c[k];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) acc[r] = fmaf(x[(int64_t)r * ldx + k], w, acc[r]);
  }
}

template <int R>
__device__ __forceinline__ void s_sums(float (&acc)[R], int nr,
                                       const float* s, int lds,
                                       const float* ws_c, int O, int lane) {
#pragma unroll 4
  for (int k = lane; k < O; k += 32) {
    const float w = ws_c[k];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) acc[r] = fmaf(s[(int64_t)r * lds + k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(kFullMask, acc[r], off);
  }
}

template <int ACT>
__global__ void __launch_bounds__(32 * kGemvWarps)
rnn_step_gemv_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ wx,
                     const float* __restrict__ ws,
                     const float* __restrict__ b, float* __restrict__ y,
                     float* __restrict__ snew, int B, int I, int O) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  if (c >= O) return;  // a whole warp leaves together
  const float* wx_c = wx + (int64_t)c * I;
  const float* ws_c = ws + (int64_t)c * O;
  const float bias = b[c];
  for (int r0 = 0; r0 < B; r0 += kRowChunk) {
    const int nr = min(kRowChunk, B - r0);
    float acc[kRowChunk];
    x_sums<kRowChunk>(acc, nr, x + (int64_t)r0 * I, I, wx_c, I, lane);
    s_sums<kRowChunk>(acc, nr, s + (int64_t)r0 * O, O, ws_c, O, lane);
    if (lane < nr) {
      // lane r writes row r0 + r (acc is uniform across the warp)
      float z = acc[0];
#pragma unroll
      for (int r = 1; r < kRowChunk; ++r)
        if (lane == r) z = acc[r];
      z += bias;
      const int64_t at = (int64_t)(r0 + lane) * O + c;
      y[at] = z;
      snew[at] = apply_act<ACT>(z);
    }
  }
}

// Element (r, k) of the left operand [x | s] and (c, k) of the right one
// [Wx | Ws], 0 outside the matrices.
__device__ __forceinline__ float left_at(const float* x, const float* s,
                                         int r, int k, int B, int I, int O) {
  if (r >= B) return 0.0f;
  if (k < I) return x[(int64_t)r * I + k];
  if (k < I + O) return s[(int64_t)r * O + (k - I)];
  return 0.0f;
}

__device__ __forceinline__ float right_at(const float* wx, const float* ws,
                                          int c, int k, int I, int O) {
  if (c >= O) return 0.0f;
  if (k < I) return wx[(int64_t)c * I + k];
  if (k < I + O) return ws[(int64_t)c * O + (k - I)];
  return 0.0f;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
rnn_step_gemm_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ wx,
                     const float* __restrict__ ws,
                     const float* __restrict__ b, float* __restrict__ y,
                     float* __restrict__ snew, int B, int I, int O) {
  // Stored k-major so the inner loop reads a row of each tile.
  __shared__ float ls[kTileK][kTileB + kPad];
  __shared__ float rs[kTileK][kTileO + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // this thread's columns: tx + 16 * j
  const int ty = tid / 16;  // this thread's rows:    ty + 16 * i
  const int row0 = blockIdx.x * kTileB;
  const int col0 = blockIdx.y * kTileO;
  const int K = I + O;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // consecutive threads read consecutive k of one row: coalesced
#pragma unroll
    for (int e = tid; e < kTileB * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      ls[kk][r] = left_at(x, s, row0 + r, k0 + kk, B, I, O);
    }
#pragma unroll
    for (int e = tid; e < kTileO * kTileK; e += kThreads) {
      const int c = e / kTileK, kk = e % kTileK;
      rs[kk][c] = right_at(wx, ws, col0 + c, k0 + kk, I, O);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ls[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = rs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: consecutive threads hold consecutive columns, so the stores
  // of a row are coalesced.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= O) continue;
      const float z = acc[i][j] + b[c];
      const int64_t at = (int64_t)r * O + c;
      y[at] = z;
      snew[at] = apply_act<ACT>(z);
    }
  }
}

// n floats into shared memory dst[e] = f(e), U loads a thread in flight
// before the first store.
template <int U, class F>
__device__ __forceinline__ void stage(float* dst, int n, F f) {
  for (int e0 = threadIdx.x; e0 < n; e0 += U * blockDim.x) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n ? f(e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) dst[e] = v[u];
    }
  }
}

// Floats of the sequence kernel's shared memory: its two mbarriers (4
// floats), the block's cpb columns of [Wx | Ws] (K = I + O each), the state
// double-buffered by step parity, the block's biases and its slice of the
// new state.
__host__ __device__ inline int64_t seq_smem_floats(int B, int I, int O) {
  const int64_t cpb = (O + kCluster - 1) / kCluster;
  return 4 + cpb * (I + O) + 2ll * B * O + cpb + B * cpb;
}

// The whole sequence: xs (n, B, I) from s0 (B, O) to ys (n, B, O) (the
// pre-activations) and the final state sfin (B, O), B <= R <= kSeqRows,
// O <= kCluster * kSeqWarps.  Block `rank` of the cluster owns output
// columns [rank * cpb, rank * cpb + cpb), a warp each, and keeps their
// weights and biases in shared memory for the whole run; every block keeps
// the whole state.  A step: each warp starts its column's sums over x_t
// (read from global memory while the state is still on its way), waits on
// the block's mbarrier for the step's state, adds the sums over it
// (x_sums, s_sums: the step kernel's order), writes z to ys and s' = act(z)
// into the block's slice; after one block barrier warp 0 sends the slice
// into every block's next state buffer with st_async, 16 bytes a store where
// the slice's rows allow, counted on that block's mbarrier.  No cluster
// barrier inside the loop: a block waits only for the B x O state values it
// reads.  The buffers are double-buffered by step parity, each with its own
// mbarrier, and a buffer (or the slice) is written at step t only after the
// step's whole state has arrived, whose every value was sent after its
// sender's reads of that buffer (and of its slice) at step t - 1.
template <int ACT, int R>
__global__ void __launch_bounds__(kSeqThreads, 1)
rnn_seq_kernel(const float* __restrict__ xs, const float* __restrict__ s0,
               const float* __restrict__ wx, const float* __restrict__ ws,
               const float* __restrict__ b, float* __restrict__ ys,
               float* __restrict__ sfin, int n, int B, int I, int O) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int K = I + O;
  const int cpb = (O + kCluster - 1) / kCluster;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one per buffer
  float* wsm = smem + 4;                   // cpb x K
  float* sbuf = wsm + (int64_t)cpb * K;    // 2 x B x O
  float* bsm = sbuf + 2 * B * O;           // cpb
  float* slice = bsm + cpb;                // B x cpb: this step's new state
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = static_cast<int>(cluster.block_rank()) * cpb;
  const int ncols = max(0, min(cpb, O - c0));
  const uint32_t step_bytes = static_cast<uint32_t>(B) * O * sizeof(float);

  if (threadIdx.x == 0) {
    cluster::mbar_init(&bars[0], 1);
    cluster::mbar_init(&bars[1], 1);
    // buffer 1 receives the state of step 1, buffer 0 that of step 2
    if (n > 1) cluster::mbar_expect(&bars[1], step_bytes);
    if (n > 2) cluster::mbar_expect(&bars[0], step_bytes);
    cluster::mbar_init_fence();
  }
  stage<8>(wsm, ncols * K, [&](int e) {
    const int lc = e / K, k = e - lc * K;
    const int64_t c = c0 + lc;
    return k < I ? wx[c * I + k] : ws[c * O + (k - I)];
  });
  stage<2>(bsm, ncols, [&](int e) { return b[c0 + e]; });
  stage<2>(sbuf, B * O, [&](int e) { return s0[e]; });
  // every block runs, with its mbarriers armed, before any block sends
  cluster.sync();

  const bool mine = warp < ncols;  // at most one column a warp
  const int c = c0 + warp;
  const float* w = wsm + (int64_t)warp * K;
  // warp 0's lane q < kCluster sends the block's slice to block q, in
  // 16-byte pieces where the slice's rows are 16-byte aligned
  const uint32_t peer = lane < kCluster ? lane : 0;
  const uint32_t peer_s = cluster::map_rank(cluster::smem_addr(sbuf), peer);
  const uint32_t peer_bar = cluster::map_rank(cluster::smem_addr(bars), peer);
  const bool vec = cpb % 4 == 0 && O % 4 == 0;
  uint32_t parity = 0;  // bit b: the parity of buffer b's next phase
  for (int t = 0; t < n; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    float acc[R];
    if (mine) x_sums<R>(acc, B, xs + (int64_t)t * B * I, I, w, I, lane);
    if (t > 0) {
      cluster::mbar_wait(&bars[cur], (parity >> cur) & 1);
      parity ^= 1u << cur;
      // re-arm for this buffer's next step, t + 2
      if (threadIdx.x == 0 && t + 2 < n)
        cluster::mbar_expect(&bars[cur], step_bytes);
    }
    if (mine) {
      s_sums<R>(acc, B, sbuf + cur * B * O, O, w + I, O, lane);
      const float bias = bsm[warp];
      float z[R], sn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        z[r] = acc[r] + bias;
        sn[r] = apply_act<ACT>(z[r]);
      }
      if (lane < B) {
        float zr = z[0], sr = sn[0];
#pragma unroll
        for (int i = 1; i < R; ++i)
          if (lane == i) zr = z[i], sr = sn[i];
        slice[lane * cpb + warp] = sr;
        ys[((int64_t)t * B + lane) * O + c] = zr;
        if (t == n - 1) sfin[lane * O + c] = sr;
      }
    }
    if (t + 1 == n) break;
    // the slice is whole; warp 0 reads it into its stores before any warp
    // writes it again (that is after the next step's state, whose part from
    // this block those stores are, has arrived)
    __syncthreads();
    if (warp == 0 && lane < kCluster) {
      const uint32_t bar = peer_bar + 8u * nxt;
      for (int r = 0; r < B; ++r) {
        const float* src = slice + r * cpb;
        const uint32_t dst =
            peer_s + 4u * static_cast<uint32_t>(nxt * B * O + r * O + c0);
        if (vec) {
          for (int i = 0; i < ncols; i += 4)
            cluster::st_async4(dst + 4u * i,
                               *reinterpret_cast<const float4*>(src + i), bar);
        } else {
          for (int i = 0; i < ncols; ++i)
            cluster::st_async(dst + 4u * i, src[i], bar);
        }
      }
    }
  }
  // no block leaves while the cluster may still address its shared memory
  cluster.sync();
}

template <int ACT>
int launch_seq(const float* xs, const float* s0, const float* wx,
               const float* ws, const float* b, float* ys, float* sfin,
               int n, int B, int I, int O, cudaStream_t stream) {
  const size_t smem = seq_smem_floats(B, I, O) * sizeof(float);
  // the one-row instance spends no shuffles on rows that are not there;
  // row 0's sum is the same in both
  if (B == 1)
    return cluster::launch<rnn_seq_kernel<ACT, 1>>(
        kCluster, 1, kSeqThreads, smem, stream, xs, s0, wx, ws, b, ys, sfin,
        n, B, I, O);
  return cluster::launch<rnn_seq_kernel<ACT, kSeqRows>>(
      kCluster, 1, kSeqThreads, smem, stream, xs, s0, wx, ws, b, ys, sfin, n,
      B, I, O);
}

template <int ACT>
void launch(const float* x, const float* s, const float* wx, const float* ws,
            const float* b, float* y, float* snew, int B, int I, int O,
            cudaStream_t stream) {
  if (B <= kGemvRows) {
    const dim3 grid((O + kGemvWarps - 1) / kGemvWarps);
    rnn_step_gemv_kernel<ACT><<<grid, 32 * kGemvWarps, 0, stream>>>(
        x, s, wx, ws, b, y, snew, B, I, O);
  } else {
    const dim3 grid((B + kTileB - 1) / kTileB, (O + kTileO - 1) / kTileO);
    rnn_step_gemm_kernel<ACT><<<grid, kThreads, 0, stream>>>(
        x, s, wx, ws, b, y, snew, B, I, O);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int fused_rnn_step_f32(const void* x, const void* s,
                                  const void* wx, const void* ws,
                                  const void* b, void* y, void* snew, int B,
                                  int I, int O, int act, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(s);
  const float* wxf = static_cast<const float*>(wx);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  float* snf = static_cast<float*>(snew);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kIdentity:
      launch<kIdentity>(xf, sf, wxf, wsf, bf, yf, snf, B, I, O, st); break;
    case kLogistic:
      launch<kLogistic>(xf, sf, wxf, wsf, bf, yf, snf, B, I, O, st); break;
    case kRelu:
      launch<kRelu>(xf, sf, wxf, wsf, bf, yf, snf, B, I, O, st); break;
    case kTanh:
      launch<kTanh>(xf, sf, wxf, wsf, bf, yf, snf, B, I, O, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole sequence in one cluster launch (see rnn_seq_kernel): xs (n, B,
// I), s0 (B, O), Wx, Ws, b as above; ys (n, B, O) and sfin (B, O) f32.
// Needs 1 <= B <= 4, O <= 512 and the shared memory of
// seq_smem_floats (the wrapper's `rnn_seq_plan` says "resident").  Returns
// cudaGetLastError() after the launch (a cluster the card cannot place is
// refused there): 0 on success.
extern "C" int fused_rnn_seq_f32(const void* xs, const void* s0,
                                 const void* wx, const void* ws,
                                 const void* b, void* ys, void* sfin, int n,
                                 int B, int I, int O, int act, void* stream) {
  if (n < 1 || B < 1 || B > kSeqRows || I < 0 || O < 1 ||
      O > kCluster * kSeqWarps ||
      seq_smem_floats(B, I, O) * sizeof(float) > cluster::kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(xs);
  const float* sf = static_cast<const float*>(s0);
  const float* wxf = static_cast<const float*>(wx);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(ys);
  float* ff = static_cast<float*>(sfin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kIdentity:
      return launch_seq<kIdentity>(xf, sf, wxf, wsf, bf, yf, ff, n, B, I, O, st);
    case kLogistic:
      return launch_seq<kLogistic>(xf, sf, wxf, wsf, bf, yf, ff, n, B, I, O, st);
    case kRelu:
      return launch_seq<kRelu>(xf, sf, wxf, wsf, bf, yf, ff, n, B, I, O, st);
    case kTanh:
      return launch_seq<kTanh>(xf, sf, wxf, wsf, bf, yf, ff, n, B, I, O, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of the sequence kernel at (B, I, O) the current card
// can hold at once (cudaOccupancyMaxActiveClusters), into *out; 0 means a
// launch would be refused.  Returns a cudaError_t.
extern "C" int fused_rnn_seq_clusters(int B, int I, int O, int* out) {
  *out = 0;
  if (B < 1 || B > kSeqRows || I < 0 || O < 1 || O > kCluster * kSeqWarps ||
      seq_smem_floats(B, I, O) * sizeof(float) > cluster::kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = seq_smem_floats(B, I, O) * sizeof(float);
  return cluster::max_clusters<rnn_seq_kernel<kLogistic, kSeqRows>>(
      kCluster, kSeqThreads, smem, out);
}
