// fused_rnn_step: one Elman step, z = x · Wxᵀ + s · Wsᵀ + b, written as
// y = z (the pre-activation, the reference's fullyConnected convention) and
// s' = act(z).
//
// Replaces the TPU kernel `_rnn_step_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_rnn_step` ->
// `_rnn_step_impl`; `FusedRNN(impl="pallas")` launches it once per timestep.
//
// Shapes: x (B, I), s (B, O), Wx (O, I), Ws (O, O), b (O,), all f32 and
// row-major; y and s' (B, O) f32.  The two products are one contraction over
// K = I + O: row r of the left operand is [x_r | s_r] and row c of the right
// one is [Wx_c | Ws_c], read from the four separate tensors (no concatenated
// copy is made).
//
// What bounds it on the H100, at the recurrent slice's shapes (I = 32,
// O = 512): at B = 1 (FusedRNN's per-timestep launch) the step moves
// 1.12 MB, almost all of it the weights, for 0.56 MFLOP: 0.335 µs per step
// by bytes at 3.35 TB/s, so it is bytes-bound; at B = 256 it does
// 142.6 MFLOP on 2.72 MB: 2.13 µs by f32 FMA at 67 TFLOP/s (0.81 µs by
// bytes), so it is operations-bound.
//
// What the design does about that.  The TPU kernel keeps Wx and Ws whole in
// VMEM; here they are 1.06 MB against 227 KB of shared memory a block may
// hold, so nothing is kept resident: the weights stream from L2 (50 MB
// holds them between steps).  Two regimes:
//  * B <= kGemvRows: a GEMV.  One warp per output column c spreads the 512
//    outputs over 128 blocks of 4 warps; the lanes stride over K (coalesced
//    reads of the weight row), each lane keeping one partial sum per batch
//    row of a chunk, and a butterfly of shuffles adds the 32 partials.
//  * larger B: a small GEMM.  64 x 64 output tiles, the K loop staging
//    16-deep tiles of both operands in shared memory across the two K
//    segments, 4 x 4 f32 accumulators per thread (the design of
//    csrc/fused_linear.cu).
// Ragged edges are masked (loads give 0 outside the matrix, stores are
// skipped); nothing is padded.  Each output is summed by exactly one warp or
// thread in a fixed order, with no atomics and no cross-block reduction, so
// a rerun is bit-equal.  The epilogue writes y and s' in f32 (logistic,
// relu, tanh or identity).
//
// Precision: both precision names compute in IEEE fp32 FMA on the CUDA
// cores, as the port's other f32 kernels do; tensor cores, one persistent
// launch over the timesteps and CUDA graphs for the per-step launches are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

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

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float apply_act(float z) {
  if (ACT == kLogistic) return 1.0f / (1.0f + expf(-z));
  if (ACT == kRelu) return z > 0.0f ? z : 0.0f;
  if (ACT == kTanh) return tanhf(z);
  return z;
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
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
    // K segment 1: x · Wx_c
    for (int k = lane; k < I; k += 32) {
      const float w = wx_c[k];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        if (r < nr) acc[r] = fmaf(x[(int64_t)(r0 + r) * I + k], w, acc[r]);
    }
    // K segment 2: s · Ws_c
    for (int k = lane; k < O; k += 32) {
      const float w = ws_c[k];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        if (r < nr) acc[r] = fmaf(s[(int64_t)(r0 + r) * O + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      // xor butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(kFullMask, acc[r], off);
    }
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
