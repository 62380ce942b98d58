// fused_mlp_forward: a whole ffLayer chain's forward in one launch.
//
// Replaces the TPU kernel `_mlp_kernel` (tensor_ops_tpu/ops/pallas_kernels.py),
// reached there through `fused_mlp_forward`.  For each layer l,
// h <- act_l(h · W_lᵀ + b_l); with `softmax_out` the last layer is instead a
// softmax over its real output width.
//
// What bounds it on the H100: on the TPU every weight stays in VMEM for the
// whole chain.  Here a block has at most 227 KB of shared memory, and the
// flagship's 266,200 f32 parameters (about 1.06 MB) do not fit.  What does
// fit is one batch tile's activations, so the design is:
//   * one block per tile of `rows` batch rows (rows <= 32);
//   * the tile's activations stay in shared memory for the whole chain, in
//     two ping-pong buffers of `rows x stride` floats (stride = the widest
//     layer, rounded to an odd count so the per-row stores hit distinct
//     banks);
//   * the weights stream from global memory and L2 (50 MB holds them all):
//     one warp per output neuron reads that neuron's weight row with
//     coalesced loads, every lane keeps one f32 partial sum per tile row,
//     and a transposing butterfly of warp shuffles leaves lane r with the
//     sum for row r;
//   * the softmax is a per-row max/sum reduction inside the block, over the
//     real classes only: nothing is padded, so there are no lanes to mask.
// At small batch this launches few blocks (one at B = 8), so it is bound by
// the latency of streaming the weights through one SM, not by arithmetic.
//
// Precision: both precision names ("default" and "highest") compute in IEEE
// fp32 FMA.  On the TPU "default" meant bf16 multiplies on the MXU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

struct MlpArgs {
  const float* w[kMaxLayers];  // (dims[l+1], dims[l]) row-major
  const float* b[kMaxLayers];  // (dims[l+1],)
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
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

template <int R>
__global__ void __launch_bounds__(kThreads)
mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ y, int B,
                   int rows, MlpArgs a) {
  extern __shared__ float smem[];
  // buffer i of the ping-pong pair (arithmetic, so no local-memory array)
  const int buf_floats = rows * a.stride;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int k_in = a.dims[0];
  for (int e = threadIdx.x; e < nrows * k_in; e += kThreads) {
    const int r = e / k_in, k = e % k_in;
    smem[r * a.stride + k] = x[(int64_t)(row0 + r) * k_in + k];
  }
  __syncthreads();

  for (int l = 0; l < a.n_layers; ++l) {
    const float* in = smem + (l & 1) * buf_floats;
    float* out = smem + ((l + 1) & 1) * buf_floats;
    const int K = a.dims[l], O = a.dims[l + 1];
    const bool last = l == a.n_layers - 1;
    const int act = (last && a.softmax_out) ? kIdentity : a.acts[l];
    for (int o = warp; o < O; o += kWarps) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const float* wrow = a.w[l] + (int64_t)o * K;
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        const float wv = __ldg(wrow + k);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < nrows) acc[r] = fmaf(in[r * a.stride + k], wv, acc[r]);
      }
      warp_rows_sum<R>(acc, lane);
      if (lane < R && lane < nrows)
        out[lane * a.stride + o] = apply_act(act, acc[0] + __ldg(a.b[l] + o));
    }
    __syncthreads();
  }

  const float* h = smem + (a.n_layers & 1) * buf_floats;
  const int n_out = a.dims[a.n_layers];
  if (!a.softmax_out) {
    for (int e = threadIdx.x; e < nrows * n_out; e += kThreads) {
      const int r = e / n_out, o = e % n_out;
      y[(int64_t)(row0 + r) * n_out + o] = h[r * a.stride + o];
    }
    return;
  }
  // softmax(z) = exp(z - max z) / sum exp(z - max z), one warp per row
  for (int r = warp; r < nrows; r += kWarps) {
    const float* z = h + r * a.stride;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int o = lane; o < n_out; o += 32) m = fmaxf(m, z[o]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float s = 0.0f;
    for (int o = lane; o < n_out; o += 32) s += expf(z[o] - m);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    float* yrow = y + (int64_t)(row0 + r) * n_out;
    for (int o = lane; o < n_out; o += 32) yrow[o] = expf(z[o] - m) / s;
  }
}

template <int R>
int launch(const float* x, float* y, int B, int rows, const MlpArgs& a,
           cudaStream_t stream) {
  const size_t smem = 2ull * rows * a.stride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_forward_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + rows - 1) / rows;
  mlp_forward_kernel<R><<<grid, kThreads, smem, stream>>>(x, y, B, rows, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  `ws` and `bs` are host arrays of
// n_layers device pointers; `dims` has n_layers + 1 widths; `acts` holds one
// activation code per layer (0 identity, 1 logistic, 2 relu, 3 tanh).
// Returns a cudaError_t: 0 on success.
extern "C" int fused_mlp_forward_f32(const void* x, void* y, int B, int rows,
                                     int n_layers, const void* const* ws,
                                     const void* const* bs, const int* dims,
                                     const int* acts, int softmax_out,
                                     int stride, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || rows < 1 || rows > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpArgs a;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(ws[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.acts[l] = acts[l];
  }
  for (int l = 0; l <= n_layers; ++l) a.dims[l] = dims[l];
  a.n_layers = n_layers;
  a.softmax_out = softmax_out;
  a.stride = stride;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 1) return launch<1>(xf, yf, B, rows, a, s);
  if (rows <= 2) return launch<2>(xf, yf, B, rows, a, s);
  if (rows <= 4) return launch<4>(xf, yf, B, rows, a, s);
  if (rows <= 8) return launch<8>(xf, yf, B, rows, a, s);
  if (rows <= 16) return launch<16>(xf, yf, B, rows, a, s);
  return launch<32>(xf, yf, B, rows, a, s);
}
