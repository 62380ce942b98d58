// fused_mlp_train_step: one whole SGD step of an ffLayer chain — forward,
// loss, backward, update — in two launches.
//
// Replaces the TPU kernel `_mlp_train_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_mlp_train_step`.  The loss
// is either a softmax output with cross-entropy (`loss_kind` 0, the flagship
// MNIST configuration; acts[L-1] is ignored) or acts[L-1] with squared error
// summed over the outputs (`loss_kind` 1, the autoencoder configuration).
// Both are meaned over the batch, and the gradient is the mean gradient.
//
// What bounds it on the H100, and what the design does about it:
//   * The TPU kernel keeps every weight and every gradient accumulator in
//     VMEM and adds batch tiles into the accumulators in grid order,
//     updating on the last tile.  A block here has at most 227 KB of shared
//     memory, and the flagship's 266,200 f32 parameters (1.06 MB) and their
//     gradients do not fit; nor do blocks run in order.  So:
//   * phase 1 (`mlp_train_partial_kernel`): one block per batch tile of R
//     rows (R <= 16; a block walks several tiles when the batch has more
//     tiles than the wrapper's block cap).  The tile's activations stay in
//     shared memory: every layer's input h_l (the backward needs them all)
//     and two ping-pong buffers for dz.  act'(z) is computed from h =
//     act(z) (logistic h(1-h), tanh 1-h², relu h>0, identity 1), so z is
//     not kept.  For the flagship at R = 16 that is 114,880 bytes; at 32
//     rows it would leave under 3 KB and double the registers per thread.
//     Weights stream from L2 (50 MB holds them all).  The block writes its
//     PARTIAL weight, bias and loss sums to its own slot of a scratch buffer
//     that the wrapper allocates;
//   * phase 2 (`sgd_reduce_kernel`): one thread per parameter adds the
//     partials of every slot in fixed slot order and writes w - lr * sum.
//   No float atomics anywhere: every sum is taken in a fixed order, so a
//   step repeats bit for bit.
//   * Nothing is padded: rows past B are zero on input, finite through the
//     forward, and get dz = 0 and no loss, so they add exact zeros.  In the
//     squared-error mode this matters because act(b) != 0 on such rows.
//   * The cross-entropy is -sum y * log(p > 0 ? p : 1), as the TPU kernel
//     takes it (not FusedMLP._loss's log(p + 1e-30)).
// At the flagship's widths phase 1 is bound by the in-block products
// (3 x 266,200 x R FMAs per tile) and by streaming the weights through each
// block; phase 2 by reading the n_blocks partial slots (4 bytes x 266,200
// per slot).
//
// Precision: both precision names compute in IEEE fp32 FMA.  On the TPU
// "default" meant bf16 multiplies on the MXU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kOChunk = 32;  // output neurons per weight-gradient work item
constexpr int kReduceThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };
enum Loss { kSoftmaxXent = 0, kSquaredError = 1 };

struct TrainArgs {
  const float* w[kMaxLayers];  // (dims[l+1], dims[l]) row-major
  const float* b[kMaxLayers];  // (dims[l+1],)
  int64_t part_w[kMaxLayers];  // offsets of layer l's gradients in a slot
  int64_t part_b[kMaxLayers];
  int64_t part_stride;         // floats per slot (every parameter once)
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  int h_off[kMaxLayers + 1];   // shared-memory offset of layer l's input;
                               // [n_layers] holds the last layer's output
  int dz_off[2];               // the dz ping-pong pair, (width, R) layout
  int loss_off;                // R per-row losses
  int n_layers;
  int loss_kind;
  int B;
  int n_tiles;
};

struct ReduceArgs {
  const float* src[2 * kMaxLayers];  // w_0..w_{L-1}, then b_0..b_{L-1}
  float* dst[2 * kMaxLayers];
  int64_t off[2 * kMaxLayers];       // segment offset in a slot
  int64_t n[2 * kMaxLayers];         // segment length
  int64_t part_stride;
  int n_slots;
  int B;
  float lr;
};

__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case kLogistic: return 1.0f / (1.0f + expf(-z));
    case kRelu: return z > 0.0f ? z : 0.0f;
    case kTanh: return tanhf(z);
    default: return z;
  }
}

// d act / d z, from the activation's output h = act(z)
__device__ __forceinline__ float act_grad_from_out(int act, float h) {
  switch (act) {
    case kLogistic: return h * (1.0f - h);
    case kRelu: return h > 0.0f ? 1.0f : 0.0f;
    case kTanh: return 1.0f - h * h;
    default: return 1.0f;
  }
}

// Sum acc[0..R) over the warp's 32 lanes; afterwards lane L holds in acc[0]
// the sum for row L % R (the transposing butterfly of fused_mlp_forward.cu).
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

// The R values of one dz row (R consecutive floats, 16-byte aligned when
// R % 4 == 0) into registers.
template <int R>
__device__ __forceinline__ void load_dz(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
mlp_train_partial_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, float* __restrict__ part,
                         float* __restrict__ part_loss, TrainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = a.n_layers;
  const int n_out = a.dims[L];
  const float batch = static_cast<float>(a.B);
  float* slot = part + static_cast<int64_t>(blockIdx.x) * a.part_stride;
  float block_loss = 0.0f;  // thread 0's running sum, in tile order

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int row0 = tile * R;
    const int nrows = min(R, a.B - row0);

    // ---- the x tile; rows past B are zero ----
    const int k_in = a.dims[0];
    float* h0 = smem + a.h_off[0];
    for (int e = threadIdx.x; e < R * k_in; e += kThreads) {
      const int r = e / k_in, k = e - r * k_in;
      h0[e] = r < nrows ? x[static_cast<int64_t>(row0 + r) * k_in + k] : 0.0f;
    }
    __syncthreads();

    // ---- forward: one warp per output neuron, every layer's input kept ----
    for (int l = 0; l < L; ++l) {
      const float* in = smem + a.h_off[l];
      float* out = smem + a.h_off[l + 1];
      const int K = a.dims[l], O = a.dims[l + 1];
      const bool last = l == L - 1;
      const int act =
          (last && a.loss_kind == kSoftmaxXent) ? kIdentity : a.acts[l];
      for (int o = warp; o < O; o += kWarps) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* wrow = a.w[l] + static_cast<int64_t>(o) * K;
#pragma unroll 4
        for (int k = lane; k < K; k += 32) {
          const float wv = __ldg(wrow + k);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * K + k], wv, acc[r]);
        }
        warp_rows_sum<R>(acc, lane);
        if (lane < R) out[lane * O + o] = apply_act(act, acc[0] + __ldg(a.b[l] + o));
      }
      __syncthreads();
    }

    // ---- loss and the output layer's dz, one warp per row ----
    {
      const float* hl = smem + a.h_off[L];
      float* dz = smem + a.dz_off[0];
      float* row_loss = smem + a.loss_off;
      for (int r = warp; r < R; r += kWarps) {
        if (r >= nrows) {
          for (int o = lane; o < n_out; o += 32) dz[o * R + r] = 0.0f;
          if (lane == 0) row_loss[r] = 0.0f;
          continue;
        }
        const float* zr = hl + r * n_out;
        const float* yr = y + static_cast<int64_t>(row0 + r) * n_out;
        float lsum = 0.0f;
        if (a.loss_kind == kSoftmaxXent) {
          float m = -__int_as_float(0x7f800000);  // -inf
          for (int o = lane; o < n_out; o += 32) m = fmaxf(m, zr[o]);
          m = warp_max(m);
          float s = 0.0f;
          for (int o = lane; o < n_out; o += 32) s += expf(zr[o] - m);
          s = warp_sum(s);
          for (int o = lane; o < n_out; o += 32) {
            const float p = expf(zr[o] - m) / s;
            const float yv = __ldg(yr + o);
            lsum += yv * logf(p > 0.0f ? p : 1.0f);
            dz[o * R + r] = (p - yv) / batch;
          }
          lsum = -warp_sum(lsum);
        } else {
          const int act = a.acts[L - 1];
          for (int o = lane; o < n_out; o += 32) {
            const float h = zr[o];
            const float d = h - __ldg(yr + o);
            lsum += d * d;
            dz[o * R + r] = (2.0f * d) * act_grad_from_out(act, h) / batch;
          }
          lsum = warp_sum(lsum);
        }
        if (lane == 0) row_loss[r] = lsum;
      }
      __syncthreads();
      if (threadIdx.x == 0)
        for (int r = 0; r < nrows; ++r) block_loss += row_loss[r];
    }

    // ---- backward: this tile's gradient sums into the block's slot ----
    int cur = 0;
    for (int l = L - 1; l >= 0; --l) {
      const float* dzc = smem + a.dz_off[cur];
      float* dzn = smem + a.dz_off[cur ^ 1];
      const float* hin = smem + a.h_off[l];
      const int K = a.dims[l], O = a.dims[l + 1];
      float* gw = slot + a.part_w[l];
      float* gb = slot + a.part_b[l];

      // dW[o, k] = sum_r dz[r, o] h[r, k]: one item per (k, chunk of
      // outputs), so a warp's stores for one o are consecutive in k
      const int n_chunks = (O + kOChunk - 1) / kOChunk;
      for (int it = threadIdx.x; it < K * n_chunks; it += kThreads) {
        const int k = it % K, c = it / K;
        float hk[R];
#pragma unroll
        for (int r = 0; r < R; ++r) hk[r] = hin[r * K + k];
        const int o_end = min(O, (c + 1) * kOChunk);
        for (int o = c * kOChunk; o < o_end; ++o) {
          float d[R];
          load_dz<R>(dzc + o * R, d);
          float g = 0.0f;
#pragma unroll
          for (int r = 0; r < R; ++r) g = fmaf(d[r], hk[r], g);
          float* dst = gw + static_cast<int64_t>(o) * K + k;
          *dst = first ? g : *dst + g;
        }
      }
      // db[o] = sum_r dz[r, o]
      for (int o = threadIdx.x; o < O; o += kThreads) {
        float d[R];
        load_dz<R>(dzc + o * R, d);
        float g = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) g += d[r];
        gb[o] = first ? g : gb[o] + g;
      }
      // dz_{l-1}[r, k] = (sum_o dz[r, o] W[o, k]) * act'_{l-1}(h[r, k])
      if (l > 0) {
        const int act_prev = a.acts[l - 1];
        const float* wl = a.w[l];
        for (int k = threadIdx.x; k < K; k += kThreads) {
          float acc[R];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = 0.0f;
          for (int o = 0; o < O; ++o) {
            const float wv = __ldg(wl + static_cast<int64_t>(o) * K + k);
            float d[R];
            load_dz<R>(dzc + o * R, d);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = fmaf(d[r], wv, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            dzn[k * R + r] = acc[r] * act_grad_from_out(act_prev, hin[r * K + k]);
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  if (threadIdx.x == 0) part_loss[blockIdx.x] = block_loss;
}

// new = old - lr * (sum of the slots' partial gradients, in slot order);
// segment blockIdx.y is one weight or bias.  Thread (0, 0) of segment 0 also
// writes the mean loss.
__global__ void __launch_bounds__(kReduceThreads)
sgd_reduce_kernel(const float* __restrict__ part,
                  const float* __restrict__ part_loss, float* __restrict__ loss,
                  ReduceArgs a) {
  const int s = blockIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (s == 0 && j == 0) {
    float t = 0.0f;
    for (int i = 0; i < a.n_slots; ++i) t += part_loss[i];
    *loss = t / static_cast<float>(a.B);
  }
  if (j >= a.n[s]) return;
  const float* p = part + a.off[s] + j;
  float g = 0.0f;
  for (int i = 0; i < a.n_slots; ++i) g += p[static_cast<int64_t>(i) * a.part_stride];
  a.dst[s][j] = a.src[s][j] - a.lr * g;
}

int round4(int n) { return (n + 3) / 4 * 4; }

template <int R>
int launch_partial(const float* x, const float* y, float* part,
                   float* part_loss, int n_slots, const TrainArgs& a,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_partial_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_train_partial_kernel<R><<<n_slots, kThreads, smem, stream>>>(
      x, y, part, part_loss, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  `ws`, `bs`, `new_ws`, `new_bs` are host
// arrays of n_layers device pointers (f32, contiguous); `dims` has
// n_layers + 1 widths; `acts` one activation code per layer (0 identity,
// 1 logistic, 2 relu, 3 tanh); `loss_kind` 0 softmax + cross-entropy, 1
// squared error.  `rows` (1, 2, 4, 8 or 16) is the batch tile; `n_slots`
// blocks each own one slot of `part` (n_slots x every parameter) and one of
// `part_loss` (n_slots); `loss` receives the mean loss.  Returns a
// cudaError_t: 0 on success, the first failure otherwise.
extern "C" int fused_mlp_train_step_f32(
    const void* x, const void* y, int B, int rows, int n_layers,
    const void* const* ws, const void* const* bs, void* const* new_ws,
    void* const* new_bs, const int* dims, const int* acts, int loss_kind,
    float lr, int n_slots, void* part, void* part_loss, void* loss,
    void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1 || n_slots < 1 ||
      (loss_kind != kSoftmaxXent && loss_kind != kSquaredError) ||
      !(rows == 1 || rows == 2 || rows == 4 || rows == 8 || rows == 16))
    return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a;
  ReduceArgs ra;
  int smem_floats = 0, widest_out = 0;
  int64_t params = 0, widest_seg = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.dims[l] = dims[l];
    a.h_off[l] = smem_floats;
    smem_floats += round4(rows * dims[l]);
    if (l > 0) widest_out = dims[l] > widest_out ? dims[l] : widest_out;
  }
  for (int l = 0; l < n_layers; ++l) {
    const int64_t nw = static_cast<int64_t>(dims[l + 1]) * dims[l];
    a.w[l] = static_cast<const float*>(ws[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.acts[l] = acts[l];
    a.part_w[l] = params;
    a.part_b[l] = params + nw;
    ra.src[l] = a.w[l];
    ra.dst[l] = static_cast<float*>(new_ws[l]);
    ra.off[l] = params;
    ra.n[l] = nw;
    ra.src[n_layers + l] = a.b[l];
    ra.dst[n_layers + l] = static_cast<float*>(new_bs[l]);
    ra.off[n_layers + l] = params + nw;
    ra.n[n_layers + l] = dims[l + 1];
    widest_seg = nw > widest_seg ? nw : widest_seg;
    params += nw + dims[l + 1];
  }
  a.dz_off[0] = smem_floats;
  a.dz_off[1] = smem_floats + round4(rows * widest_out);
  a.loss_off = a.dz_off[1] + round4(rows * widest_out);
  smem_floats = a.loss_off + round4(rows);
  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.part_stride = params;
  a.n_layers = n_layers;
  a.loss_kind = loss_kind;
  a.B = B;
  a.n_tiles = (B + rows - 1) / rows;

  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* pf = static_cast<float*>(part);
  float* plf = static_cast<float*>(part_loss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (rows) {
    case 1: err = launch_partial<1>(xf, yf, pf, plf, n_slots, a, smem, s); break;
    case 2: err = launch_partial<2>(xf, yf, pf, plf, n_slots, a, smem, s); break;
    case 4: err = launch_partial<4>(xf, yf, pf, plf, n_slots, a, smem, s); break;
    case 8: err = launch_partial<8>(xf, yf, pf, plf, n_slots, a, smem, s); break;
    default: err = launch_partial<16>(xf, yf, pf, plf, n_slots, a, smem, s); break;
  }
  if (err != 0) return err;

  ra.part_stride = params;
  ra.n_slots = n_slots;
  ra.B = B;
  ra.lr = lr;
  const dim3 grid(static_cast<unsigned>((widest_seg + kReduceThreads - 1) / kReduceThreads),
                  static_cast<unsigned>(2 * n_layers));
  sgd_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      pf, plf, static_cast<float*>(loss), ra);
  return static_cast<int>(cudaGetLastError());
}
