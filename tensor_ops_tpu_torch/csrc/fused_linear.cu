// fused_linear: y = act(x · wᵀ + b), optionally also z = x · wᵀ + b.
//
// Replaces the TPU kernel `_linear_act_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear` ->
// `_fused_linear_fwd_impl` -> `_fused_linear_padded`.
//
// Shapes: x (B, K) row-major, w (O, K) in the ffLayer layout, b (O,) f32, z
// (B, O) f32; x, w and y are all f32 (fused_linear_f32) or all bf16
// (fused_linear_bf16).  w is read in its (O, K) layout: both operands are
// contracted on their second axis, and no transposed copy is made.
//
// bf16 operands stay bf16 in memory, as `_fused_linear_fwd_impl` keeps them
// (half the bytes); each is widened with __bfloat162float on its way into
// shared memory, the products and their sum are f32 (a bf16 x bf16 product
// is exact in f32), z is f32, and y = act(z) is rounded once to bf16 with
// __float2bfloat16_rn, as the plain version's `.to(torch.bfloat16)` does.
//
// What bounds it on the H100: at the serving path's shapes (B <= 512,
// K, O <= 784) the work is tiny (2·B·K·O <= 0.24 GFLOP) and the weight is
// read once per row tile, so at small B the kernel is bound by launch and
// memory latency, not by arithmetic.  The design is the simplest one that is
// right: a 2-D grid of 64 x 64 output tiles, a K loop over 16-deep tiles of
// x and w staged in shared memory, a 4 x 4 register tile of f32 accumulators
// per thread, and a bias + activation epilogue.  Edges are masked (loads
// give 0 outside the matrix, stores are skipped), so no operand is padded to
// the TPU's 128 lanes.
//
// Precision: both precision names ("default" and "highest") compute in IEEE
// fp32 FMA on the CUDA cores.  On the TPU "default" meant bf16 multiplies on
// the MXU; tensor cores (wgmma, TF32/bf16) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileB = 64;   // rows of x per block
constexpr int kTileO = 64;   // rows of w (output columns) per block
constexpr int kTileK = 16;   // contraction depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;      // breaks shared-memory bank conflicts on stores

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float apply_act(float z) {
  if (ACT == kLogistic) return 1.0f / (1.0f + expf(-z));
  if (ACT == kRelu) return z > 0.0f ? z : 0.0f;
  if (ACT == kTanh) return tanhf(z);
  return z;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// T: the operands' and y's type, float or __nv_bfloat16.
template <typename T, int ACT, bool SAVE_Z>
__global__ void __launch_bounds__(kThreads)
fused_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y,
                    float* __restrict__ z, int B, int K, int O) {
  // Stored k-major so the inner loop reads a row of each tile.
  __shared__ float xs[kTileK][kTileB + kPad];
  __shared__ float ws[kTileK][kTileO + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // this thread's columns: tx + 16 * j
  const int ty = tid / 16;  // this thread's rows:    ty + 16 * i
  const int row0 = blockIdx.x * kTileB;
  const int col0 = blockIdx.y * kTileO;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // 64 x 16 elements of each operand, 4 per thread; consecutive threads
    // read consecutive k, so each row segment is one coalesced read.
#pragma unroll
    for (int e = tid; e < kTileB * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < B && gk < K) ? widen(x[(int64_t)gr * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < kTileO * kTileK; e += kThreads) {
      const int c = e / kTileK, kk = e % kTileK;
      const int gc = col0 + c, gk = k0 + kk;
      ws[kk][c] = (gc < O && gk < K) ? widen(w[(int64_t)gc * K + gk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
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
      const float zz = acc[i][j] + b[c];
      const int64_t at = (int64_t)r * O + c;
      if (SAVE_Z) z[at] = zz;
      put(y + at, apply_act<ACT>(zz));
    }
  }
}

template <typename T, int ACT>
void launch(const T* x, const T* w, const float* b, T* y, float* z, int B,
            int K, int O, cudaStream_t stream) {
  const dim3 grid((B + kTileB - 1) / kTileB, (O + kTileO - 1) / kTileO);
  if (z != nullptr)
    fused_linear_kernel<T, ACT, true><<<grid, kThreads, 0, stream>>>(
        x, w, b, y, z, B, K, O);
  else
    fused_linear_kernel<T, ACT, false><<<grid, kThreads, 0, stream>>>(
        x, w, b, y, z, B, K, O);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, void* z,
             int B, int K, int O, int act, void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* bf = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  float* zf = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kIdentity: launch<T, kIdentity>(xt, wt, bf, yt, zf, B, K, O, s); break;
    case kLogistic: launch<T, kLogistic>(xt, wt, bf, yt, zf, B, K, O, s); break;
    case kRelu: launch<T, kRelu>(xt, wt, bf, yt, zf, B, K, O, s); break;
    case kTanh: launch<T, kTanh>(xt, wt, bf, yt, zf, B, K, O, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: f32 operands and y, or bf16 operands and
// y; b and z are f32 in both.  `z` may be null (no pre-activation out).
// Return cudaGetLastError() after the launch: 0 on success.
extern "C" int fused_linear_f32(const void* x, const void* w, const void* b,
                                void* y, void* z, int B, int K, int O,
                                int act, void* stream) {
  return dispatch<float>(x, w, b, y, z, B, K, O, act, stream);
}

extern "C" int fused_linear_bf16(const void* x, const void* w, const void* b,
                                 void* y, void* z, int B, int K, int O,
                                 int act, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, b, y, z, B, K, O, act, stream);
}
