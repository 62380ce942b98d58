// fused_linear_w8: y = act(x · (q · s)ᵀ + b), weight-only int8.
//
// Replaces the TPU kernel `_linear_w8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear_w8`.  x (B, K) f32;
// q (O, Kp) int8 per-output-channel codes with zero codes past K; s (O,) and
// b (O,) f32.
//
// Precision, as the TPU body states it: each code is dequantized in f32,
// float(q) * s[row].  At "default" both x and the dequantized weight are then
// rounded to bf16 and their products (exact in f32: 8 x 8 mantissa bits) are
// summed in f32; at "highest" everything stays f32.
//
// What bounds it on the H100: the codes, O·K bytes read once, and the launch.
// At the flagship's layers (266 KB of codes in all) a request is bound by
// launch latency.
//
// Design: the work split of int8_linear.cuh (32 output columns and up to 16
// batch rows per block, 4 columns per warp, lanes over K in 16-byte steps).
// The block's rows of x sit in shared memory in f32 (already rounded to bf16
// at "default"); each lane dequantizes 16 codes of a weight row at a time in
// registers and takes their products with every row.  The f32 sums are added
// over the warp by a fixed butterfly, so a rerun is bit-equal; they differ
// from the plain version's sums only in order.  Tensor cores (bf16 wgmma at
// "default") are later work.
#include <cuda_bf16.h>

#include "int8_linear.cuh"

namespace {

using int8k::kAlign;
using int8k::kFull;
using int8k::kLoadsInFlight;
using int8k::load4;
using int8k::kOutPerBlock;
using int8k::kOutPerWarp;
using int8k::kThreads;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R, bool BF16>
__global__ void __launch_bounds__(kThreads)
w8_layer_kernel(const float* __restrict__ x, const signed char* __restrict__ wq,
                const float* __restrict__ scale, const float* __restrict__ b,
                float* __restrict__ y, int B, int K, int Kp, int O, int act) {
  // The block's rows of x, as float4s in the order [row][v][chunk]: the
  // float4 v of chunk c (x[16c + 4v .. 16c + 4v + 3]) sits at
  // (r * 4 + v) * chunks + c, so the 32 lanes of a warp, one chunk each,
  // read 32 consecutive float4s.  Zero past K and past nrows.
  extern __shared__ float4 smem_x[];
  const int row0 = blockIdx.y * R;
  const int nrows = min(R, B - row0);
  const int words = Kp / 4, chunks = Kp / kAlign, total = R * words;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kLoadsInFlight) {
    float4 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int e = e0 + u * kThreads, r = e / words;
      v[u] = (e < total && r < nrows)
                 ? load4(x + (int64_t)(row0 + r) * K, 4 * (e % words), K)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        const int r = e / words, k4 = e % words;
        smem_x[(r * 4 + k4 % 4) * chunks + k4 / 4] =
            BF16 ? make_float4(to_bf16(v[u].x), to_bf16(v[u].y),
                               to_bf16(v[u].z), to_bf16(v[u].w))
                 : v[u];
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o_base = blockIdx.x * kOutPerBlock + warp * kOutPerWarp;
  float acc[R][kOutPerWarp];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) acc[r][j] = 0.0f;

  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) {
      // columns past O read row O - 1 and are never stored
      const int o = min(o_base + j, O - 1);
      const int4 q4 = __ldg(reinterpret_cast<const int4*>(wq + (int64_t)o * Kp) + c);
      const float s = __ldg(scale + o);
      const unsigned codes[4] = {static_cast<unsigned>(q4.x),
                                 static_cast<unsigned>(q4.y),
                                 static_cast<unsigned>(q4.z),
                                 static_cast<unsigned>(q4.w)};
      float w[kAlign];
#pragma unroll
      for (int i = 0; i < kAlign; ++i) {
        // byte i % 4 of word i / 4, sign-extended
        const int q = static_cast<signed char>(codes[i / 4] >> (8 * (i % 4)));
        const float d = __fmul_rn(static_cast<float>(q), s);
        w[i] = BF16 ? to_bf16(d) : d;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          float a = acc[r][j];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 xv = smem_x[(r * 4 + v) * chunks + c];
            a = fmaf(xv.x, w[4 * v + 0], a);
            a = fmaf(xv.y, w[4 * v + 1], a);
            a = fmaf(xv.z, w[4 * v + 2], a);
            a = fmaf(xv.w, w[4 * v + 3], a);
          }
          acc[r][j] = a;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j)
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        acc[r][j] += __shfl_xor_sync(kFull, acc[r][j], off);

  // every lane holds every sum; lane l finishes sums l and l + 32
  float bj[kOutPerWarp];
#pragma unroll
  for (int j = 0; j < kOutPerWarp; ++j) bj[j] = __ldg(b + min(o_base + j, O - 1));
#pragma unroll
  for (int half = 0; half < (R * kOutPerWarp + 31) / 32; ++half) {
    const int idx = lane + 32 * half;
    const int r = idx / kOutPerWarp, j = idx % kOutPerWarp;
    float a = 0.0f, bias = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int jj = 0; jj < kOutPerWarp; ++jj)
        if (rr * kOutPerWarp + jj == idx) a = acc[rr][jj];
#pragma unroll
    for (int jj = 0; jj < kOutPerWarp; ++jj)
      if (jj == j) bias = bj[jj];
    if (idx < R * kOutPerWarp && r < nrows && o_base + j < O)
      y[(int64_t)(row0 + r) * O + o_base + j] = int8k::apply_act(act, a + bias);
  }
}

template <int R, bool BF16>
int launch(const float* x, const signed char* wq, const float* scale,
           const float* b, float* y, int B, int K, int Kp, int O, int act,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(R) * Kp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8_layer_kernel<R, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((O + kOutPerBlock - 1) / kOutPerBlock, (B + R - 1) / R);
  w8_layer_kernel<R, BF16><<<grid, kThreads, smem, stream>>>(
      x, wq, scale, b, y, B, K, Kp, O, act);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_rows(int rows, const float* x, const signed char* wq,
                const float* scale, const float* b, float* y, int B, int K,
                int Kp, int O, int act, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<1, BF16>(x, wq, scale, b, y, B, K, Kp, O, act, s);
    case 2: return launch<2, BF16>(x, wq, scale, b, y, B, K, Kp, O, act, s);
    case 4: return launch<4, BF16>(x, wq, scale, b, y, B, K, Kp, O, act, s);
    case 8: return launch<8, BF16>(x, wq, scale, b, y, B, K, Kp, O, act, s);
    case 16: return launch<16, BF16>(x, wq, scale, b, y, B, K, Kp, O, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes.  rows (1, 2, 4, 8 or 16) is the batch tile
// of one block; Kp is K rounded up to 16; highest is 1 for "highest" (f32
// throughout), 0 for "default" (bf16 operands).  Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int fused_linear_w8_f32(const void* x, const void* wq,
                                   const void* scale, const void* b, void* y,
                                   int B, int K, int Kp, int O, int rows,
                                   int act, int highest, void* stream) {
  if (B < 1 || K < 1 || O < 1 || Kp < K || Kp % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const signed char* q = static_cast<const signed char*>(wq);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return highest ? launch_rows<false>(rows, xf, q, sf, bf, yf, B, K, Kp, O, act, s)
                 : launch_rows<true>(rows, xf, q, sf, bf, yf, B, K, Kp, O, act, s);
}
