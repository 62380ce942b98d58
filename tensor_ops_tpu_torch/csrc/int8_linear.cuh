// What the int8 kernels share: the per-row activation quantizer's scale and
// codes (row_scale, code_byte), the rescaling epilogue and the activations,
// which fused_mlp_w8a8_forward.cu also takes, so that the whole-MLP route is
// bit-equal to the per-layer chain; and the two w8a8 kernels (quantize the
// rows, then the int8 product) that `fused_linear_w8a8.cu` launches.
//
// Layout: x (B, K) f32 row-major; codes (O, Kp) int8 in the ffLayer layout,
// Kp = K rounded up to kAlign with zero codes past K (zeros add nothing to an
// int32 sum), so every weight row starts on a 16-byte boundary and is read
// with 16-byte loads.  The activation codes are (B, Kp) int8 the same way.
//
// Work split of the product: a block owns kOutPerBlock (32) output columns
// and R <= 16 batch rows; each of its 8 warps owns 4 columns, and the 32
// lanes of a warp walk K in 16-byte steps.  At a 4096-wide layer that is 128
// blocks, one per SM, each streaming 4 x 4096 weight bytes per warp.
//
// Why the rows are quantized by a launch of their own: every block of the
// product needs every code of its rows.  Quantizing them in each block's
// prologue repeated the row's K loads and IEEE divisions in all O / 32
// blocks: on the H100 (chip_smoke.py) the 4 x 4096 stack at B = 16 took
// 316 us of device time that way, and 77 us with one quantizing launch per
// layer (17 us) before the product (60 us).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOutPerWarp = 4;
constexpr int kOutPerBlock = kWarps * kOutPerWarp;
constexpr int kAlign = 16;  // codes per 16-byte load
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoadsInFlight = 4;  // 16-byte loads a thread issues at once

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case kLogistic: return 1.0f / (1.0f + expf(-z));
    case kRelu: return z > 0.0f ? z : 0.0f;
    case kTanh: return tanhf(z);
    default: return z;
  }
}

// The scale of the symmetric per-row quantizer: amax / 127 by IEEE
// division, and 1 for an all-zero row (a padded bucket row gets codes 0).
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

// clip(round_half_even(v / s), -127, 127) by IEEE division: rintf rounds
// half to even, as torch.round and jnp.round do (roundf would round half
// away from zero).
__device__ __forceinline__ unsigned code_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// (float(acc) * sx) * sw + b, each op rounded on its own so that nvcc does not
// contract it into an FMA: the op order of the plain PyTorch version.
__device__ __forceinline__ float epilogue(int acc, float sx, float sw,
                                          float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// x[k .. k + 3] of one row (k a multiple of 4), zeros past K: one 16-byte
// load when the rows are 16-byte aligned (K % 4 == 0), else four guarded ones.
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int k,
                                        int K) {
  if ((K & 3) == 0)
    return k < K ? __ldg(reinterpret_cast<const float4*>(xr + k))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < K ? __ldg(xr + k + i) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One block per row of x: the row's absolute maximum, its scale sx[row],
// and its codes (Kp bytes, zero past K), four to a 32-bit store.  Each
// thread issues kLoadsInFlight loads before it uses them.
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int K, int Kp,
                     signed char* __restrict__ codes, float* __restrict__ sx) {
  __shared__ float warp_max[kWarps];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xr = x + (int64_t)row * K;
  const int words = Kp / 4;
  constexpr int kStep = kThreads * kLoadsInFlight;
  float m = 0.0f;
  for (int w0 = threadIdx.x; w0 < words; w0 += kStep) {
    float4 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u)
      v[u] = load4(xr, 4 * (w0 + u * kThreads), K);  // zeros past the row
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u)
      m = fmaxf(fmaxf(m, fmaxf(fabsf(v[u].x), fabsf(v[u].y))),
                fmaxf(fabsf(v[u].z), fabsf(v[u].w)));
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  const float s = row_scale(m);  // a max is exact in any order
  if (threadIdx.x == 0) sx[row] = s;
  unsigned* out = reinterpret_cast<unsigned*>(codes + (int64_t)row * Kp);
  for (int w0 = threadIdx.x; w0 < words; w0 += kStep) {
    float4 v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u)
      v[u] = load4(xr, 4 * (w0 + u * kThreads), K);
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u)
      if (w0 + u * kThreads < words)  // zeros past K give codes 0
        out[w0 + u * kThreads] = code_byte(v[u].x, s) |
                                 code_byte(v[u].y, s) << 8 |
                                 code_byte(v[u].z, s) << 16 |
                                 code_byte(v[u].w, s) << 24;
  }
}

// y = act((codes · wqᵀ) · sx · swᵀ + b) for R rows and 32 columns per block.
template <int R>
__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const signed char* __restrict__ xq,
                 const float* __restrict__ sx,
                 const signed char* __restrict__ wq,
                 const float* __restrict__ sw, const float* __restrict__ b,
                 float* __restrict__ y, int B, int Kp, int O, int act) {
  extern __shared__ int4 smem_codes[];  // R x Kp codes, zero past nrows
  const int row0 = blockIdx.y * R;
  const int nrows = min(R, B - row0);
  const int chunks = Kp / kAlign;
  const int4* src = reinterpret_cast<const int4*>(xq + (int64_t)row0 * Kp);
  for (int e0 = threadIdx.x; e0 < R * chunks;
       e0 += kThreads * 2 * kLoadsInFlight) {
    int4 v[2 * kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < 2 * kLoadsInFlight; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < nrows * chunks ? __ldg(src + e) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 2 * kLoadsInFlight; ++u)
      if (e0 + u * kThreads < R * chunks) smem_codes[e0 + u * kThreads] = v[u];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o_base = blockIdx.x * kOutPerBlock + warp * kOutPerWarp;
  // columns past O read row O - 1 and are never stored
  const int4* w4[kOutPerWarp];
#pragma unroll
  for (int j = 0; j < kOutPerWarp; ++j)
    w4[j] = reinterpret_cast<const int4*>(
        wq + (int64_t)min(o_base + j, O - 1) * Kp);
  int acc[R][kOutPerWarp];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) acc[r][j] = 0;
  // The product runs on the CUDA cores' __dp4a: at 4096 x 4096, B = 16 a
  // layer takes 15 us (chip_smoke.py), three times the 5 us its HBM bytes
  // need.  The int8 tensor cores (mma.sync s8, wgmma) are the way past.
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32) {
    int4 wv[kOutPerWarp];
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j) wv[j] = __ldg(w4[j] + c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        const int4 xv = smem_codes[r * chunks + c];
#pragma unroll
        for (int j = 0; j < kOutPerWarp; ++j) {
          int a = acc[r][j];
          a = __dp4a(xv.x, wv[j].x, a);
          a = __dp4a(xv.y, wv[j].y, a);
          a = __dp4a(xv.z, wv[j].z, a);
          acc[r][j] = __dp4a(xv.w, wv[j].w, a);
        }
      }
    }
  }
  // int32 sums are exact in any order: the result does not depend on it
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kOutPerWarp; ++j)
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        acc[r][j] += __shfl_xor_sync(kFull, acc[r][j], off);

  // every lane holds every sum; lane l finishes sums l and l + 32
  float swj[kOutPerWarp], bj[kOutPerWarp];
#pragma unroll
  for (int j = 0; j < kOutPerWarp; ++j) {
    const int o = min(o_base + j, O - 1);
    swj[j] = __ldg(sw + o);
    bj[j] = __ldg(b + o);
  }
#pragma unroll
  for (int half = 0; half < (R * kOutPerWarp + 31) / 32; ++half) {
    const int idx = lane + 32 * half;
    const int r = idx / kOutPerWarp, j = idx % kOutPerWarp;
    int a = 0;
    float s = 0.0f, bias = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int jj = 0; jj < kOutPerWarp; ++jj)
        if (rr * kOutPerWarp + jj == idx) a = acc[rr][jj];
#pragma unroll
    for (int jj = 0; jj < kOutPerWarp; ++jj)
      if (jj == j) s = swj[jj], bias = bj[jj];
    if (idx < R * kOutPerWarp && r < nrows && o_base + j < O)
      y[(int64_t)(row0 + r) * O + o_base + j] =
          apply_act(act, epilogue(a, sx[row0 + r], s, bias));
  }
}

template <int R>
int launch_gemm(const signed char* xq, const float* sx, const signed char* wq,
                const float* sw, const float* b, float* y, int B, int Kp,
                int O, int act, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * Kp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_gemm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((O + kOutPerBlock - 1) / kOutPerBlock, (B + R - 1) / R);
  w8a8_gemm_kernel<R><<<grid, kThreads, smem, stream>>>(xq, sx, wq, sw, b, y,
                                                        B, Kp, O, act);
  return static_cast<int>(cudaGetLastError());
}

// One w8a8 layer on `s`: quantize the B rows of x into xq (B x Kp) and sx
// (B), then the product.  rows (1, 2, 4, 8 or 16) is the batch tile of one
// product block.  Returns a cudaError_t: 0 on success.
inline int launch_w8a8_layer(int rows, const float* x, signed char* xq,
                             float* sx, const signed char* wq, const float* sw,
                             const float* b, float* y, int B, int K, int Kp,
                             int O, int act, cudaStream_t s) {
  quantize_rows_kernel<<<B, kThreads, 0, s>>>(x, K, Kp, xq, sx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (rows) {
    case 1: return launch_gemm<1>(xq, sx, wq, sw, b, y, B, Kp, O, act, s);
    case 2: return launch_gemm<2>(xq, sx, wq, sw, b, y, B, Kp, O, act, s);
    case 4: return launch_gemm<4>(xq, sx, wq, sw, b, y, B, Kp, O, act, s);
    case 8: return launch_gemm<8>(xq, sx, wq, sw, b, y, B, Kp, O, act, s);
    case 16: return launch_gemm<16>(xq, sx, wq, sw, b, y, B, Kp, O, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace int8k
