// What the int8 kernels share: the per-row activation quantizer's scale and
// codes (row_scale, code_byte), the rescaling epilogue, the activations and
// the guarded load of four values of x.  fused_linear_w8a8.cu and
// fused_mlp_w8a8_forward.cu quantize and rescale with the same helpers, so
// the whole-MLP route is bit-equal to the chain of per-layer launches;
// fused_linear_w8.cu takes the activations.
//
// Layout: x (B, K) f32 row-major; codes (O, Kp) int8 in the ffLayer layout,
// Kp = K rounded up to kAlign with zero codes past K (zeros add nothing to an
// int32 sum), so every weight row starts on a 16-byte boundary and is read
// with 16-byte loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

constexpr int kAlign = 16;  // codes per 16-byte load
constexpr unsigned kFull = 0xffffffffu;

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
// away from zero).  A zero dividend sends the card's IEEE division to its
// slow path (relu outputs and padding are half zeros or more), and 0 / s
// gives the code 0 whatever s: so a zero divides s by itself instead and
// takes the code 0, without a branch.
__device__ __forceinline__ unsigned code_byte(float v, float s) {
  const bool zero = v == 0.0f;
  const float q =
      fminf(fmaxf(rintf(__fdiv_rn(zero ? s : v, s)), -127.0f), 127.0f);
  return zero ? 0u : static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// Four codes of one scale in one 32-bit word, v.x in the low byte.
__device__ __forceinline__ unsigned code_word(float4 v, float s) {
  return code_byte(v.x, s) | code_byte(v.y, s) << 8 |
         code_byte(v.z, s) << 16 | code_byte(v.w, s) << 24;
}

// (float(acc) * sx) * sw + b, each op rounded on its own so that nvcc does not
// contract it into an FMA: the op order of the plain PyTorch version.
__device__ __forceinline__ float epilogue(int acc, float sx, float sw,
                                          float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
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

}  // namespace int8k
