// fused_linear_w8a8: y = act((q(x) · wqᵀ) · sx · swᵀ + b), int8 x int8 -> int32.
//
// Replaces the TPU kernel `_linear_w8a8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_linear_w8a8`.  x (B, K) f32
// is quantized per row (symmetric, amax / 127, round half to even); wq (O, Kp)
// int8 holds per-output-channel codes with zero codes past K; sw (O,) and b
// (O,) f32.
//
// What bounds it on the H100: the weight codes, read once (O·K bytes), and the
// launch.  At the flagship's layers (784->300->100->10, B <= 512) the codes
// are 266 KB in all, so a request is bound by launch latency; at a 4096-wide
// layer and B = 16 the 16.8 MB of codes take 5.0 us at 3.35 TB/s.
//
// Design (int8_linear.cuh): two launches on one stream.  The first quantizes
// each row of x once (one block per row: absolute maximum, scale, codes; the
// JAX package leaves this pass to XLA around the kernel); the second is the
// product: each block copies its rows' codes to shared memory and takes
// __dp4a on packed int8x4 with an int32 accumulator (exact, so the order of
// the sums does not matter).  Tensor cores (mma.sync s8, wgmma) are later
// work.  The epilogue rescales with separately rounded multiplies and adds,
// as the plain version does, so the kernel is bit-equal to it for relu and
// identity.
#include "int8_linear.cuh"

// Plain C entry point for ctypes.  xq (B, Kp) int8 and sx (B,) f32 are
// scratch for the activation codes and scales.  rows (1, 2, 4, 8 or 16) is
// the batch tile of one block; Kp is K rounded up to 16.  Returns
// cudaGetLastError() after the launches: 0 on success.
extern "C" int fused_linear_w8a8_f32(const void* x, const void* wq,
                                     const void* sw, const void* b, void* y,
                                     void* xq, void* sx, int B, int K, int Kp,
                                     int O, int rows, int act, void* stream) {
  if (B < 1 || K < 1 || O < 1 || Kp < K || Kp % int8k::kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return int8k::launch_w8a8_layer(
      rows, static_cast<const float*>(x), static_cast<signed char*>(xq),
      static_cast<float*>(sx), static_cast<const signed char*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(b),
      static_cast<float*>(y), B, K, Kp, O, act,
      static_cast<cudaStream_t>(stream));
}
