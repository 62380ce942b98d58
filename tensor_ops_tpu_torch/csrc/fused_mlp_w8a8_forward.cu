// fused_mlp_w8a8_forward: a whole uniform-width int8 MLP, L layers of N x N.
//
// Replaces the TPU kernel `_mlp_w8a8_kernel` (tensor_ops_tpu/ops/
// pallas_kernels.py), reached there through `fused_mlp_w8a8_forward`.  For
// each layer: int8 GEMM, rescale, bias, `hidden_act`, the absolute maximum
// of each row, and requantization of the row for the next layer; the last
// layer writes raw f32 logits.
//
// What bounds it on the H100: the weight codes, L·N·N bytes, read once.  At
// the serving shape (4 x 4096, B = 16) that is 67.1 MB, more than the 50 MB
// L2, so each forward streams them from HBM: 20.0 us at 3.35 TB/s.
//
// What is hard: the row maximum crosses every output tile.  On the TPU the
// sequential grid carried it from one tile to the next; on Hopper the blocks
// of a layer run at once.  Design: each layer is two launches from this entry
// point, on one stream, so each starts only after the one before has
// finished.  The first requantizes the previous layer's f32 rows (one block
// per row takes the row's absolute maximum, exact in any order, then its
// codes); the second is the int8 product with the epilogue and the hidden
// activation (int8_linear.cuh).  The kernel boundary is the grid-wide
// barrier that the row maximum needs, and no atomics are used.  These are the
// two kernels `fused_linear_w8a8` launches, so this route is bit-equal to
// the per-layer chain; what it saves is the chain's per-layer host work
// (a Python wrapper, allocations and a ctypes call per layer).  Every layer
// spreads its N outputs over N / 32 blocks (128 at N = 4096, near one per SM
// of 132).  A single cooperative launch with a grid barrier between layers,
// which would also keep the activations on chip, is later work.
#include "int8_linear.cuh"

// Plain C entry point for ctypes.  wqs (L, N, N) int8, sws and bs (L, N)
// f32; y (B, N) f32; hbuf (2, B, N) f32 scratch for the hidden activations;
// xq (B, N) int8 and sx (B,) f32 scratch for each layer's input codes and
// scales.  rows is the batch tile of one block (1, 2, 4, 8 or 16).  Returns
// a cudaError_t: 0 on success.
extern "C" int fused_mlp_w8a8_forward_f32(const void* x, const void* wqs,
                                          const void* sws, const void* bs,
                                          void* y, void* hbuf, void* xq,
                                          void* sx, int B, int N, int L,
                                          int rows, int hidden_act,
                                          void* stream) {
  if (B < 1 || N < 1 || L < 1 || N % int8k::kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(B) * N;
  float* h = static_cast<float*>(hbuf);
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const float* in = l == 0 ? static_cast<const float*>(x)
                             : h + ((l - 1) & 1) * plane;
    float* out = last ? static_cast<float*>(y) : h + (l & 1) * plane;
    const int err = int8k::launch_w8a8_layer(
        rows, in, static_cast<signed char*>(xq), static_cast<float*>(sx),
        static_cast<const signed char*>(wqs) + static_cast<int64_t>(l) * N * N,
        static_cast<const float*>(sws) + static_cast<int64_t>(l) * N,
        static_cast<const float*>(bs) + static_cast<int64_t>(l) * N, out, B,
        N, N, N, last ? int8k::kIdentity : hidden_act, s);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
