// ring_all_reduce: the one-way ring all-reduce (kernel 8), a sum over n
// ranks of a buffer of f32 or int32 values.
//
// Replaces the TPU kernel `_ring_kernel` (tensor_ops_tpu/parallel/
// collective_kernels.py), reached there through `ring_all_reduce`: n - 1
// reduce-scatter steps then n - 1 all-gather steps, every chunk sent to the
// right neighbour, two comm slots, a credit per consumed slot.  The buffer
// is viewed as n chunks of H = ceil(size / (n * 1024)) * 1024 elements (the
// TPU kernel's (n, R, 128) view); the tail past the input is zero.
//
// Two routes: ranks that share one card take the one-shot kernel
// (oneshot.cuh: one launch, each rank's input read once, each element
// folded in the ring's order); ranks on several cards take the ring protocol
// (ring.cuh: its ordering and what bounds it).
#include "oneshot.cuh"
#include "ring.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ring::kThreads)
    ring_all_reduce_kernel(const ring::RingArgs a) {
  ring::ring_body<T>(a);
}

template <typename T, int W, int MAXR>
__global__ void __launch_bounds__(oneshot::kThreads)
    ring_all_reduce_oneshot_kernel(const oneshot::Args a) {
  oneshot::body<T, W, MAXR>(a);
}

}  // namespace

// ring_all_reduce_launch / _capacity / _enable_peer: see ring.cuh (D = 1;
// phase 0 only, x_stride = x_len = H).
RING_C_ENTRIES(ring_all_reduce, ring_all_reduce_kernel, 1)
// ring_all_reduce_oneshot: see oneshot.cuh (D = 1, phase 0).
ONESHOT_C_ENTRY(ring_all_reduce, ring_all_reduce_oneshot_kernel)
