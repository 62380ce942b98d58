// bidir_ring: the bidirectional ring (kernel 9) in its three phases, over
// f32 or int32 values:
//   phase 0 'ar' — all-reduce: n - 1 reduce-scatter steps, then n - 1
//                  all-gather steps;
//   phase 1 'rs' — reduce-scatter (psum_scatter, tiled): chunk me ends
//                  fully reduced on rank me;
//   phase 2 'ag' — all-gather (tiled): rank me starts with its shard in
//                  chunk me and ends with every chunk.
//
// Replaces the TPU kernel `_bidir_ring_kernel` (tensor_ops_tpu/parallel/
// collective_kernels.py), reached there through `_bidir_call` from
// `ring_all_reduce_bidir`, `ring_reduce_scatter` and `ring_all_gather`.
// Every chunk is two pieces of H elements: piece 0 travels to the right,
// piece 1 to the left, with slots, flags and credits of its own per
// direction; each step starts both sends before waiting on either receive.
// The ccw index math mirrors the cw one (2 me + 2 n - x).
//
// Two routes: ranks that share one card take the one-shot kernel
// (oneshot.cuh: one launch, each element folded in the order its piece
// travels); ranks on several cards take the ring protocol (ring.cuh: its
// ordering and what bounds it).
#include "ipc.cuh"
#include "oneshot.cuh"
#include "ring.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ring::kThreads)
    bidir_ring_kernel(const ring::RingArgs a) {
  ring::ring_body<T>(a);
}

template <typename T, int W, int MAXR>
__global__ void __launch_bounds__(oneshot::kThreads)
    bidir_ring_oneshot_kernel(const oneshot::Args a) {
  oneshot::body<T, W, MAXR>(a);
}

}  // namespace

// bidir_ring_launch / _capacity / _enable_peer: see ring.cuh (D = 2).
RING_C_ENTRIES(bidir_ring, bidir_ring_kernel, 2)
// bidir_ring_oneshot: see oneshot.cuh (D = 2, every phase).
ONESHOT_C_ENTRY(bidir_ring, bidir_ring_oneshot_kernel)
// bidir_ring_ipc_*: see ipc.cuh (ranks of several processes).
IPC_C_ENTRIES(bidir_ring)
