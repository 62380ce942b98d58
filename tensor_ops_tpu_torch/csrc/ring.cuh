// ring.cuh: the ring collective shared by csrc/ring_all_reduce.cu (kernel 8,
// the one-way ring) and csrc/bidir_ring.cu (kernel 9, the bidirectional
// ring and its reduce-scatter and all-gather phases).
//
// Replaces the TPU kernels `_ring_kernel` and `_bidir_ring_kernel`
// (tensor_ops_tpu/parallel/collective_kernels.py).  There each device of the
// mesh axis ran the kernel body; a step sent one chunk to a neighbour with a
// remote DMA into one of two comm slots, the DMA semaphores ordered it, and a
// REGULAR semaphore carried a "slot freed" credit back to the sender.
//
// Here a rank is a set of blocks.  All ranks of a card run in ONE cooperative
// launch (blockIdx.y = the rank's place in the launch), so every rank's
// blocks are resident at once and a rank may wait on its neighbour without
// deadlock; cudaLaunchCooperativeKernel refuses a grid that cannot be
// resident instead of hanging.  Ranks on other cards run in their own
// launch on their own card and reach their neighbours' memory over peer
// access.  Block b of a rank runs an independent sub-ring over elements
// [b*sub, (b+1)*sub) of every chunk, with flags of its own.
//
// Per rank, in its card's memory: the output buffer (n chunks of D pieces
// of H elements; D = 1 for the one-way ring, 2 for the bidirectional one,
// piece d travelling in direction d: 0 to the right, 1 to the left), the
// comm slots (D directions x 2 slots x H) and 64-bit flags (D directions x
// {slot 0 received, slot 1 received, credit} x blocks).
//
// The protocol, per block and direction, step s, slot s % 2:
//   * from step 2 on, wait for one credit: the receiver has consumed step
//     s - 2, so the slot it used is free;
//   * send: store the piece into the neighbour's slot, fence, then a
//     release store of the neighbour's "received" flag for that slot
//     (the remote copy plus its DMA semaphore);
//   * start every direction's send before waiting on any receive;
//   * receive: an acquire load of the own flag, then read the slot through
//     L2 (__ldcg: another SM or card wrote it, L1 may hold an old line),
//     out[recv] = out[recv] + got (reduce) or got (gather);
//   * credit the sender: fence, then a release store into its credit word;
//   * at the end, drain: wait until the last min(2, n_steps) credits are in,
//     so no slot still holds data when the next call writes it.
// Flags never go back to zero.  Every value stored is a tag (epoch << 20) |
// (s + 1), epoch a per-scratch call counter that the wrapper raises by one
// per call, and every wait is `flag >= tag`: a flag left by an earlier call
// holds a smaller epoch and can never satisfy this call's wait; a credit is
// the receiver's progress, so a later credit implies the earlier ones.
//
// No float atomics: each element of chunk c is summed in the fixed ring
// order of the TPU kernel with a plain rounded add (__fadd_rn, never an
// FMA), so the result is bit-equal to the plain version in
// tensor_ops_tpu_torch/parallel/collective_kernels.py.  int32 adds wrap.
//
// What bounds it: each step moves one chunk (n_dirs pieces of H elements)
// per rank through a slot, a store and a load through L2, and waits on a
// neighbour's flag; on one card the flags' round trip through L2 (a few
// microseconds) dominates at the flagship's sizes, and bytes at large ones.
// A wait that outlasts kTimeoutNs traps, so a protocol fault fails the
// launch instead of hanging the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int kThreads = 256;
// Ranks of one launch (one card).  The data-parallel step runs 4 and the
// smoke test at most 8; the wrapper refuses more with a ValueError.
constexpr int kMaxLocalRanks = 16;
constexpr unsigned long long kTimeoutNs = 20ull * 1000 * 1000 * 1000;
enum Phase { kAllReduce = 0, kReduceScatter = 1, kAllGather = 2 };
enum DType { kF32 = 0, kI32 = 1 };

// Where a rank's comm slots and flags live: device addresses, readable from
// every card that takes part (peer access).
struct RemoteRank {
  unsigned long long slots;
  unsigned long long flags;
};

// One launch's arguments, passed by value in the kernel's parameter space
// (about 400 bytes).  x[y], out[y] and rank[y] belong to the rank whose
// blocks have blockIdx.y == y.
struct RingArgs {
  const void* x[kMaxLocalRanks];
  void* out[kMaxLocalRanks];
  int rank[kMaxLocalRanks];
  const RemoteRank* table;      // n entries, on this card
  long long H;                  // elements of one piece
  long long sub;                // elements per block of one piece
  long long x_stride;           // input elements between chunks (0 for ag)
  long long x_len;              // input elements of one chunk
  long long x_size;             // input elements in all
  unsigned long long epoch;
  int n;                        // ring size
  int D;                        // directions: 1 or 2
  int phase;
  int nb_cap;                   // blocks per rank the flags have room for
  int sys;                      // 1: ranks on several cards (system scope)
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p, int sys) {
  unsigned long long v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v, int sys) {
  if (sys)
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence(int sys) {
  if (sys) __threadfence_system();
  else __threadfence();
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *p >= want; trap after kTimeoutNs.
__device__ __forceinline__ void wait_geq(const unsigned long long* p,
                                         unsigned long long want, int sys) {
  if (ld_acquire(p, sys) >= want) return;
  const unsigned long long t0 = now_ns();
  while (ld_acquire(p, sys) < want) {
    __nanosleep(32);
    if (now_ns() - t0 > kTimeoutNs) __trap();
  }
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <typename V>
__device__ __forceinline__ V add4(V a, V b) {
  a.x = add(a.x, b.x);
  a.y = add(a.y, b.y);
  a.z = add(a.z, b.z);
  a.w = add(a.w, b.w);
  return a;
}

// The block stores len elements (a multiple of 4, 16-byte aligned) into a
// neighbour's slot.
template <typename T>
__device__ __forceinline__ void put(T* dst, const T* src, long long len) {
  using V = typename Vec4<T>::type;
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (long long i = threadIdx.x; i < len / 4; i += blockDim.x)
    __stcg(d + i, s[i]);
}

// out = out + slot (reduce) or slot (gather), the slot read through L2.
template <typename T>
__device__ __forceinline__ void take(T* out, const T* slot, long long len,
                                     bool accum) {
  using V = typename Vec4<T>::type;
  V* o = reinterpret_cast<V*>(out);
  const V* s = reinterpret_cast<const V*>(slot);
  for (long long i = threadIdx.x; i < len / 4; i += blockDim.x) {
    V got = __ldcg(s + i);
    o[i] = accum ? add4(o[i], got) : got;
  }
}

__device__ __forceinline__ unsigned long long tag(unsigned long long epoch,
                                                  int s) {
  return (epoch << 20) | static_cast<unsigned long long>(s + 1);
}

// The chunk a rank sends and the chunk it receives into at step s, in the
// clockwise direction (the TPU kernels' index math), and whether it adds.
__device__ __forceinline__ void cw_indices(int phase, int n, int me, int s,
                                           int* send, int* recv,
                                           bool* accum) {
  if (phase == kAllReduce) {
    if (s < n - 1) {
      *send = (me - s + 2 * n) % n;
      *recv = (me - s - 1 + 2 * n) % n;
      *accum = true;
    } else {
      const int s2 = s - (n - 1);
      *send = (me + 1 - s2 + 2 * n) % n;
      *recv = (me - s2 + 2 * n) % n;
      *accum = false;
    }
  } else if (phase == kReduceScatter) {
    *send = (me - s - 1 + 2 * n) % n;
    *recv = (me - s - 2 + 2 * n) % n;
    *accum = true;
  } else {
    *send = (me - s + 2 * n) % n;
    *recv = (me - s - 1 + 2 * n) % n;
    *accum = false;
  }
}

template <typename T>
__device__ __forceinline__ void ring_body(const RingArgs& a) {
  const int b = blockIdx.x;
  const int me = a.rank[blockIdx.y];
  const T* x = static_cast<const T*>(a.x[blockIdx.y]);
  T* out = static_cast<T*>(a.out[blockIdx.y]);
  const RemoteRank* table = a.table;
  const int n = a.n, D = a.D, phase = a.phase, sys = a.sys;
  const long long H = a.H, CH = static_cast<long long>(D) * H;
  const long long lo = static_cast<long long>(b) * a.sub;
  const long long len = a.sub < H - lo ? a.sub : H - lo;
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const int n_steps = phase == kAllReduce ? 2 * (n - 1) : n - 1;
  T* my_slots = reinterpret_cast<T*>(table[me].slots);
  unsigned long long* my_flags =
      reinterpret_cast<unsigned long long*>(table[me].flags);
  const long long nb_cap = a.nb_cap;
  auto flag = [nb_cap, b](unsigned long long* base, int d, int kind) {
    return base + ((d * 3 + kind) * nb_cap + b);
  };

  // the input into this block's share of the output, zeros past the input
  // (all-gather: only the own chunk; the rotation fills the rest)
  for (int c = 0; c < n; ++c) {
    if (phase == kAllGather && c != me) continue;
    const long long base = phase == kAllGather ? 0 : c * a.x_stride;
    for (int d = 0; d < D; ++d)
      for (long long j = lo + threadIdx.x; j < lo + len; j += blockDim.x) {
        const long long pos = d * H + j, idx = base + pos;
        out[c * CH + pos] =
            (pos < a.x_len && idx < a.x_size) ? x[idx] : static_cast<T>(0);
      }
  }
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    if (s >= 2) {
      if (threadIdx.x == 0)
        for (int d = 0; d < D; ++d)
          wait_geq(flag(my_flags, d, 2), tag(a.epoch, s - 2), sys);
      __syncthreads();
    }
    int send[2], recv[2];
    bool accum;
    cw_indices(phase, n, me, s, &send[0], &recv[0], &accum);
    // ccw mirrors cw: 2 me + 2 n - x
    send[1] = (2 * me + 2 * n - send[0]) % n;
    recv[1] = (2 * me + 2 * n - recv[0]) % n;
    for (int d = 0; d < D; ++d) {
      const int dest = d == 0 ? right : left;
      T* dst = reinterpret_cast<T*>(table[dest].slots) + (d * 2 + slot) * H + lo;
      put(dst, out + send[d] * CH + d * H + lo, len);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      fence(sys);
      for (int d = 0; d < D; ++d) {
        const int dest = d == 0 ? right : left;
        st_release(flag(reinterpret_cast<unsigned long long*>(table[dest].flags),
                        d, slot),
                   tag(a.epoch, s), sys);
      }
    }
    // both directions' receives behind one barrier each way: the sends
    // are already in flight
    if (threadIdx.x == 0)
      for (int d = 0; d < D; ++d)
        wait_geq(flag(my_flags, d, slot), tag(a.epoch, s), sys);
    __syncthreads();
    for (int d = 0; d < D; ++d)
      take(out + recv[d] * CH + d * H + lo, my_slots + (d * 2 + slot) * H + lo,
           len, accum);
    __syncthreads();
    if (threadIdx.x == 0) {
      fence(sys);
      for (int d = 0; d < D; ++d) {
        // my slot of direction d is written by the left rank (cw) or the
        // right one (ccw): credit that sender
        const int src = d == 0 ? left : right;
        st_release(flag(reinterpret_cast<unsigned long long*>(table[src].flags),
                        d, 2),
                   tag(a.epoch, s), sys);
      }
    }
  }
  // drain: the last min(2, n_steps) credits of each direction
  if (threadIdx.x == 0)
    for (int d = 0; d < D; ++d)
      wait_geq(flag(my_flags, d, 2), tag(a.epoch, n_steps - 1), sys);
}

// The C launch entry of both libraries: kf32 / ki32 are the library's
// kernel for f32 / int32, D its directions (1 one-way, 2 bidirectional).
// One launch runs the n_local ranks of one card: ranks[y] is the global rank
// whose input xs[y] goes into outs[y] (n chunks of D * H elements); input
// element c * x_stride + j lands at element j of chunk c when j < x_len and
// the index is below x_size (ag: the shard into chunk ranks[y] only).
// `table` (n entries, device memory of this card) gives every rank's comm
// slots and flags.  Each rank runs nb blocks of sub elements of every piece;
// the flags have room for nb_cap.  dtype 0 is f32, 1 int32.  Returns a
// cudaError_t: 0 on success, cudaErrorCooperativeLaunchTooLarge (720) when
// the grid cannot be resident at once.
inline int launch(const void* kf32, const void* ki32, int D, int dtype,
                  int phase, int n, int n_local, const int* ranks,
                  const void* const* xs, void* const* outs, const void* table,
                  long long H, long long sub, int nb, int nb_cap,
                  long long x_stride, long long x_len, long long x_size,
                  unsigned long long epoch, int sys, void* stream) {
  if (n_local < 1 || n_local > kMaxLocalRanks || nb < 1 || nb > nb_cap ||
      n < 2 || (D != 1 && D != 2) || (dtype != kF32 && dtype != kI32) ||
      (phase != kAllReduce && (D != 2 || (phase != kReduceScatter &&
                                          phase != kAllGather))) ||
      H % 4 != 0 || sub % 4 != 0 || sub * nb < H || sub * (nb - 1) >= H ||
      epoch >= (1ull << 43))
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a;
  for (int y = 0; y < n_local; ++y) {
    a.x[y] = xs[y];
    a.out[y] = outs[y];
    a.rank[y] = ranks[y];
  }
  a.table = static_cast<const RemoteRank*>(table);
  a.H = H;
  a.sub = sub;
  a.x_stride = x_stride;
  a.x_len = x_len;
  a.x_size = x_size;
  a.epoch = epoch;
  a.n = n;
  a.D = D;
  a.phase = phase;
  a.nb_cap = nb_cap;
  a.sys = sys;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      dtype == kF32 ? kf32 : ki32,
      dim3(static_cast<unsigned>(nb), static_cast<unsigned>(n_local)),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks one card holds at once of either kernel (blocks per SM x SMs; 0
// when the card cannot launch cooperatively).
inline int capacity(const void* kf32, const void* ki32, int* blocks) {
  int dev = 0, sms = 0, coop = 0, f = 0, i = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kf32, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&i, ki32, kThreads, 0);
  *blocks = coop ? (f < i ? f : i) * sms : 0;
  return static_cast<int>(e);
}

// Peer access from the current card to `peer`; already enabled is success.
inline int enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(e);
}

}  // namespace ring

// The plain C entry points (for ctypes) of a library whose kernel template is
// KERNEL, with D directions: NAME_launch (ring::launch's arguments after D),
// NAME_capacity and NAME_enable_peer.
#define RING_C_ENTRIES(NAME, KERNEL, D)                                       \
  extern "C" int NAME##_launch(                                               \
      int dtype, int phase, int n, int n_local, const int* ranks,             \
      const void* const* xs, void* const* outs, const void* table,            \
      long long H, long long sub, int nb, int nb_cap, long long x_stride,     \
      long long x_len, long long x_size, unsigned long long epoch, int sys,   \
      void* stream) {                                                         \
    return ring::launch(reinterpret_cast<const void*>(KERNEL<float>),         \
                        reinterpret_cast<const void*>(KERNEL<int>), D, dtype, \
                        phase, n, n_local, ranks, xs, outs, table, H, sub,    \
                        nb, nb_cap, x_stride, x_len, x_size, epoch, sys,      \
                        stream);                                              \
  }                                                                           \
  extern "C" int NAME##_capacity(int* blocks) {                               \
    return ring::capacity(reinterpret_cast<const void*>(KERNEL<float>),       \
                          reinterpret_cast<const void*>(KERNEL<int>), blocks); \
  }                                                                           \
  extern "C" int NAME##_enable_peer(int peer) { return ring::enable_peer(peer); }
