// oneshot.cuh: the one-shot collective for ranks that share one card, the
// route of csrc/ring_all_reduce.cu (kernel 8) and csrc/bidir_ring.cu (kernel
// 9) when every rank of a call sits on the same card.
//
// Replaces, for that case, the TPU kernels `_ring_kernel` and
// `_bidir_ring_kernel` (tensor_ops_tpu/parallel/collective_kernels.py).  On
// one card every rank's buffer is addressable from one launch, so no chunk
// has to travel: one launch reads each rank's input once and writes each
// rank's output once, with no comm slots, flags, scratch or cooperative
// launch.  Ranks on several cards keep the ring protocol of ring.cuh.
//
// The same bits as the ring.  IEEE addition is commutative, so a ring's sum
// of one element is fixed by the order in which it folds the ranks' values:
// a start rank and a direction round the ring.  The ring sends every piece d
// of the JAX layout (D = 1 one-way, 2 bidirectional; d = 0 travels to the
// right, d = 1 to the left) once round the ring, each receiver adding its own
// value to what arrives, so
//   ar, element i of the flat input: piece p = i / H, chunk c = p / D,
//       d = p % D; the fold starts at rank c and goes right (d = 0) or left
//       (d = 1);
//   rs, element j of rank r's block (input element r * part + j): d = j / H;
//       the fold starts at rank r + 1 going right (d = 0) or at r - 1 going
//       left (d = 1), and ends at r;
//   ag: a copy, no adds.
// Worked example, R = 4, rank values x0..x3, chunk c = 2:
//   one-way ar (D = 1; n - 1 reduce steps: rank 3 adds x3 to the x2 it gets
//       from rank 2, rank 0 adds x0, rank 1 adds x1):
//       ((x2 + x3) + x0) + x1;
//   bidirectional ar (D = 2): piece 0 ((x2 + x3) + x0) + x1,
//       piece 1 ((x2 + x1) + x0) + x3;
//   rs, rank 2's block: piece 0 ((x3 + x0) + x1) + x2,
//       piece 1 ((x1 + x0) + x3) + x2.
// Ranks of several processes on one card (parallel/collective_kernels.py
// _ipc_collective): each process launches the one-shot over every rank's
// input, the other processes' read through CUDA IPC mappings of their
// staging buffers (ipc.cuh), and writes only its own ranks' outputs (Desc
// mask; a rank of another process has no output pointer here).
// A thread folds its R values in exactly that order with __fadd_rn (never an
// FMA; int32 adds wrap), so the result equals the ring protocol and the
// plain versions in parallel/collective_kernels.py bit for bit.  An optional
// f32 scale multiplies the finished sum (__fmul_rn), as the data-parallel
// step's separate `sum * (1 / n)` did.
//
// What bounds it: bytes.  At the flagship's 300x784 f32 weight over 4 ranks
// a call reads 3.76 MB and writes 3.76 MB, 2.2 us at 3.35 TB/s, and the
// inputs are usually still in the 50 MB L2.  A thread takes 4 consecutive
// elements (16-byte loads through the read-only path) and issues all R loads
// before its first add, so R x 16 bytes are in flight per thread; 256-thread
// blocks cover the positions in one wave (230 blocks at the flagship's weight;
// the card holds 8 per SM) and stride over the rest at larger sizes.  A 4-wide
// position never straddles a piece (H is a multiple of 1,024) or an rs block
// (the C entry takes the scalar path when the size or the rs block length is
// not a multiple of 4, or a pointer is not 16-byte aligned).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace oneshot {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 16;  // ranks of one launch, as ring::kMaxLocalRanks
constexpr int kMaxDevices = 64;
enum Phase { kAllReduce = 0, kReduceScatter = 1, kAllGather = 2 };
enum DType { kF32 = 0, kI32 = 1 };

// One call shape's constants, built once by the wrapper and passed by
// pointer (the same layout as parallel/collective_kernels.py _Desc).
struct Desc {
  long long size;  // elements of one rank's input
  long long H;     // elements of one piece of the JAX layout
  long long part;  // rs: elements of one rank's block
  float scale;
  int has_scale;
  int dtype;
  int phase;
  int n;
  int D;
  int vec;  // 16-byte positions allowed (size and part multiples of 4)
  int mask;  // bit r: write rank r's output (ranks of other processes: 0)
};

// One launch's arguments, passed by value in the kernel's parameter space.
struct Args {
  const void* x[kMaxRanks];  // rank r's input: `size` elements
  void* out[kMaxRanks];      // rank r's output: size (ar), part (rs), n * size (ag)
  Desc d;
};

template <typename T, int W> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 4> { using type = int4; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<int, 1> { using type = int; };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z),
                     add(a.w, b.w));
}
__device__ __forceinline__ int4 add(int4 a, int4 b) {
  return make_int4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}
__device__ __forceinline__ float mul(float a, float s) { return __fmul_rn(a, s); }
__device__ __forceinline__ float4 mul(float4 a, float s) {
  return make_float4(mul(a.x, s), mul(a.y, s), mul(a.z, s), mul(a.w, s));
}

// Rank r's input as positions of W elements.
template <typename V>
__device__ __forceinline__ V load(const Args& a, int r, long long q) {
  return __ldg(static_cast<const V*>(a.x[r]) + q);
}

// MAXR: the smallest of 4, 8, 16 that holds n, so that the R values of a
// position live in registers without reserving 16 of them for 4 ranks.
template <typename T, int W, int MAXR>
__device__ __forceinline__ void body(const Args& a) {
  using V = typename Vec<T, W>::type;
  const Desc& d = a.d;
  const int n = d.n;
  const long long npos = d.size / W;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       q < npos; q += stride) {
    V v[MAXR];
    if (d.phase == kAllGather) {
#pragma unroll
      for (int k = 0; k < MAXR; ++k)
        if (k < n) v[k] = load<V>(a, k, q);
#pragma unroll
      for (int dst = 0; dst < MAXR; ++dst) {
        if (dst >= n || !((d.mask >> dst) & 1)) continue;
        V* o = static_cast<V*>(a.out[dst]);
#pragma unroll
        for (int k = 0; k < MAXR; ++k)
          if (k < n) o[k * npos + q] = v[k];
      }
      continue;
    }
    const long long i = q * W;
    int start, dir, own = 0;  // dir: the piece's direction, 0 right, 1 left
    if (d.phase == kAllReduce) {
      const long long p = i / d.H;
      dir = static_cast<int>(p % d.D);
      start = static_cast<int>(p / d.D);
    } else {
      own = static_cast<int>(i / d.part);
      dir = static_cast<int>((i - own * d.part) / d.H);
      start = dir == 0 ? (own + 1) % n : (own + n - 1) % n;
    }
    const int step = dir == 0 ? 1 : n - 1;
    // every load of the position before the first add
    int r = start;
#pragma unroll
    for (int k = 0; k < MAXR; ++k)
      if (k < n) {
        v[k] = load<V>(a, r, q);
        r += step;
        if (r >= n) r -= n;
      }
    V acc = v[0];
#pragma unroll
    for (int k = 1; k < MAXR; ++k)
      if (k < n) acc = add(acc, v[k]);
    if constexpr (std::is_same<T, float>::value)
      if (d.has_scale) acc = mul(acc, d.scale);
    if (d.phase == kAllReduce) {
#pragma unroll
      for (int k = 0; k < MAXR; ++k)
        if (k < n && ((d.mask >> k) & 1)) static_cast<V*>(a.out[k])[q] = acc;
    } else if ((d.mask >> own) & 1) {
      static_cast<V*>(a.out[own])[q - own * (d.part / W)] = acc;
    }
  }
}

// Blocks of kThreads that the current card holds at once (2,048 threads per
// SM), asked once per card.
inline int wave_blocks(int* blocks) {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return 0;
  }
  int sms = 0, threads = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = sms * (threads / kThreads);
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return 0;
}

// Checks one call's arguments and fills `a`, the grid and the position
// width: ptrs holds the n inputs, then the n outputs; 16-byte positions when
// the shape allows them and every pointer is 16-byte aligned.  *blocks is 0
// when there is nothing to do.  Returns a cudaError_t.
inline int prepare(const Desc& d, const void* const* ptrs, Args* a,
                   int* blocks, int* W) {
  const int n = d.n;
  if (n < 2 || n > kMaxRanks || (d.dtype != kF32 && d.dtype != kI32) ||
      (d.D != 1 && d.D != 2) || d.size < 0 ||
      (d.phase != kAllReduce && d.phase != kReduceScatter &&
       d.phase != kAllGather) ||
      (d.has_scale && (d.dtype != kF32 || d.phase == kAllGather)) ||
      (d.phase != kAllGather && d.size > 0 && (d.H <= 0 || d.H % 4 != 0)) ||
      (d.phase == kReduceScatter && (d.part < 0 || d.part * n != d.size)) ||
      (d.vec && (d.size % 4 != 0 ||
                 (d.phase == kReduceScatter && d.part % 4 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  bool aligned = true;
  for (int r = 0; r < 2 * n; ++r)
    aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[r]) % 16 == 0;
  *W = d.vec && aligned ? 4 : 1;
  for (int r = 0; r < n; ++r) {
    a->x[r] = ptrs[r];
    a->out[r] = const_cast<void*>(ptrs[n + r]);
  }
  a->d = d;
  *blocks = 0;
  const long long npos = d.size / *W;
  if (npos == 0) return 0;
  int wave = 0;
  const int e = wave_blocks(&wave);
  if (e != 0) return e;
  const long long need = (npos + kThreads - 1) / kThreads;
  *blocks = static_cast<int>(need < wave ? need : wave);
  return 0;
}

}  // namespace oneshot

// The C entry NAME_oneshot (for ctypes) of a library whose kernel template
// KERNEL<T, W, MAXR> runs oneshot::body: one launch on the stream ptrs[2n]
// (after the n inputs and the n outputs), f32 or int32 as d->dtype says.
// Returns a cudaError_t: 0 on success.
#define ONESHOT_C_ENTRY(NAME, KERNEL)                                          \
  namespace {                                                                  \
  template <typename T, int W>                                                 \
  void NAME##_oneshot_go(const oneshot::Args& a, int blocks, cudaStream_t s) { \
    if (a.d.n <= 4)                                                            \
      KERNEL<T, W, 4><<<blocks, oneshot::kThreads, 0, s>>>(a);                 \
    else if (a.d.n <= 8)                                                       \
      KERNEL<T, W, 8><<<blocks, oneshot::kThreads, 0, s>>>(a);                 \
    else                                                                       \
      KERNEL<T, W, 16><<<blocks, oneshot::kThreads, 0, s>>>(a);                \
  }                                                                            \
  }                                                                            \
  extern "C" int NAME##_oneshot(const oneshot::Desc* d,                        \
                                const void* const* ptrs) {                     \
    oneshot::Args a;                                                           \
    int blocks = 0, W = 1;                                                     \
    const int err = oneshot::prepare(*d, ptrs, &a, &blocks, &W);               \
    if (err != 0 || blocks == 0) return err;                                   \
    cudaStream_t s =                                                           \
        static_cast<cudaStream_t>(const_cast<void*>(ptrs[2 * d->n]));          \
    if (d->dtype == oneshot::kF32) {                                           \
      if (W == 4) NAME##_oneshot_go<float, 4>(a, blocks, s);                   \
      else NAME##_oneshot_go<float, 1>(a, blocks, s);                          \
    } else {                                                                   \
      if (W == 4) NAME##_oneshot_go<int, 4>(a, blocks, s);                     \
      else NAME##_oneshot_go<int, 1>(a, blocks, s);                            \
    }                                                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }
