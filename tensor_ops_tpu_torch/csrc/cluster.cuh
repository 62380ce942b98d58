// Launching a kernel as thread block clusters (Hopper), for the kernels that
// keep a working set spread over the shared memory of a cluster's blocks
// (fused_mlp_forward.cu, fused_rnn_step.cu's sequence entry).
//
// A block hands values to the cluster's blocks with st_async: an
// asynchronous store into another block's shared memory that, once done,
// counts its bytes on an mbarrier in that block; the receiver waits on its
// own mbarrier until the bytes it expects have all arrived.  No block waits
// for the whole cluster, and the sender does not wait for its stores.
//
// A cluster of more than 8 blocks is "non-portable": the kernel must allow
// it (cudaFuncAttributeNonPortableClusterSizeAllowed), and a card whose
// GPCs cannot place it refuses the launch, which then returns an error from
// cudaLaunchKernelEx / cudaGetLastError and never runs.  max_clusters says
// beforehand how many such clusters the card holds at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster {

constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

// Once per card and kernel: allow the largest dynamic shared memory and a
// non-portable cluster size (function attributes are host calls that cost
// microseconds, so they are not repeated per launch).
template <auto Kernel>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `addr` (this block's shared memory) in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible to the cluster (before the
// cluster barrier that precedes the first st_async).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arms the mbarrier's current phase (count 1) to complete once `bytes`
// more bytes have arrived; bytes that arrived before it count too.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }" :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

constexpr uint64_t kWaitLimitNs = 10000000000ull;  // a lost phase traps

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed; what the stores
// counted on it wrote is visible after.  A phase that never completes (a
// fault in the protocol) traps after kWaitLimitNs instead of hanging: the
// launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if ((i & 255) == 255) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kWaitLimitNs) __trap();
    }
  }
}

// v into the float at cluster address `dst`, its 4 bytes counted on the
// mbarrier at cluster address `bar` (both of one block, from map_rank).
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// v0, v1 into the two floats at cluster address `dst` (8-byte aligned),
// their 8 bytes counted as st_async counts them.
__device__ __forceinline__ void st_async2(uint32_t dst, float v0, float v1,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];" :: "r"(dst), "r"(__float_as_uint(v0)),
      "r"(__float_as_uint(v1)), "r"(bar) : "memory");
}

// v into the four floats at cluster address `dst` (16-byte aligned), their
// 16 bytes counted as st_async counts them.
__device__ __forceinline__ void st_async4(uint32_t dst, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" :: "r"(dst), "r"(__float_as_uint(v.x)),
      "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

// A launch of `clusters` clusters of `size` blocks of `threads` threads.
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  Config(int size, int clusters, int threads, size_t smem,
         cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(clusters * size);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launches Kernel(args...); returns the launch's error, else
// cudaGetLastError(): 0 on success.
template <auto Kernel, class... Args>
int launch(int size, int clusters, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = configure<Kernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Config c(size, clusters, threads, smem, stream);
  e = cudaLaunchKernelEx(&c.cfg, Kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// How many clusters of `size` blocks of Kernel the current card holds at
// once (cudaOccupancyMaxActiveClusters), into *out.  Returns a cudaError_t.
template <auto Kernel>
int max_clusters(int size, int threads, size_t smem, int* out) {
  *out = 0;
  cudaError_t e = configure<Kernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Config c(size, 1, threads, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, Kernel, &c.cfg));
}

}  // namespace cluster
