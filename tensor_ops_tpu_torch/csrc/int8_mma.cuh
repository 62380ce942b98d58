// What the int8 tensor-core kernels share: the m16n8k32 s8 product, the
// k order of its fragments, and the 16-byte asynchronous copies that stream
// operands into shared memory, counted on an mbarrier
// (fused_mlp_w8a8_forward.cu takes them all; fused_linear_w8a8.cu the
// product and its k order, its weights loaded straight into registers).
//
// The copies: a stage's operands, rows of kc bytes at a stride of N, each
// come by one Tensor Memory Accelerator copy of a 3-D box (tma_load_3d:
// rows x kc / 128 x 128 bytes, 32 KB of weights at kc = 1024) into dense
// rows.  On the H100 (probes with %globaltimer stamps) one bulk copy per
// 1 KB row held the weights at about 10 GB/s per SM, the unit taking the
// copies one after another; and 16-byte cp.async from every thread queued
// the codes behind the next layer's weights in the SM's load queue and
// held the stage barrier while 64 KB of them were being issued.
//
// The product: mma.sync.m16n8k32.row.col.s32.s8.s8.s32, A 16 rows x 32 k of
// activation codes, B 32 k x 8 columns of weight codes stored as they are
// in memory, (O, Kp) row-major, which is the `col` operand itself; int32
// sums, exact in any order.
//
// The k order.  The PTX fragment of m16n8k32 gives lane (g, t) = (lane / 4,
// lane % 4) the k bytes 4t..4t+3 ("low") and 16+4t..16+4t+3 ("high") of its
// A rows g and g + 8 and of its B column g.  An int32 sum over k does not
// depend on which physical k a product slot holds, as long as A and B put
// the same physical k there.  So a lane reads 16 contiguous bytes at 16t of
// a 64-byte chunk for each of its rows and columns (one 16-byte shared-memory
// load) and feeds two products: the first takes bytes 0-3 as low and 4-7 as
// high, the second 8-11 and 12-15.  Over t and the two products that is
// every byte of the chunk once, in A and in B alike.
//
// Staged rows are dense (the tensor copy's box), kc a multiple of 128
// bytes: the 8 lanes of a quarter-warp, 2 rows x 4 chunks of 16 bytes, meet
// in 16 banks, a 2-way conflict.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace int8mma {

constexpr int kChunk = 64;  // k of one 16-byte fragment load: two products

// d += a · b on the int8 tensor cores (one m16n8k32 product).
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two products of one 64-byte chunk (see the k order above) into acc:
// lo and hi are the 16 bytes of A rows g and g + 8, w those of B column g.
__device__ __forceinline__ void mma_chunk(int (&acc)[4], uint4 lo, uint4 hi,
                                          uint4 w) {
  mma_s8(acc, lo.x, hi.x, lo.y, hi.y, w.x, w.y);
  mma_s8(acc, lo.z, hi.z, lo.w, hi.w, w.z, w.w);
}

// L2 policies: a read-once weight stream is evicted first, so that it does
// not push out the codes every block reads (evicted last).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// The box at coordinates (c0, c1, c2) of the 3-D tensor map `map` (a
// __grid_constant__ kernel parameter) into this block's shared memory at
// `dst` (128-byte aligned), its bytes counted on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar), "l"(policy) : "memory");
}

// Orders ordinary global stores (the writer's, before a grid barrier) and
// tensor copies that read them (the reader's, after it): the copies run in
// the async proxy.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Waits until the phase of parity `parity` of this block's mbarrier `bar`
// has completed (cluster::mbar_wait's loop, trap included, at the scope of
// the block: the cluster scope's acquire empties the whole L1 on every
// wait, which the tensor copies into this block's shared memory do not
// need).
__device__ __forceinline__ void mbar_wait_cta(uint64_t* bar, uint32_t parity) {
  const uint32_t a = cluster::smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if ((i & 255) == 255) {
      const uint64_t now = cluster::global_ns();
      if (start == 0) start = now;
      else if (now - start > cluster::kWaitLimitNs) __trap();
    }
  }
}

// cuTensorMapEncodeTiled, a driver API function, through the runtime's
// entry-point query (no link against the driver library); null if the
// driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace int8mma
