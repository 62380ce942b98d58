// simt_tile.cuh: the register-blocked fp32 SIMT tile that kernel 1
// (csrc/fused_linear.cu) and kernel 3 (csrc/fused_mlp_train_step.cu) share.
//
// A block of NT threads computes one BM x BN tile of C = A · Bᵀ, C[m][n] =
// Σ_k A(m, k) · B(n, k), over a range of k, in IEEE fp32 FMA (no tensor
// cores, no contraction into TF32).  Each thread holds TM x TN
// accumulators; each accumulator is summed in k order by that one thread,
// so the result of a tile does not depend on the grid or on timing.
//
// The k range is walked in stages of BK.  Each stage of both operands is
// staged k-major in shared memory (element (i, k) of the stage at
// s[k * (BX + kPad) + i]), double-buffered: while the block computes from
// one buffer, each thread already holds the next stage's global loads in
// registers and stores them into the other buffer after the compute, so a
// stage's load latency overlaps the previous stage's FMAs and one
// __syncthreads per stage suffices.
//
// An operand is either K-major (element (i, k) at p[i * ld + k], e.g. x and
// w of a linear layer) or MN-major (element (i, k) at p[k * ld + i], e.g. a
// weight read as Wᵀ, or the batch rows of dz and h in a weight gradient).
// VEC loads 4 consecutive elements along the contiguous axis with one
// 16-byte (f32) or 8-byte (bf16) load and needs ld % 4 == 0 and an aligned
// base; each of the 4 elements is then masked on its own, so a contiguous
// extent that is not a multiple of 4 only needs its row padded to 4 in
// memory.  The scalar variant takes any ld.  Outside [0, rows) x [0, kend)
// an operand reads 0: ragged edges are masked, nothing is padded.
//
// A thread's TM rows are TM / VM groups of VM = min(TM, 4) consecutive rows
// (group g at g * BM / (TM / VM) + ty * VM), read from shared memory as one
// VM-wide vector; likewise its TN columns.  With 8 x 8 per thread that is
// the two-quadrant layout, whose shared-memory reads are 16-byte and
// broadcast within a warp's rows.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kPad = 4;  // floats added to each staged row: 16-byte aligned

enum Act { kIdentity = 0, kLogistic = 1, kRelu = 2, kTanh = 3 };

__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case kLogistic: return 1.0f / (1.0f + expf(-z));
    case kRelu: return z > 0.0f ? z : 0.0f;
    case kTanh: return tanhf(z);
    default: return z;
  }
}

// d act / d z, from the activation's output h = act(z)
__device__ __forceinline__ float act_grad_from_out(int act, float h) {
  switch (act) {
    case kLogistic: return h * (1.0f - h);
    case kRelu: return h > 0.0f ? 1.0f : 0.0f;
    case kTanh: return 1.0f - h * h;
    default: return 1.0f;
  }
}

// Global loads.  CG (ld.global.cg, through L2) for data that other blocks of
// the same launch wrote; otherwise the read-only path.
template <bool CG>
__device__ __forceinline__ float load1(const float* p) {
  return CG ? __ldcg(p) : __ldg(p);
}
template <bool CG>
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <bool CG>
__device__ __forceinline__ float4 load4(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return CG ? __ldcg(q) : __ldg(q);
}
template <bool CG>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One operand's stage: the BX x BK block of elements (i0 + i, k0 + kk),
// fetched into registers by `fetch` and written k-major into shared memory
// by `store` (same thread, same mapping).
template <typename T, int BX, int BK, int NT, bool KMAJOR, bool VEC, bool CG>
struct Stage {
  static constexpr int kS = BX + kPad;  // staged row length
  static constexpr int kItems = VEC ? BX * BK / 4 : BX * BK;
  static constexpr int kPer = kItems / NT;  // vectors or scalars per thread
  static constexpr int kRegs = VEC ? 4 * kPer : kPer;
  // K-major VEC: a warp takes 32 / Q rows x Q 4-k runs (Q = min(BK / 4, 4)):
  // a 16-byte load then touches 8 rows (a warp across 32 rows costs the L1
  // 32 wavefronts a load) and the transposed stores conflict at most 2-way
  // (a warp along 16 runs of k conflicts 8-way)
  static constexpr int Q = BK / 4 < 4 ? BK / 4 : 4;
  static_assert(kItems % NT == 0, "stage does not divide over the threads");
  static_assert(BX % 32 == 0 && BK % 4 == 0, "tile sides: 32 rows, 4 k");

  const T* p;
  int64_t ld;
  int rows;  // extent along i
  int kend;  // extent along k

  __device__ __forceinline__ void fetch(float (&r)[kRegs], int i0,
                                        int k0) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * NT;
      if constexpr (VEC) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (KMAJOR) {
          const int i = i0 + (v / Q) % BX;
          const int k = k0 + 4 * (v % Q + Q * (v / (Q * BX)));
          if (i < rows && k < kend) {
            f = load4<CG>(p + i * ld + k);
            if (k + 1 >= kend) f.y = 0.f;
            if (k + 2 >= kend) f.z = 0.f;
            if (k + 3 >= kend) f.w = 0.f;
          }
        } else {
          const int k = k0 + v / (BX / 4), i = i0 + 4 * (v % (BX / 4));
          if (i < rows && k < kend) {
            f = load4<CG>(p + k * ld + i);
            if (i + 1 >= rows) f.y = 0.f;
            if (i + 2 >= rows) f.z = 0.f;
            if (i + 3 >= rows) f.w = 0.f;
          }
        }
        r[4 * j] = f.x;
        r[4 * j + 1] = f.y;
        r[4 * j + 2] = f.z;
        r[4 * j + 3] = f.w;
      } else {
        // consecutive threads take consecutive addresses
        int i, k;
        if (KMAJOR) {
          i = i0 + v / BK;
          k = k0 + v % BK;
        } else {
          k = k0 + v / BX;
          i = i0 + v % BX;
        }
        r[j] = (i < rows && k < kend)
                   ? load1<CG>(p + (KMAJOR ? i * ld + k : k * ld + i))
                   : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(const float (&r)[kRegs],
                                        float* s) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * NT;
      if constexpr (VEC) {
        if constexpr (KMAJOR) {  // a k-run of one row: transposed, 4 scalar stores
          const int i = (v / Q) % BX, k = 4 * (v % Q + Q * (v / (Q * BX)));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[(k + e) * kS + i] = r[4 * j + e];
        } else {  // an i-run of one k: one 16-byte store
          const int k = v / (BX / 4), i = 4 * (v % (BX / 4));
          *reinterpret_cast<float4*>(s + k * kS + i) =
              make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
        }
      } else {
        if constexpr (KMAJOR)
          s[(v % BK) * kS + v / BK] = r[j];
        else
          s[(v / BX) * kS + v % BX] = r[j];
      }
    }
  }
};

template <int V>
__device__ __forceinline__ void lds(const float* s, float* out) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(s);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = s[0];
  }
}

// KS > 1 splits each stage's BK k over KS groups of threads (group g takes
// k in [g·BK/KS, (g+1)·BK/KS) of every stage), so each thread keeps a larger
// register tile for the same output tile: fewer shared-memory reads per FMA.
// The groups' sums are then added in group order into group 0 (`leader()`),
// which alone holds the tile's result: each output is still a fixed-order
// sum, so a rerun is bit-equal.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int KS_ = 1>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int KS = KS_, KB = BK / KS;  // k per group per stage
  static constexpr int kThreadsN = BN / TN;
  static constexpr int NG = (BM / TM) * kThreadsN;  // threads per group
  static constexpr int NT = NG * KS;
  static constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  static constexpr int GM = TM / VM, GN = TN / VN;
  static constexpr int kSA = BM + kPad, kSB = BN + kPad;
  // shared memory of one tile: two stages of each operand
  static constexpr int kSmemFloats = 2 * BK * (kSA + kSB);
  // whether fused_linear may split K over blocks for this tile (the 8 x 8
  // tile keeps its registers for the products)
  static constexpr bool kSplit = TM * TN <= 16;
  static_assert(BK % KS == 0 && NG % 32 == 0, "groups of whole warps");
  static_assert(KS == 1 || (KS - 1) * NG * (TM * TN + TM) <= kSmemFloats,
                "the groups' sums fit the tile's shared memory");

  __device__ static __forceinline__ bool leader() {
    return static_cast<int>(threadIdx.x) < NG;
  }
  // the tile-relative row of accumulator row a, and column of column c
  __device__ static __forceinline__ int row(int a) {
    const int ty = (threadIdx.x % NG) / kThreadsN;
    return (a / VM) * (BM / GM) + ty * VM + a % VM;
  }
  __device__ static __forceinline__ int col(int c) {
    const int tx = threadIdx.x % kThreadsN;
    return (c / VN) * (BN / GN) + tx * VN + c % VN;
  }

  // acc = Σ_{k in [kbeg, kbeg + n_stages·BK)} A(m0 + row, k) · B(n0 + col, k)
  // (the loaders mask k past their kend).  With ROWSUM, also rowsum[a] =
  // Σ_k A(m0 + row(a), k).  With KS > 1 only the leader threads hold the
  // result.  Ends with a __syncthreads, so the block may reuse `smem` at
  // once.
  template <bool ROWSUM = false, class LA, class LB>
  __device__ static __forceinline__ void run(float (&acc)[TM][TN],
                                             const LA& la, const LB& lb,
                                             int m0, int n0, int kbeg,
                                             int n_stages, float* smem,
                                             float* rowsum = nullptr) {
    static_assert(LA::kS == kSA && LB::kS == kSB, "loader and tile differ");
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      if constexpr (ROWSUM) rowsum[a] = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[a][c] = 0.f;
    }
    if (n_stages <= 0) return;
    float* As = smem;
    float* Bs = smem + 2 * BK * kSA;
    const int grp = threadIdx.x / NG;
    const int ty = (threadIdx.x % NG) / kThreadsN, tx = threadIdx.x % kThreadsN;
    float ra[LA::kRegs], rb[LB::kRegs];
    la.fetch(ra, m0, kbeg);
    lb.fetch(rb, n0, kbeg);
    la.store(ra, As);
    lb.store(rb, Bs);
    __syncthreads();
    for (int s = 0; s < n_stages; ++s) {
      const int cur = s & 1;
      // The next stage's loads, unconditionally, so that they stay ahead of
      // this stage's FMAs (under a branch, ptxas merged them with the
      // stores below and every stage waited out its loads).  Past the last
      // stage the loaders' masks load nothing.
      la.fetch(ra, m0, kbeg + (s + 1) * BK);
      lb.fetch(rb, n0, kbeg + (s + 1) * BK);
      const float* as = As + (cur * BK + grp * KB) * kSA + ty * VM;
      const float* bs = Bs + (cur * BK + grp * KB) * kSB + tx * VN;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int g = 0; g < GM; ++g) lds<VM>(as + k * kSA + g * (BM / GM), a + g * VM);
#pragma unroll
        for (int g = 0; g < GN; ++g) lds<VN>(bs + k * kSB + g * (BN / GN), b + g * VN);
        if constexpr (ROWSUM) {
#pragma unroll
          for (int i = 0; i < TM; ++i) rowsum[i] += a[i];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // (after the last stage this fills the idle buffer with zeros)
      la.store(ra, As + (cur ^ 1) * BK * kSA);
      lb.store(rb, Bs + (cur ^ 1) * BK * kSB);
      __syncthreads();
    }
    if constexpr (KS > 1) {
      // groups 1..KS-1 hand their sums to group 0, which adds them in group
      // order (element-major, so a warp's stores are conflict-free)
      constexpr int E = TM * TN + (ROWSUM ? TM : 0);
      const int t = threadIdx.x % NG;
      if (grp > 0) {
        float* dst = smem + (grp - 1) * E * NG + t;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dst[(i * TN + j) * NG] = acc[i][j];
        if constexpr (ROWSUM) {
#pragma unroll
          for (int i = 0; i < TM; ++i) dst[(TM * TN + i) * NG] = rowsum[i];
        }
      }
      __syncthreads();
      if (grp == 0) {
        for (int g = 1; g < KS; ++g) {
          const float* src = smem + (g - 1) * E * NG + t;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] += src[(i * TN + j) * NG];
          if constexpr (ROWSUM) {
#pragma unroll
            for (int i = 0; i < TM; ++i) rowsum[i] += src[(TM * TN + i) * NG];
          }
        }
      }
      __syncthreads();
    }
  }
};

// Split K over blocks: `split` blocks each hold one K range's partial of
// the same output tile (m0, n0) of a rows x cols output.  Each writes its
// partial to its slot `sp` of `part` (split slots of rows x cols floats,
// row-major), and the last of them to arrive (an integer counter per tile,
// `counter`) adds the slots in split order into acc.  Returns, to every
// thread of the block, whether this block is that last one; then its
// leader threads hold the sum.  No float atomics: the order of the sum is
// fixed, only which block adds it varies.  Leaves *counter at 0 for the next
// use.  Call from every thread of the block.
template <class TL>
__device__ bool split_k_reduce(float (&acc)[TL::TM][TL::TN], float* part,
                               int sp, int split, int m0, int n0, int rows,
                               int cols, int* counter) {
  __shared__ int is_last;
  const int64_t slot = static_cast<int64_t>(rows) * cols;
  if (TL::leader()) {
    float* mine = part + sp * slot;
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      const int m = m0 + TL::row(i);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        const int n = n0 + TL::col(j);
        if (m < rows && n < cols)
          mine[static_cast<int64_t>(m) * cols + n] = acc[i][j];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == split - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0;
  if (!TL::leader()) return true;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) acc[i][j] = 0.f;
  // each slot's TM x TN loads issued together
#pragma unroll 2
  for (int p = 0; p < split; ++p) {
    float v[TL::TM][TL::TN];
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
      const int m = m0 + TL::row(i);
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) {
        const int n = n0 + TL::col(j);
        v[i][j] = (m < rows && n < cols)
                      ? __ldcg(part + p * slot + static_cast<int64_t>(m) * cols + n)
                      : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acc[i][j] += v[i][j];
  }
  return true;
}

}  // namespace simt
