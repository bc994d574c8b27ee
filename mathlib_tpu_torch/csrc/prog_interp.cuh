// The interpreter of the split pairing kernels (miller_split_kernels.cu,
// fexp_split_kernels.cu, check_kernels.cu): one lane's work spread over the K workers of a
// block that owns G lanes, as programs of accumulator instructions over
// shared-memory slots (ops/kernels/miller_prog.py builds and explains them).
//
// A thread holds acc and one operand in registers: no call, no stack, no
// spill.  The product is fp_mul_ptx, the adds and subs fp_add_cc and
// fp_sub_cc (PTX carry chains), so the relaxed [0, 2p) limbs are those of
// fp_mul, fp_add and fp_sub (fp_rows.cuh).  A worker's instruction costs
// ~260 cycles before its work (fetch, decode, dispatch), an add ~400, a
// product ~2,800 alone, and each phase ends at a barrier (~410), on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --time-pairing's
// [miller_ins] lines, PERF.md).
//
// A program is an int32 device array (miller_prog.pack: a phase table of
// K + 1 code offsets a phase, then the code); its host meta holds G, K, the
// slots, the words of a slot, then (the Miller kernels) the phase ranges
// [begin, end) of their programs, in the order miller_prog packs them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

// instruction words (miller_prog.py): bits 0-3 op, bit 4 load acc from slot
// x, bit 5 store acc to slot d after the op, x bits 8-15, y 16-23, d 24-31
enum ProgOp { kAdd, kSub, kMul, kDbl, kNeg, kNop };
constexpr uint32_t kLoad = 16, kStore = 32;
constexpr int kProgMaxThreads = 1024;
constexpr int kMaxProgs = 3;  // the Miller kernels'; the final-exp kernels' are in their script

struct ProgMeta {
  int group, workers, slots, stride;  // stride: words a slot, NW x G or more
  int range[kMaxProgs][2];
};

template <int NW, int G>
struct SlotMem {
  uint32_t* base;  // this thread's lane of slot 0
  int stride;

  __device__ __forceinline__ void get(uint32_t* v, int s) const {
    const uint32_t* p = base + s * stride;
#pragma unroll
    for (int j = 0; j < NW; ++j) v[j] = p[j * G];
  }
  __device__ __forceinline__ void put(int s, const uint32_t* v) const {
    uint32_t* p = base + s * stride;
#pragma unroll
    for (int j = 0; j < NW; ++j) p[j * G] = v[j];
  }
};

// One instruction of a PTX carry chain each (fp_rows.cuh has the adds with
// carry in and the multiply-adds): the flag passes from one asm statement to
// the next, the chains below are unrolled over registers.
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// fp_add (fp_rows.cuh) on carry chains: a + b, minus 2p when that is >= 2p.
// r may alias a or b.
template <int NW>
__device__ __forceinline__ void fp_add_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConsts& k) {
  uint32_t s[NW], d[NW];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) s[j] = addc_cc(a[j], b[j]);  // a + b < 4p <= R: no carry out
  d[0] = sub_cc(s[0], k.p2[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(s[j], k.p2[j]);
  const uint32_t below = subc(0, 0);  // all ones when s < 2p
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = (s[j] & below) | (d[j] & ~below);
}

// fp_sub (fp_rows.cuh) on carry chains: a - b, plus 2p when that is
// negative.  r may alias a or b.
template <int NW>
__device__ __forceinline__ void fp_sub_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConsts& k) {
  uint32_t d[NW];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t neg = subc(0, 0);  // all ones when a < b
  r[0] = add_cc(d[0], k.p2[0] & neg);
#pragma unroll
  for (int j = 1; j < NW; ++j) r[j] = addc_cc(d[j], k.p2[j] & neg);
}

// phases [p0, p1) of the program: this worker's instructions, then a barrier.
// IDLE: the block may hold threads past its K workers (wk >= K), which run
// no instruction and only meet the barriers.
template <int NW, int G, bool IDLE = false>
__device__ __forceinline__ void run_phases(const int32_t* __restrict__ prog, int p0, int p1,
                                           int K, int wk, const SlotMem<NW, G>& S,
                                           uint32_t* acc, const FieldConsts& k) {
  for (int p = p0; p < p1; ++p) {
    int beg = 0, end = 0;
    if (!IDLE || wk < K) {
      beg = __ldg(prog + p * (K + 1) + wk);
      end = __ldg(prog + p * (K + 1) + wk + 1);
    }
    uint32_t next = beg < end ? (uint32_t)__ldg(prog + beg) : 0u;
    for (int pc = beg; pc < end; ++pc) {
      const uint32_t ins = next;  // the next word loads while this one runs
      if (pc + 1 < end) next = (uint32_t)__ldg(prog + pc + 1);
      const int op = ins & 15;
      uint32_t v[NW];
      if (ins & kLoad) S.get(acc, (ins >> 8) & 255);
      if (op <= kMul) S.get(v, (ins >> 16) & 255);  // both loads in flight together
      switch (op) {
        case kAdd:
          fp_add_cc<NW>(acc, acc, v, k);
          break;
        case kSub:
          fp_sub_cc<NW>(acc, acc, v, k);
          break;
        case kMul:
          fp_mul_ptx<NW>(acc, acc, v, k);
          break;
        case kDbl:
          fp_add_cc<NW>(acc, acc, acc, k);
          break;
        case kNeg:
#pragma unroll
          for (int j = 0; j < NW; ++j) v[j] = 0;
          fp_sub_cc<NW>(acc, v, acc, k);
          break;
        default:  // kNop
          break;
      }
      if (ins & kStore) S.put(ins >> 24, acc);
    }
    __syncthreads();
  }
}

inline ProgMeta prog_meta(const int32_t* meta, int nprogs) {
  ProgMeta m = {};
  m.group = meta[0];
  m.workers = meta[1];
  m.slots = meta[2];
  m.stride = meta[3];
  for (int r = 0; r < nprogs; ++r)
    for (int e = 0; e < 2; ++e) m.range[r][e] = meta[4 + 2 * r + e];
  return m;
}

// grid, block and dynamic shared memory of a launch; raises the kernel's
// shared-memory cap when a program needs more than the 48 KB default
template <int NW, int G, typename Kernel>
inline bool prog_launch_shape(Kernel kernel, const ProgMeta& m, int state_slots, int lanes,
                              dim3& grid, dim3& block, size_t& smem) {
  if (m.workers < 1 || m.workers * G > kProgMaxThreads || m.slots < state_slots ||
      m.stride < NW * G)
    return false;
  grid = dim3((unsigned)((lanes + G - 1) / G));
  block = dim3((unsigned)(m.workers * G));
  smem = (size_t)m.slots * m.stride * sizeof(uint32_t);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem) == cudaSuccess;
}

}  // namespace mlt

// the meta's group size picks G (L picks NW: MLT_PAIR_DISPATCH)
#define MLT_PROG_GROUPS(G_, ...)      \
  switch (G_) {                       \
    case 32: {                        \
      constexpr int G = 32;           \
      __VA_ARGS__;                    \
      break;                          \
    }                                 \
    case 16: {                        \
      constexpr int G = 16;           \
      __VA_ARGS__;                    \
      break;                          \
    }                                 \
    case 8: {                         \
      constexpr int G = 8;            \
      __VA_ARGS__;                    \
      break;                          \
    }                                 \
    default:                          \
      return -1;                      \
  }

