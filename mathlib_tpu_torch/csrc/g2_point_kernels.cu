// The G2 add, doubling and scan combiner for Hopper (sm_90a), one launch
// each of one half of the G2 ladder's bit (g2_step.cuh's half_bit) over the
// warps of a block: port of mathlib_tpu/ops/kernels/g2_pallas.py's point
// kernels.
//
//   g2_add_kernel     <- g2_pallas.py:_add_kernel    (add_pallas)
//   g2_double_kernel  <- g2_pallas.py:_double_kernel (double_pallas)
//   g2_addsel_kernel  <- g2_pallas.py:_addsel_kernel (addsel_pallas)
//
// out = P + Q (RCB Alg 7 over Fp2), out = 2P (Alg 9) and
// out = sel ? P + Q : Q on (3, 2, L, n) points (g2_step.cuh has the layout
// and the steps).  The add and addsel are one body (add_body<.., SEL>):
// workers 0-5 stage P's components into the slots, 6-11 Q's, then the add's
// half runs on 18 workers, whose step 5 stores each lane's result straight
// out: A, or with SEL sel ? A : Q lane by lane, Q read back from its slots
// (a block none of whose lanes has sel stores Q after staging and runs no
// add).  The doubling stages P and runs the doubling's half on 12 workers.
//
// What bounds them on an H100 is the integer multiply rate: the add is 12
// Fp2 products, 36 field products (21,168 32-bit multiply-adds at NW = 12),
// for 1,152 bytes in and 576 out a lane; the doubling 24.  The one-thread
// designs they replaced waited for 36 (24) dependent products in one thread
// (146 and 183 registers, a 2,088-byte stack for the add and addsel).  Here
// a layer's products run at once, one a worker, from shared memory (54
// slots of NW x LB words for the add and addsel, 34 for the doubling:
// dynamic, above the 48 KB static limit at 32 lanes), under
// __maxnreg__(96): no stack, no spill.
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return the CUDA error of reading the card's SM count,
// of raising the kernel's dynamic shared memory cap (once per kernel and
// device) or of the launch (or -1 for an L other than 18 or 24).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_step.cuh"
#include "words.cuh"

namespace mlt {

// out = P + Q (SEL false) or out = sel ? P + Q : Q (SEL true) for the LB
// lanes of this block on the add's slots (this file's comment)
template <int NW, int LB, bool SEL>
__device__ __forceinline__ void add_body(uint32_t* sm, const uint32_t* __restrict__ P,
                                         const uint32_t* __restrict__ Q,
                                         const uint8_t* __restrict__ sel,
                                         uint32_t* __restrict__ out, int n, const FieldConsts& k,
                                         B3 b3) {
  using S = AddSlots;
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (w < 12) {
    const int c = w < 6 ? w : w - 6;
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, w < 6 ? P : Q, c, n, i);
    sput<NW, LB>(sm, (w < 6 ? S::kPt : S::kQ) + c, v, t);
  }
  const bool adds = !SEL || (live && sel[i]);
  if (!SEL) {
    __syncthreads();
  } else if (!__syncthreads_or(adds)) {  // no lane of the block adds: out = Q
    if (w < 6 && live) {
      uint32_t r[NW];
      sget<NW, LB>(r, sm, S::kQ + w, t);
      store_fp<NW>(out, r, w, n, i);
    }
    return;
  }
  half_bit<NW, LB, S>(sm, 1, S::kPt, w, t, k, b3, [&] {
    if (w < 6 && live) {
      uint32_t r[NW];
      if (adds) {
        point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
      } else {
        sget<NW, LB>(r, sm, S::kQ + w, t);
      }
      store_fp<NW>(out, r, w, n, i);
    }
  });
}

template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_add_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                  uint32_t* __restrict__ out, int n, FieldConsts k, B3 b3) {
  extern __shared__ uint32_t sm[];
  add_body<NW, LB, false>(sm, P, Q, nullptr, out, n, k, b3);
}

template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_addsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, B3 b3) {
  extern __shared__ uint32_t sm[];
  add_body<NW, LB, true>(sm, P, Q, sel, out, n, k, b3);
}

// out = 2P (RCB Alg 9 over Fp2) for the LB lanes of this block: workers 0-5
// stage P's components, then the doubling's half of a ladder bit on 12
// workers, stored straight out
template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_double_kernel(const uint32_t* __restrict__ P, uint32_t* __restrict__ out, int n,
                     FieldConsts k, B3 b3) {
  using S = DblSlots;
  extern __shared__ uint32_t sm[];
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (w < 6) {
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, P, w, n, i);
    sput<NW, LB>(sm, S::kPt + w, v, t);
  }
  __syncthreads();
  half_bit<NW, LB, S>(sm, 0, S::kPt, w, t, k, b3, [&] {
    if (w < 6 && live) {
      uint32_t r[NW];
      point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
      store_fp<NW>(out, r, w, n, i);
    }
  });
}

}  // namespace mlt

using namespace mlt;

MLT_LAUNCHER(mlt_g2_add, const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, int L,
             const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g2_add, P, Q, out, n, L, consts, b3c0, b3c1, stream)
  return by_block_lanes(n, L, [&](auto nw, auto lb) {
    constexpr int NW = decltype(nw)::value, LB = decltype(lb)::value;
    static int raised[kMaxDevices] = {};
    return launch_blocks<NW, LB>(g2_add_kernel<NW, LB>, raised, kLadderWorkers, AddSlots::kN, 0,
                                 n, stream, P, Q, out, n, make_consts(consts, NW),
                                 B3{b3c0, b3c1});
  });
}

MLT_LAUNCHER(mlt_g2_double, const uint32_t* P, uint32_t* out, int n, int L, const uint32_t* consts,
             int b3c0, int b3c1, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g2_double, P, out, n, L, consts, b3c0, b3c1, stream)
  return by_block_lanes(n, L, [&](auto nw, auto lb) {
    constexpr int NW = decltype(nw)::value, LB = decltype(lb)::value;
    static int raised[kMaxDevices] = {};
    return launch_blocks<NW, LB>(g2_double_kernel<NW, LB>, raised, kDblWorkers, DblSlots::kN, 0,
                                 n, stream, P, out, n, make_consts(consts, NW), B3{b3c0, b3c1});
  });
}

MLT_LAUNCHER(mlt_g2_addsel, const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out,
             int n, int L, const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g2_addsel, P, Q, sel, out, n, L, consts, b3c0, b3c1, stream)
  return by_block_lanes(n, L, [&](auto nw, auto lb) {
    constexpr int NW = decltype(nw)::value, LB = decltype(lb)::value;
    static int raised[kMaxDevices] = {};
    return launch_blocks<NW, LB>(g2_addsel_kernel<NW, LB>, raised, kLadderWorkers, AddSlots::kN,
                                 0, n, stream, P, Q, sel, out, n, make_consts(consts, NW),
                                 B3{b3c0, b3c1});
  });
}
