// The G2 ladder's step for Hopper (sm_90a) in one launch: one whole bit of
// the G2 ladder (g2_smul_kernels.cu) with acc read from P, over the warps of
// a block: port of mathlib_tpu/ops/kernels/g2_pallas.py's ladder step.
//
//   g2_dblsel_kernel <- g2_pallas.py:_dblsel_kernel (dblsel_pallas)
//
// out = sel ? 2P + Q : 2P on (3, 2, L, n) points (g2_step.cuh has the
// layout and the steps): the doubling's half of g2_step.cuh's half_bit and
// the add's, on the ladder's 60 slots and 18 workers.  What bounds it on an
// H100 is the integer multiply rate: 24 field products a lane and 36 more
// where sel holds.  The one-thread design it replaced waited for them in
// one thread (180 registers, a 2,088-byte stack); here a layer's products
// run at once, one a worker, from shared memory, under __maxnreg__(96): no
// stack, no spill.  Its own source: compiled in one nvcc process with the
// ladders, the add and the doubling, it set the build's wall (PERF.md
// section 6).
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns the CUDA error of reading the card's SM count,
// of raising the kernel's dynamic shared memory cap (once per kernel and
// device) or of the launch (or -1 for an L other than 18 or 24).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_step.cuh"
#include "words.cuh"

namespace mlt {

// out = sel ? 2P + Q : 2P (RCB Alg 9 then Alg 7 over Fp2: one bit of the
// ladder with acc read from P) for the LB lanes of this block, on the
// ladder's slots: workers 0-5 stage P's components into point buffer 0,
// 6-11 Q's, the doubling's half puts D into buffer 1, and, where a lane of
// the block has sel, the add's half D + Q stores sel ? A : D straight out,
// lane by lane; a block none of whose lanes has sel stores D.  h is a
// runtime value, as in the ladder: with the two halves inlined apart the
// kernel took 4 % longer at 4,096 lanes and 8 % at 2,112 on an H100
// (PERF.md section 6).
template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_dblsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, B3 b3) {
  using S = LadderSlots;
  constexpr int D = S::kPt + 6;
  extern __shared__ uint32_t sm[];
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
  __syncthreads();
  const bool adds = live && sel[i];
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // the doubling D = 2P, then the add A = D + Q
    if (h == 1 && !__syncthreads_or(adds)) {  // no lane of the block adds: out = D
      if (w < 6 && live) {
        uint32_t r[NW];
        sget<NW, LB>(r, sm, D + w, t);
        store_fp<NW>(out, r, w, n, i);
      }
      return;
    }
    half_bit<NW, LB, S>(sm, h, h == 0 ? S::kPt : D, w, t, k, b3, [&] {
      if (h == 0) {  // D into point buffer 1
        if (w < 6) {
          uint32_t r[NW];
          point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
          sput<NW, LB>(sm, D + w, r, t);
        }
      } else if (w < 6 && live) {  // sel ? A : D, straight out
        uint32_t r[NW];
        if (adds) {
          point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
        } else {
          sget<NW, LB>(r, sm, D + w, t);
        }
        store_fp<NW>(out, r, w, n, i);
      }
    });
  }
}

}  // namespace mlt

using namespace mlt;

MLT_LAUNCHER(mlt_g2_dblsel, const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out,
             int n, int L, const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g2_dblsel, P, Q, sel, out, n, L, consts, b3c0, b3c1, stream)
  return by_block_lanes(n, L, [&](auto nw, auto lb) {
    constexpr int NW = decltype(nw)::value, LB = decltype(lb)::value;
    static int raised[kMaxDevices] = {};
    return launch_blocks<NW, LB>(g2_dblsel_kernel<NW, LB>, raised, kLadderWorkers,
                                 LadderSlots::kN, 0, n, stream, P, Q, sel, out, n,
                                 make_consts(consts, NW), B3{b3c0, b3c1});
  });
}
