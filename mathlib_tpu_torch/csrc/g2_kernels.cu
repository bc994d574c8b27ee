// The G2 scan-combiner kernel for Hopper (sm_90a) that runs one lane a
// thread: port of mathlib_tpu/ops/kernels/g2_pallas.py.
//
//   g2_addsel_kernel  <- g2_pallas.py:_addsel_kernel  (addsel_pallas)
//
// The point formula, the lane layout and the operation order that keeps
// the relaxed limbs the reference's are in g2_rows.cuh (the G2 ladders and
// the add, doubling and dblsel kernels of g2_smul_kernels.cu split the same
// formulas over a block's warps).
//
// Bound on this card: integer multiply issue rate, then registers and the
// stack.  An RCB add over Fp2 is 12 Fp2 products, 36 field muls (21,168
// 32-bit multiply-adds at NW = 12) for 1,152 bytes in and 576 out.  The
// design keeps one lane per thread and no shared memory: a point is 72
// words, the add holds two points and ten Fp2 temporaries, so the formula
// and the Fp2 products run as calls with their operands on the thread's
// stack (L1).  Later work: addsel as a launch of g2_smul_kernels.cu's add
// step over a block's warps, as the add, the doubling and dblsel are.
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an L other than
// 24).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_rows.cuh"

namespace mlt {

// out = sel ? P + Q : Q -- the segmented-scan combiner
template <int NW>
__global__ void g2_addsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                                 const uint8_t* __restrict__ sel, uint32_t* __restrict__ out,
                                 int n, FieldConsts k, TowerConsts tc, B3 b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G2Proj<NW> b;
  load_T<NW>(b, Q, n, i);
  if (sel[i]) {
    G2Proj<NW> a;
    load_T<NW>(a, P, n, i);
    rcb_add2<NW>(b, a, b, k, tc, b3);
  }
  store_T<NW>(out, b, n, i);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_g2_addsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3c0,
                             int b3c1, cudaStream_t stream) {
  MLT_G2_DISPATCH(L, g2_addsel_kernel<NW><<<g2_grid(n), kG2Threads, 0, stream>>>(
                         P, Q, sel, out, n, make_consts(consts, NW), g2_tower(), B3{b3c0, b3c1}))
}
