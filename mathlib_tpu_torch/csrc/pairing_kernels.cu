// Pairing kernels for Hopper (sm_90a): port of the Miller addition step
// kernel of mathlib_tpu/ops/kernels/pairing_pallas.py (the Miller loops are
// in miller_split_kernels.cu; the pow and final-exponentiation kernels and
// the product tree in fexp_split_kernels.cu).
//
//   add_step_kernel      <- _add_step_kernel (:807): (f l_{T,Q}(P), T + Q)
//
// Layout (lanes.cuh): field elements are (..., L, B) 16-bit limbs in 32-bit
// words, lane batch last, as everywhere in the port: xP, yP (L, B); Qx, Qy
// (2, L, B); T (3, 2, L, B); an f12 (2, 3, 2, L, B).  One thread owns one
// lane; limb pairs are packed into NW = L/2 words, and f, T and the step's
// temporaries live on the thread's stack (local memory, cached in L1): an
// f12 is 144 words and T 72 at NW = 12, far past the 255 registers a thread
// has.
//
// Bound on this card: integer multiplies.  An add step is 83 field muls
// (BLS12-381) of 588 32-bit multiply-adds each (fp_rows.cuh).  What this
// simple design leaves on the table: the stack traffic of the __noinline__
// calls, and occupancy (one lane per thread).
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"
#include "lanes.cuh"
#include "tower_rows.cuh"

namespace mlt {

// (f, T) <- (f * l_{T,Q}(P), T + Q) per lane
template <int NW>
__global__ void add_step_kernel(const uint32_t* __restrict__ f_in, const uint32_t* __restrict__ t_in,
                                const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                                const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                                uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out,
                                int lanes, FieldConsts k, TowerConsts tc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  uint32_t xP[NW], yP[NW];
  F2<NW> Qx, Qy;
  F12<NW> f;
  G2Proj<NW> T;
  Line<NW> l;
  load_fp<NW>(xP, xp, 0, lanes, i);
  load_fp<NW>(yP, yp, 0, lanes, i);
  load_f2<NW>(Qx, qx, lanes, i);
  load_f2<NW>(Qy, qy, lanes, i);
  load_f12<NW>(f, f_in, lanes, i);
  load_T<NW>(T, t_in, lanes, i);
  add_step<NW>(T, l, Qx, Qy, xP, yP, k, tc);
  f12_sparse_mul<NW>(f, f, l, k, tc);
  store_f12<NW>(f_out, f, lanes, i);
  store_T<NW>(t_out, T, lanes, i);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_pairing_add_step(const uint32_t* f_in, const uint32_t* t_in,
                                    const uint32_t* qx, const uint32_t* qy, const uint32_t* xp,
                                    const uint32_t* yp, uint32_t* f_out, uint32_t* t_out,
                                    int lanes, int L, const uint32_t* consts,
                                    const int32_t* tower_ints, const uint32_t* tail,
                                    cudaStream_t stream) {
  MLT_PAIR_DISPATCH(L, add_step_kernel<NW><<<pair_grid(lanes), kPairThreads, 0, stream>>>(
                           f_in, t_in, qx, qy, xp, yp, f_out, t_out, lanes,
                           make_consts(consts, NW), tower_consts(tower_ints, tail, NW)))
}
