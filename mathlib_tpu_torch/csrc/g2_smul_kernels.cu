// G2 scalar-multiplication ladders for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/g2_pallas.py's fused chain kernels.
//
//   g2_smul_kernel        <- g2_pallas.py:_g2_smul_kernel        (g2_smul_pallas)
//   g2_smul_static_kernel <- g2_pallas.py:_g2_smul_static_kernel (g2_smul_static_pallas)
//
// The whole ladder of a lane runs in one thread, from infinity, over the
// point formulas of g2_rows.cuh: per-lane scalars (G2Ctx.scalar_mul: each
// bit a double, an add of Q and a select), or one static MSB-first bit array
// shared by every lane (HashG2Ctx's cofactor ladders: a double at every bit,
// the add only at one-bits; the branch on a bit is uniform across the warp).
// The bits are a small device array, so one build serves every scalar.
//
// Bound on this card: operations.  A 255-bit per-lane ladder is 255 x 20
// Fp2 products = 15,300 field muls a lane for 1,152 bytes in and 576 out; a
// static ladder 24 field muls a bit and 36 more a one-bit.  The design runs
// the chain serially in one thread with the accumulator, Q and the add's
// result on the thread's stack (3 points, 216 words), 32 threads a block.
// Later work: a lane split over several threads.
//
// Every launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an L other than
// 24, or for more bits than the scalar limbs hold).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_rows.cuh"

namespace mlt {

// out = [k]Q per lane, k in (S, n) plain 16-bit limbs: MSB-first double,
// add, select from infinity (the accumulator never leaves the thread)
template <int NW>
__global__ void g2_smul_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                               int nbits, uint32_t* __restrict__ out, int n, FieldConsts k,
                               TowerConsts tc, B3 b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G2Proj<NW> q, acc, A;
  load_T<NW>(q, Q, n, i);
  set_inf2<NW>(acc, k);
  for (int b = nbits - 1; b >= 0; --b) {
    rcb_dbl2<NW>(acc, acc, k, tc, b3);
    rcb_add2<NW>(A, acc, q, k, tc, b3);
    const bool bit = (s[(int64_t)(b >> 4) * n + i] >> (b & 15)) & 1u;
    select_point2<NW>(acc, bit, A, acc);
  }
  store_T<NW>(out, acc, n, i);
}

// out = [k]Q for ONE scalar shared by every lane, its MSB-first bits in a
// device array: a double at every bit, the complete add only at one-bits
template <int NW>
__global__ void g2_smul_static_kernel(const uint32_t* __restrict__ Q,
                                      const uint8_t* __restrict__ bits, int nbits,
                                      uint32_t* __restrict__ out, int n, FieldConsts k,
                                      TowerConsts tc, B3 b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G2Proj<NW> q, acc;
  load_T<NW>(q, Q, n, i);
  set_inf2<NW>(acc, k);
  for (int b = 0; b < nbits; ++b) {
    rcb_dbl2<NW>(acc, acc, k, tc, b3);
    if (bits[b]) rcb_add2<NW>(acc, acc, q, k, tc, b3);
  }
  store_T<NW>(out, acc, n, i);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_g2_smul(const uint32_t* Q, const uint32_t* s, int S, int nbits, uint32_t* out,
                           int n, int L, const uint32_t* consts, int b3c0, int b3c1,
                           cudaStream_t stream) {
  if (nbits > 16 * S) return -1;
  MLT_G2_DISPATCH(L, g2_smul_kernel<NW><<<g2_grid(n), kG2Threads, 0, stream>>>(
                         Q, s, nbits, out, n, make_consts(consts, NW), g2_tower(),
                         B3{b3c0, b3c1}))
}

extern "C" int mlt_g2_smul_static(const uint32_t* Q, const uint8_t* bits, int nbits,
                                  uint32_t* out, int n, int L, const uint32_t* consts, int b3c0,
                                  int b3c1, cudaStream_t stream) {
  MLT_G2_DISPATCH(L, g2_smul_static_kernel<NW><<<g2_grid(n), kG2Threads, 0, stream>>>(
                         Q, bits, nbits, out, n, make_consts(consts, NW), g2_tower(),
                         B3{b3c0, b3c1}))
}
