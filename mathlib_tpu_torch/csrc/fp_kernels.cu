// Batched Montgomery product for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/fp_pallas.py _mont_mul_kernel (mont_mul_pallas).
//
// out = a * b * R^-1 mod p per element, relaxed [0, 2p) in and out, bit-equal
// to the reference (REDC's output does not depend on the digit size).
// Layout: a and out are (rows, L, n) 16-bit limbs in 32-bit words, the
// port's (..., L, B) tensors with the leading dims folded into rows; one
// thread per element.  b has a's shape, or is one (L, 1) constant broadcast
// over every element (b_step = 0), as FpCtx.to_mont multiplies by R^2 mod p.
//
// On the pairing-check path it is the Montgomery entry of the encoded pairs
// (6 rows of n lanes).  Bound on this card: bytes at that size (a 12-word mul
// is 588 32-bit multiply-adds for 96 bytes in and 96 out, under the card's
// ratio of multiply-adds to bytes), one launch per call.  The TPU
// kernel's (8, 128) tiles become one element per thread: a warp reads 128
// consecutive bytes per limb.
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

template <int NW>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                int b_step, uint32_t* __restrict__ out, int rows, int n,
                                FieldConsts k) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)rows * n) return;
  const int q = (int)(e / n);
  const int64_t i = e % n;
  uint32_t x[NW], y[NW];
  load_fp<NW>(x, a, q, n, i);
  if (b_step)
    load_fp<NW>(y, b, q, n, i);
  else
    load_fp<NW>(y, b, 0, 1, 0);
  fp_mul<NW>(x, x, y, k);
  store_fp<NW>(out, x, q, n, i);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_fp_mont_mul(const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out,
                               int rows, int n, int L, const uint32_t* consts,
                               cudaStream_t stream) {
  const dim3 grid((unsigned)(((int64_t)rows * n + 127) / 128));
  switch (L) {
    case 16:
      mont_mul_kernel<8><<<grid, 128, 0, stream>>>(a, b, b_step, out, rows, n,
                                                   make_consts(consts, 8));
      break;
    case 24:
      mont_mul_kernel<12><<<grid, 128, 0, stream>>>(a, b, b_step, out, rows, n,
                                                    make_consts(consts, 12));
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
