// Base-field kernels for Hopper (sm_90a):
//
//   mont_mul_kernel  <- mathlib_tpu/ops/kernels/fp_pallas.py _mont_mul_kernel
//                       (mont_mul_pallas)
//   fp_pow_kernel    <- mathlib_tpu/ops/kernels/pairing_pallas.py _fp_pow_kernel
//                       (fp_pow_pallas, behind FpCtx.pow_bits / inv / sqrt)
//
// mont_mul: out = a * b * R^-1 mod p per element, relaxed [0, 2p) in and
// out, bit-equal to the reference (REDC's output does not depend on the digit
// size).  Layout: a and out are (rows, L, n) 16-bit limbs in 32-bit words,
// the port's (..., L, B) tensors with the leading dims folded into rows; one
// thread per element.  b has a's shape, or is one (L, 1) constant broadcast
// over every element (b_step = 0), as FpCtx.to_mont multiplies by R^2 mod p.
//
// On the pairing-check path it is the Montgomery entry of the encoded pairs
// (6 rows of n lanes).  Bound on this card: bytes at that size (a 12-word mul
// is 588 32-bit multiply-adds for 96 bytes in and 96 out, under the card's
// ratio of multiply-adds to bytes), one launch per call.  The TPU
// kernel's (8, 128) tiles become one element per thread: a warp reads 128
// consecutive bytes per limb.
//
// fp_pow: out = a^e per element over the same layout, e's MSB-first bits in a
// device array (one build serves every exponent: p - 2, (p + 1)/4).  The TPU
// kernel keeps the accumulator in VMEM across its fori_loop; here it stays in
// the thread's registers across the whole chain.  Bound: operations (a
// 254-bit inverse at 8 words is ~380 products of 264 multiply-adds for 64
// bytes in and 64 out); each thread's chain is serial, so at the path's
// size (1,024 elements, 8 warps on 132 SMs) the kernel is latency-bound.
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

template <int NW>
__global__ void fp_pow_kernel(const uint32_t* __restrict__ a, const uint8_t* __restrict__ bits,
                              int nbits, uint32_t* __restrict__ out, int rows, int n,
                              FieldConsts k) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)rows * n) return;
  const int q = (int)(e / n);
  const int64_t i = e % n;
  uint32_t x[NW];
  load_fp<NW>(x, a, q, n, i);
  fp_pow<NW>(x, x, bits, nbits, k);
  store_fp<NW>(out, x, q, n, i);
}

inline dim3 fp_grid(int rows, int n) { return dim3((unsigned)(((int64_t)rows * n + 127) / 128)); }

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_fp_mont_mul(const uint32_t* a, const uint32_t* b, int b_step, uint32_t* out,
                               int rows, int n, int L, const uint32_t* consts,
                               cudaStream_t stream) {
  const dim3 grid = fp_grid(rows, n);
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

extern "C" int mlt_fp_pow(const uint32_t* a, const uint8_t* bits, int nbits, uint32_t* out,
                          int rows, int n, int L, const uint32_t* consts, cudaStream_t stream) {
  const dim3 grid = fp_grid(rows, n);
  switch (L) {
    case 16:
      fp_pow_kernel<8><<<grid, 128, 0, stream>>>(a, bits, nbits, out, rows, n,
                                                 make_consts(consts, 8));
      break;
    case 24:
      fp_pow_kernel<12><<<grid, 128, 0, stream>>>(a, bits, nbits, out, rows, n,
                                                  make_consts(consts, 12));
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
