// Final-exponentiation kernels for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/pairing_pallas.py
//
//   f12_pow_kernel    <- _f12_pow_kernel (:828): f^e per lane, e's MSB-first
//                        bits, optional Granger-Scott cyclotomic squaring
//   final_exp_kernel  <- _final_exp_kernel (:914): the whole BLS12 final
//                        exponentiation (factor-3 chain) per lane
//
// They share csrc/tower_rows.cuh with the Miller kernels (pairing_kernels.cu)
// and sit in a source of their own so that nvcc builds the two in parallel.
// The per-lane chains (f12_pow_lane, final_exp_lane) are in fexp_rows.cuh,
// which the one-launch check (check_kernels.cu) shares.
// One thread owns one lane, its f12 values and each step's temporaries on
// the thread's stack (local memory, cached in L1), as in pairing_kernels.cu.
//
// Bound on this card: integer multiplies.  A BLS12-381 final exp is ~10,000
// field muls of 588 32-bit multiply-adds (the inverse chain over p - 2, five
// x-chains of 64 cyclotomic squarings) for 576 bytes in and 576 out; a BN254
// digit chain is ~250 cyclotomic squarings and ~125 f12 muls at 8 words.
// Each lane is one serial chain: at the path's sizes (1 to 4,096 lanes) the
// kernels are latency-bound, and a 1-lane final exp (the split strategy)
// runs one thread.  The bits of p - 2, of |x| and of each exponent come in as
// device arrays and x < 0 as an argument, so one build serves every curve.
//
// Every launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "fexp_rows.cuh"
#include "fp_rows.cuh"
#include "lanes.cuh"
#include "tower_rows.cuh"

namespace mlt {

template <int NW>
__global__ void f12_pow_kernel(const uint32_t* __restrict__ base_in,
                               const uint8_t* __restrict__ bits, int nbits, int cyclo,
                               uint32_t* __restrict__ out, int lanes, FieldConsts k,
                               TowerConsts tc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  F12<NW> base;
  load_f12<NW>(base, base_in, lanes, i);
  f12_pow_lane<NW>(base, base, bits, nbits, cyclo, k, tc);
  store_f12<NW>(out, base, lanes, i);
}

template <int NW>
__global__ void final_exp_kernel(const uint32_t* __restrict__ f_in, FexpArgs fa,
                                 uint32_t* __restrict__ out, int lanes, FieldConsts k,
                                 TowerConsts tc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  F12<NW> f;
  load_f12<NW>(f, f_in, lanes, i);
  final_exp_lane<NW>(f, fa, k, tc);
  store_f12<NW>(out, f, lanes, i);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_f12_pow(const uint32_t* base, const uint8_t* bits, int nbits, int cyclo,
                           uint32_t* out, int lanes, int L, const uint32_t* consts,
                           const int32_t* tower_ints, const uint32_t* tail, cudaStream_t stream) {
  MLT_PAIR_DISPATCH(L, f12_pow_kernel<NW><<<pair_grid(lanes), kPairThreads, 0, stream>>>(
                           base, bits, nbits, cyclo, out, lanes, make_consts(consts, NW),
                           tower_consts(tower_ints, tail, NW)))
}

extern "C" int mlt_final_exp(const uint32_t* f_in, const uint8_t* inv_bits, int inv_nbits,
                             const uint8_t* x_bits, int x_nbits, int x_neg,
                             const uint32_t* gammas, uint32_t* out, int lanes, int L,
                             const uint32_t* consts, const int32_t* tower_ints,
                             const uint32_t* tail, cudaStream_t stream) {
  const FexpArgs fa = {inv_bits, inv_nbits, x_bits, x_nbits, x_neg, gammas};
  MLT_PAIR_DISPATCH(L, final_exp_kernel<NW><<<pair_grid(lanes), kPairThreads, 0, stream>>>(
                           f_in, fa, out, lanes, make_consts(consts, NW),
                           tower_consts(tower_ints, tail, NW)))
}
