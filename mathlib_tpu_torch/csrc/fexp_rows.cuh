// The BLS12 final exponentiation of one lane, and the unity test, for the
// one-launch check (check_kernels.cu pairing_check_kernel): port of
// _final_exp_body and _is_one_flag of mathlib_tpu/ops/kernels/pairing_pallas.py.
// One thread runs one lane's chain with its f12 values on the thread's
// stack.  The split final-exp kernels (fexp_split_kernels.cu) run the same
// chains over a block's workers, as programs traced from these functions'
// tower_rows.cuh calls (ops/kernels/fexp_prog.py).
#pragma once

#include <cstdint>

#include "fp_rows.cuh"
#include "tower_rows.cuh"

namespace mlt {

// acc = 1; per MSB-first bit: acc = acc^2 (Granger-Scott when cyclo), then
// acc *= base at a one bit
template <int NW>
__device__ __noinline__ void f12_pow_lane(F12<NW>& r, const F12<NW>& base, const uint8_t* bits,
                                          int nbits, int cyclo, const FieldConsts& k,
                                          const TowerConsts& tc) {
  F12<NW> acc;
  f12_one<NW>(acc, k);
  for (int b = 0; b < nbits; ++b) {
    if (cyclo)
      f12_cyclo_sqr<NW>(acc, acc, k, tc);
    else
      f12_sqr<NW>(acc, acc, k, tc);
    if (bits[b]) f12_mul<NW>(acc, acc, base, k, tc);
  }
  r = acc;
}

// What the final exponentiation needs besides the tower: the MSB-first bits
// of p - 2 (the in-kernel inverse) and of |x| (the hard part's x-chains) as
// device arrays, the sign of x, and the Frobenius constants for n = 1, 2 as
// a device array [n-1][h][j][c][NW] of Montgomery words.
struct FexpArgs {
  const uint8_t* inv_bits;
  int inv_nbits;
  const uint8_t* x_bits;
  int x_nbits;
  int x_neg;
  const uint32_t* gammas;
};

// a^x on the cyclotomic subgroup: a^|x| by Granger-Scott squarings, then the
// conjugate (the inverse there) when x < 0
template <int NW>
__device__ __noinline__ void exp_x(F12<NW>& r, const F12<NW>& a, const FexpArgs& fa,
                                   const FieldConsts& k, const TowerConsts& tc) {
  f12_pow_lane<NW>(r, a, fa.x_bits, fa.x_nbits, 1, k, tc);
  if (fa.x_neg) f12_conj<NW>(r, k);
}

// The final exponentiation of one lane, as _final_exp_body: the easy part
// t = conj(f) / f, f1 = frob^2(t) t; the hard part, with the identity
// 3 (p^4 - p^2 + 1)/r = (x-1)^2 (x + p) (x^2 + p^2 - 1) + 3,
// y = f1^((x-1)^2), y = y^x frob(y), y = y^(x^2) frob^2(y) conj(y),
// f = y f1^3.
template <int NW>
__device__ __noinline__ void final_exp_lane(F12<NW>& f, const FexpArgs& fa, const FieldConsts& k,
                                            const TowerConsts& tc) {
  const uint32_t* gam1 = fa.gammas;
  const uint32_t* gam2 = fa.gammas + 12 * NW;
  F12<NW> t, f1, y, z;
  f12_inv<NW>(t, f, fa.inv_bits, fa.inv_nbits, k, tc);
  z = f;
  f12_conj<NW>(z, k);
  f12_mul<NW>(t, z, t, k, tc);  // f^(p^6 - 1)
  f12_frob<NW>(z, t, gam2, 2, k, tc);
  f12_mul<NW>(f1, z, t, k, tc);  // ^(p^2 + 1)
  // y = f1^((x-1)^2): two exp_xm1, a^(x-1) = a^x conj(a)
  exp_x<NW>(y, f1, fa, k, tc);
  z = f1;
  f12_conj<NW>(z, k);
  f12_mul<NW>(y, y, z, k, tc);
  exp_x<NW>(t, y, fa, k, tc);
  z = y;
  f12_conj<NW>(z, k);
  f12_mul<NW>(y, t, z, k, tc);
  // y = y^x frob(y)
  exp_x<NW>(t, y, fa, k, tc);
  f12_frob<NW>(z, y, gam1, 1, k, tc);
  f12_mul<NW>(y, t, z, k, tc);
  // y = y^(x^2) frob^2(y) conj(y)
  exp_x<NW>(t, y, fa, k, tc);
  exp_x<NW>(t, t, fa, k, tc);
  f12_frob<NW>(z, y, gam2, 2, k, tc);
  f12_mul<NW>(t, t, z, k, tc);
  z = y;
  f12_conj<NW>(z, k);
  f12_mul<NW>(y, t, z, k, tc);
  // f = y f1^3
  f12_sqr<NW>(t, f1, k, tc);
  f12_mul<NW>(t, t, f1, k, tc);
  f12_mul<NW>(f, y, t, k, tc);
}

// f == 1 in Fp12 (_is_one_flag): every coefficient canonical ([0, p)) equals
// the one's: R mod p at (0, 0, 0), zero elsewhere.
template <int NW>
__device__ __forceinline__ bool f12_is_one(const F12<NW>& f, const FieldConsts& k) {
  bool ok = true;
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 3; ++j)
      for (int c = 0; c < 2; ++c) {
        uint32_t w[NW];
        fp_canon<NW>(w, f.c[h].c[j].c[c], k);
        for (int i = 0; i < NW; ++i) ok &= w[i] == ((h | j | c) == 0 ? k.one[i] : 0u);
      }
  return ok;
}

}  // namespace mlt
