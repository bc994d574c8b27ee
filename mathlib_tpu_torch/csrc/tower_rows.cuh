// Fp2 / Fp6 / Fp12 arithmetic and the Miller-loop steps for one thread's
// lane (port of mathlib_tpu/ops/kernels/pairing_pallas.py RowTower, eager
// path).
//
// Every function computes what the reference's RowTower computes, operation
// for operation (Karatsuba order, mul_xi's small-multiple chains for beta =
// -n with n != 1, the w-Karatsuba of the sparse line product, the shared
// intermediates of the doubling and addition steps), so the relaxed [0, 2p)
// limbs that come out are the reference's.  A value here is NW 32-bit words
// (fp_rows.cuh); an f2 is two of them, an f6 three f2, an f12 two f6.
//
// Every function may be called with its output aliasing an input: results
// are built in temporaries first.
//
// q_mul (f2_mul), f2_sqr, the f6 products, f12_sqr, f12_mul, f12_sparse_mul,
// the inverses, f12_frob, f12_cyclo_sqr, dbl_step, add_step and the Miller
// loop are real calls (__noinline__, as is fp_pow in fp_rows.cuh), each with
// its field muls inlined.  Inlining a whole Miller loop is far beyond what nvcc 12.9
// survives (it already crashed on two inlined point formulas in
// g1_kernels.cu); as calls, their operands pass through the thread's stack
// (local memory, cached in L1).
#pragma once

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

// Per-curve tower constants, passed by value as a kernel parameter.
struct TowerConsts {
  int n;        // beta = -n: u^2 = -n
  int xi0;      // xi = xi0 + u
  int twist_m;  // 1: M-twist line placement, 0: D-twist
  int conj_end;  // conjugate f after the loop (loop parameter < 0)
  int bn_tail;   // BN: two Frobenius chord lines after the loop
  // BN tail: Q1 = (conj(Qx) cx1, conj(Qy) cy1), Q2 = (Qx cx2, -Qy cy2),
  // Montgomery form, [cx1, cy1, cx2, cy2][c0/c1][word]
  uint32_t tail[4][2][kMaxWords];
};

template <int NW>
struct F2 {
  uint32_t c[2][NW];
};
template <int NW>
struct F6 {
  F2<NW> c[3];
};
template <int NW>
struct F12 {
  F6<NW> c[2];
};
template <int NW>
struct G2Proj {  // projective T = (X : Y : Z) on the twist
  F2<NW> x, y, z;
};
template <int NW>
struct Line {  // slots (A, D - B, -C) of ops/pairing.py
  F2<NW> a, dmb, negc;
};

// ------------------------------------------------------------------- fp ---
template <int NW>
__device__ __forceinline__ void fp_neg(uint32_t* r, const uint32_t* a, const FieldConsts& k) {
  uint32_t z[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) z[j] = 0;
  fp_sub<NW>(r, z, a, k);
}

// ------------------------------------------------------------------- f2 ---
template <int NW>
__device__ __forceinline__ void f2_add(F2<NW>& r, const F2<NW>& a, const F2<NW>& b,
                                       const FieldConsts& k) {
  fp_add<NW>(r.c[0], a.c[0], b.c[0], k);
  fp_add<NW>(r.c[1], a.c[1], b.c[1], k);
}

template <int NW>
__device__ __forceinline__ void f2_sub(F2<NW>& r, const F2<NW>& a, const F2<NW>& b,
                                       const FieldConsts& k) {
  fp_sub<NW>(r.c[0], a.c[0], b.c[0], k);
  fp_sub<NW>(r.c[1], a.c[1], b.c[1], k);
}

template <int NW>
__device__ __forceinline__ void f2_neg(F2<NW>& r, const F2<NW>& a, const FieldConsts& k) {
  fp_neg<NW>(r.c[0], a.c[0], k);
  fp_neg<NW>(r.c[1], a.c[1], k);
}

// a * m by the reference's add chain (RowCtx.mul_small), m >= 1
template <int NW>
__device__ __forceinline__ void f2_small(F2<NW>& r, const F2<NW>& a, int m,
                                         const FieldConsts& k) {
  fp_mul_small<NW>(r.c[0], a.c[0], m, k);
  fp_mul_small<NW>(r.c[1], a.c[1], m, k);
}

// a * (xi0 + u) = (xi0 a0 - n a1, xi0 a1 + a0)
template <int NW>
__device__ __forceinline__ void f2_mul_xi(F2<NW>& r, const F2<NW>& a, const FieldConsts& k,
                                          const TowerConsts& tc) {
  uint32_t na1[NW], c0[NW], c1[NW];
  fp_mul_small<NW>(na1, a.c[1], tc.n, k);  // n == 1: a copy, as the reference
  if (tc.xi0 == 0) {
    fp_neg<NW>(c0, na1, k);
    fp_copy<NW>(c1, a.c[0]);
  } else {
    uint32_t x0[NW], x1[NW];
    fp_mul_small<NW>(x0, a.c[0], tc.xi0, k);
    fp_mul_small<NW>(x1, a.c[1], tc.xi0, k);
    fp_sub<NW>(c0, x0, na1, k);
    fp_add<NW>(c1, x1, a.c[0], k);
  }
  fp_copy<NW>(r.c[0], c0);
  fp_copy<NW>(r.c[1], c1);
}

// q_mul: Karatsuba, 3 field muls
template <int NW>
__device__ __noinline__ void f2_mul(F2<NW>& r, const F2<NW>& a, const F2<NW>& b,
                                    const FieldConsts& k, const TowerConsts& tc) {
  uint32_t t0[NW], t1[NW], t2[NW], s[NW], u[NW];
  fp_mul<NW>(t0, a.c[0], b.c[0], k);
  fp_mul<NW>(t1, a.c[1], b.c[1], k);
  fp_add<NW>(s, a.c[0], a.c[1], k);
  fp_add<NW>(u, b.c[0], b.c[1], k);
  fp_mul<NW>(t2, s, u, k);
  fp_add<NW>(s, t0, t1, k);
  fp_sub<NW>(r.c[1], t2, s, k);
  fp_mul_small<NW>(t1, t1, tc.n, k);
  fp_sub<NW>(r.c[0], t0, t1, k);
}

// q_sqr: 2 field muls when n == 1, else 3
template <int NW>
__device__ __noinline__ void f2_sqr(F2<NW>& r, const F2<NW>& a, const FieldConsts& k,
                                    const TowerConsts& tc) {
  uint32_t s0[NW], m[NW];
  if (tc.n == 1) {
    uint32_t d[NW];
    fp_add<NW>(s0, a.c[0], a.c[1], k);
    fp_sub<NW>(d, a.c[0], a.c[1], k);
    fp_mul<NW>(m, a.c[0], a.c[1], k);
    fp_mul<NW>(r.c[0], s0, d, k);
  } else {
    uint32_t s1[NW];
    fp_mul<NW>(s0, a.c[0], a.c[0], k);
    fp_mul<NW>(s1, a.c[1], a.c[1], k);
    fp_mul<NW>(m, a.c[0], a.c[1], k);
    fp_mul_small<NW>(s1, s1, tc.n, k);
    fp_sub<NW>(r.c[0], s0, s1, k);
  }
  fp_add<NW>(r.c[1], m, m, k);
}

// q_mul_fp: f2 x base-field element
template <int NW>
__device__ __forceinline__ void f2_mul_fp(F2<NW>& r, const F2<NW>& a, const uint32_t* x,
                                          const FieldConsts& k) {
  fp_mul<NW>(r.c[0], a.c[0], x, k);
  fp_mul<NW>(r.c[1], a.c[1], x, k);
}

// ------------------------------------------------------------------- f6 ---
template <int NW>
__device__ __forceinline__ void f6_add(F6<NW>& r, const F6<NW>& a, const F6<NW>& b,
                                       const FieldConsts& k) {
  for (int j = 0; j < 3; ++j) f2_add<NW>(r.c[j], a.c[j], b.c[j], k);
}

template <int NW>
__device__ __forceinline__ void f6_sub(F6<NW>& r, const F6<NW>& a, const F6<NW>& b,
                                       const FieldConsts& k) {
  for (int j = 0; j < 3; ++j) f2_sub<NW>(r.c[j], a.c[j], b.c[j], k);
}

// a * v = (xi a2, a0, a1)
template <int NW>
__device__ __forceinline__ void f6_mul_v(F6<NW>& r, const F6<NW>& a, const FieldConsts& k,
                                         const TowerConsts& tc) {
  F2<NW> x;
  f2_mul_xi<NW>(x, a.c[2], k, tc);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = x;
}

// q_f6_mul: Karatsuba, 6 f2 muls
template <int NW>
__device__ __noinline__ void f6_mul(F6<NW>& r, const F6<NW>& a, const F6<NW>& b,
                                    const FieldConsts& k, const TowerConsts& tc) {
  F2<NW> t0, t1, t2, m12, m01, m02, s, u;
  f2_mul<NW>(t0, a.c[0], b.c[0], k, tc);
  f2_mul<NW>(t1, a.c[1], b.c[1], k, tc);
  f2_mul<NW>(t2, a.c[2], b.c[2], k, tc);
  f2_add<NW>(s, a.c[1], a.c[2], k);
  f2_add<NW>(u, b.c[1], b.c[2], k);
  f2_mul<NW>(m12, s, u, k, tc);
  f2_add<NW>(s, a.c[0], a.c[1], k);
  f2_add<NW>(u, b.c[0], b.c[1], k);
  f2_mul<NW>(m01, s, u, k, tc);
  f2_add<NW>(s, a.c[0], a.c[2], k);
  f2_add<NW>(u, b.c[0], b.c[2], k);
  f2_mul<NW>(m02, s, u, k, tc);
  // c0 = t0 + xi ((m12 - t1) - t2)
  f2_sub<NW>(s, m12, t1, k);
  f2_sub<NW>(s, s, t2, k);
  f2_mul_xi<NW>(s, s, k, tc);
  f2_add<NW>(r.c[0], t0, s, k);
  // c1 = ((m01 - t0) - t1) + xi t2
  f2_sub<NW>(s, m01, t0, k);
  f2_sub<NW>(s, s, t1, k);
  f2_mul_xi<NW>(u, t2, k, tc);
  f2_add<NW>(r.c[1], s, u, k);
  // c2 = ((m02 - t0) - t2) + t1
  f2_sub<NW>(s, m02, t0, k);
  f2_sub<NW>(s, s, t2, k);
  f2_add<NW>(r.c[2], s, t1, k);
}

// q_f6_mul01: a * (b0 + b1 v), 5 f2 muls
template <int NW>
__device__ __noinline__ void f6_mul01(F6<NW>& r, const F6<NW>& a, const F2<NW>& b0,
                                      const F2<NW>& b1, const FieldConsts& k,
                                      const TowerConsts& tc) {
  F2<NW> a0b0, a1b1, a2b0, a2b1, x, s, u;
  f2_mul<NW>(a0b0, a.c[0], b0, k, tc);
  f2_mul<NW>(a1b1, a.c[1], b1, k, tc);
  f2_mul<NW>(a2b0, a.c[2], b0, k, tc);
  f2_mul<NW>(a2b1, a.c[2], b1, k, tc);
  f2_add<NW>(s, a.c[0], a.c[1], k);
  f2_add<NW>(u, b0, b1, k);
  f2_mul<NW>(x, s, u, k, tc);
  f2_mul_xi<NW>(u, a2b1, k, tc);
  f2_add<NW>(r.c[0], a0b0, u, k);
  f2_sub<NW>(s, x, a0b0, k);
  f2_sub<NW>(r.c[1], s, a1b1, k);
  f2_add<NW>(r.c[2], a1b1, a2b0, k);
}

// ------------------------------------------------------------------ f12 ---
template <int NW>
__device__ __forceinline__ void f12_one(F12<NW>& f, const FieldConsts& k) {
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 3; ++j)
      for (int c = 0; c < 2; ++c)
        for (int w = 0; w < NW; ++w) f.c[h].c[j].c[c][w] = 0;
  fp_copy<NW>(f.c[0].c[0].c[0], k.one);
}

template <int NW>
__device__ __forceinline__ void f12_conj(F12<NW>& f, const FieldConsts& k) {
  for (int j = 0; j < 3; ++j) f2_neg<NW>(f.c[1].c[j], f.c[1].c[j], k);
}

// complex squaring over Fp6: 2 f6 muls
template <int NW>
__device__ __noinline__ void f12_sqr(F12<NW>& r, const F12<NW>& f, const FieldConsts& k,
                                     const TowerConsts& tc) {
  F6<NW> t, m1, s, u;
  f6_mul<NW>(t, f.c[0], f.c[1], k, tc);
  f6_add<NW>(s, f.c[0], f.c[1], k);
  f6_mul_v<NW>(u, f.c[1], k, tc);
  f6_add<NW>(u, f.c[0], u, k);
  f6_mul<NW>(m1, s, u, k, tc);
  f6_sub<NW>(m1, m1, t, k);
  f6_mul_v<NW>(u, t, k, tc);
  f6_sub<NW>(r.c[0], m1, u, k);
  f6_add<NW>(r.c[1], t, t, k);
}

// Karatsuba over Fp6: 3 f6 muls
template <int NW>
__device__ __noinline__ void f12_mul(F12<NW>& r, const F12<NW>& f, const F12<NW>& g,
                                     const FieldConsts& k, const TowerConsts& tc) {
  F6<NW> t0, t1, ts, s, u;
  f6_mul<NW>(t0, f.c[0], g.c[0], k, tc);
  f6_mul<NW>(t1, f.c[1], g.c[1], k, tc);
  f6_add<NW>(s, f.c[0], f.c[1], k);
  f6_add<NW>(u, g.c[0], g.c[1], k);
  f6_mul<NW>(ts, s, u, k, tc);
  f6_mul_v<NW>(u, t1, k, tc);
  f6_add<NW>(r.c[0], t0, u, k);
  f6_sub<NW>(ts, ts, t0, k);
  f6_sub<NW>(r.c[1], ts, t1, k);
}

// ------------------------------------------- inversion / frobenius ------
// (RowTower.f2_inv, f6_inv, f12_inv, f12_frob, f12_cyclo_sqr: the same
// products, adds and small multiples in the same order.)

// 1/a via the norm: (a0 - a1 u) / (a0^2 + n a1^2), the base-field inverse
// by fp_pow over the MSB-first bits of p - 2
template <int NW>
__device__ __noinline__ void f2_inv(F2<NW>& r, const F2<NW>& a, const uint8_t* inv_bits,
                                    int inv_nbits, const FieldConsts& k, const TowerConsts& tc) {
  uint32_t s0[NW], s1[NW];
  fp_mul<NW>(s0, a.c[0], a.c[0], k);
  fp_mul<NW>(s1, a.c[1], a.c[1], k);
  fp_mul_small<NW>(s1, s1, tc.n, k);  // n == 1: a copy, as the reference
  fp_add<NW>(s0, s0, s1, k);
  fp_pow<NW>(s0, s0, inv_bits, inv_nbits, k);
  fp_mul<NW>(s1, a.c[1], s0, k);
  fp_mul<NW>(r.c[0], a.c[0], s0, k);
  fp_neg<NW>(r.c[1], s1, k);
}

template <int NW>
__device__ __noinline__ void f6_inv(F6<NW>& r, const F6<NW>& a, const uint8_t* inv_bits,
                                    int inv_nbits, const FieldConsts& k, const TowerConsts& tc) {
  F2<NW> c0, c1, c2, t, u;
  f2_sqr<NW>(c0, a.c[0], k, tc);  // c0 = a0^2 - xi a1 a2
  f2_mul<NW>(t, a.c[1], a.c[2], k, tc);
  f2_mul_xi<NW>(t, t, k, tc);
  f2_sub<NW>(c0, c0, t, k);
  f2_sqr<NW>(c1, a.c[2], k, tc);  // c1 = xi a2^2 - a0 a1
  f2_mul_xi<NW>(c1, c1, k, tc);
  f2_mul<NW>(t, a.c[0], a.c[1], k, tc);
  f2_sub<NW>(c1, c1, t, k);
  f2_sqr<NW>(c2, a.c[1], k, tc);  // c2 = a1^2 - a0 a2
  f2_mul<NW>(t, a.c[0], a.c[2], k, tc);
  f2_sub<NW>(c2, c2, t, k);
  // norm = a0 c0 + xi (a2 c1 + a1 c2)
  f2_mul<NW>(t, a.c[2], c1, k, tc);
  f2_mul<NW>(u, a.c[1], c2, k, tc);
  f2_add<NW>(t, t, u, k);
  f2_mul_xi<NW>(t, t, k, tc);
  f2_mul<NW>(u, a.c[0], c0, k, tc);
  f2_add<NW>(u, u, t, k);
  f2_inv<NW>(u, u, inv_bits, inv_nbits, k, tc);
  f2_mul<NW>(r.c[0], c0, u, k, tc);
  f2_mul<NW>(r.c[1], c1, u, k, tc);
  f2_mul<NW>(r.c[2], c2, u, k, tc);
}

template <int NW>
__device__ __forceinline__ void f6_neg(F6<NW>& r, const F6<NW>& a, const FieldConsts& k) {
  for (int j = 0; j < 3; ++j) f2_neg<NW>(r.c[j], a.c[j], k);
}

// 1/f = (a0 - a1 w) / (a0^2 - v a1^2)
template <int NW>
__device__ __noinline__ void f12_inv(F12<NW>& r, const F12<NW>& f, const uint8_t* inv_bits,
                                     int inv_nbits, const FieldConsts& k,
                                     const TowerConsts& tc) {
  F6<NW> s0, s1;
  f6_mul<NW>(s0, f.c[0], f.c[0], k, tc);  // f6_sqr
  f6_mul<NW>(s1, f.c[1], f.c[1], k, tc);
  f6_mul_v<NW>(s1, s1, k, tc);
  f6_sub<NW>(s0, s0, s1, k);
  f6_inv<NW>(s0, s0, inv_bits, inv_nbits, k, tc);
  f6_mul<NW>(s1, f.c[1], s0, k, tc);
  f6_mul<NW>(r.c[0], f.c[0], s0, k, tc);
  f6_neg<NW>(r.c[1], s1, k);
}

// f^(p^n): conjugate every coefficient when n is odd, then scale
// coefficient (h, j) of v^j w^h by gamma_n[h][j].  gam holds this n's 12
// constants as Montgomery words, [h][j][c][NW] (a small device array).
template <int NW>
__device__ __noinline__ void f12_frob(F12<NW>& r, const F12<NW>& f, const uint32_t* gam, int n,
                                      const FieldConsts& k, const TowerConsts& tc) {
  for (int h = 0; h < 2; ++h)
    for (int j = 0; j < 3; ++j) {
      F2<NW> c = f.c[h].c[j], g;
      if (n & 1) fp_neg<NW>(c.c[1], c.c[1], k);
      for (int q = 0; q < 2; ++q)
        for (int w = 0; w < NW; ++w) g.c[q][w] = gam[((h * 3 + j) * 2 + q) * NW + w];
      f2_mul<NW>(r.c[h].c[j], c, g, k, tc);
    }
}

// One Fp4 squaring of the Granger-Scott form: (x + y s)^2 with s^2 = xi,
// t0 = x^2 + xi y^2, t1 = (x + y)^2 - x^2 - y^2 = 2xy.
template <int NW>
__device__ __forceinline__ void fp4_sqr(F2<NW>& t0, F2<NW>& t1, const F2<NW>& x,
                                        const F2<NW>& y, const FieldConsts& k,
                                        const TowerConsts& tc) {
  F2<NW> x2, y2, s;
  f2_sqr<NW>(x2, x, k, tc);
  f2_sqr<NW>(y2, y, k, tc);
  f2_add<NW>(s, x, y, k);
  f2_sqr<NW>(s, s, k, tc);
  f2_mul_xi<NW>(t0, y2, k, tc);
  f2_add<NW>(t0, x2, t0, k);
  f2_sub<NW>(t1, s, x2, k);
  f2_sub<NW>(t1, t1, y2, k);
}

// z' = 2 (t - z) + t (sign < 0) or 2 (t + z) + t (sign > 0)
template <int NW>
__device__ __forceinline__ void gs_combine(F2<NW>& r, const F2<NW>& t, const F2<NW>& z, int sign,
                                           const FieldConsts& k) {
  F2<NW> d;
  if (sign < 0)
    f2_sub<NW>(d, t, z, k);
  else
    f2_add<NW>(d, t, z, k);
  f2_add<NW>(d, d, d, k);
  f2_add<NW>(r, d, t, k);
}

// Granger-Scott squaring in the cyclotomic subgroup (unitary f only):
// Fp4 pairs (a0, b1), (b0, a2), (a1, b2) of f = (a0, a1, a2) + (b0, b1, b2) w,
// 9 f2 squarings.
template <int NW>
__device__ __noinline__ void f12_cyclo_sqr(F12<NW>& r, const F12<NW>& f, const FieldConsts& k,
                                           const TowerConsts& tc) {
  F2<NW> t00, t01, t10, t11, t20, t21, xt;
  fp4_sqr<NW>(t00, t01, f.c[0].c[0], f.c[1].c[1], k, tc);
  fp4_sqr<NW>(t10, t11, f.c[1].c[0], f.c[0].c[2], k, tc);
  fp4_sqr<NW>(t20, t21, f.c[0].c[1], f.c[1].c[2], k, tc);
  f2_mul_xi<NW>(xt, t21, k, tc);
  F12<NW> o;
  gs_combine<NW>(o.c[0].c[0], t00, f.c[0].c[0], -1, k);  // z0
  gs_combine<NW>(o.c[0].c[1], t10, f.c[0].c[1], -1, k);  // z4
  gs_combine<NW>(o.c[0].c[2], t20, f.c[0].c[2], -1, k);  // z3
  gs_combine<NW>(o.c[1].c[0], xt, f.c[1].c[0], 1, k);    // z2
  gs_combine<NW>(o.c[1].c[1], t01, f.c[1].c[1], 1, k);   // z1
  gs_combine<NW>(o.c[1].c[2], t11, f.c[1].c[2], 1, k);   // z5
  r = o;
}

// f * line: M-twist l0 = A v^2, l1 = (D-B) + (-C) v; D-twist l0 = A,
// l1 = (-C) + (D-B) v; w-Karatsuba, 14 (M) / 13 (D) f2 muls
template <int NW>
__device__ __noinline__ void f12_sparse_mul(F12<NW>& r, const F12<NW>& f, const Line<NW>& l,
                                            const FieldConsts& k, const TowerConsts& tc) {
  const F2<NW>& b0 = tc.twist_m ? l.dmb : l.negc;
  const F2<NW>& b1 = tc.twist_m ? l.negc : l.dmb;
  F6<NW> a0l0, a1l1, cross, s;
  F2<NW> p[3];
  for (int j = 0; j < 3; ++j) f2_mul<NW>(p[j], f.c[0].c[j], l.a, k, tc);
  f6_mul01<NW>(a1l1, f.c[1], b0, b1, k, tc);
  f6_add<NW>(s, f.c[0], f.c[1], k);
  if (tc.twist_m) {
    F6<NW> lf;
    lf.c[0] = b0;
    lf.c[1] = b1;
    lf.c[2] = l.a;
    f6_mul<NW>(cross, s, lf, k, tc);
    // a0 * (A v^2) = (xi (a1 A), xi (a2 A), a0 A)
    f2_mul_xi<NW>(a0l0.c[0], p[1], k, tc);
    f2_mul_xi<NW>(a0l0.c[1], p[2], k, tc);
    a0l0.c[2] = p[0];
  } else {
    F2<NW> bA;
    f2_add<NW>(bA, b0, l.a, k);
    f6_mul01<NW>(cross, s, bA, b1, k, tc);
    for (int j = 0; j < 3; ++j) a0l0.c[j] = p[j];
  }
  f6_mul_v<NW>(s, a1l1, k, tc);
  f6_add<NW>(r.c[0], a0l0, s, k);
  f6_sub<NW>(cross, cross, a0l0, k);
  f6_sub<NW>(r.c[1], cross, a1l1, k);
}

// ---------------------------------------------------------- miller steps ---
// Tangent line at T evaluated at P, and T <- 2T (incomplete projective
// double sharing S = YZ, X^2, YS = Y^2 Z and SZ = YZ^2 with the line).
template <int NW>
__device__ __noinline__ void dbl_step(G2Proj<NW>& T, Line<NW>& l, const uint32_t* xP,
                                      const uint32_t* yP, const FieldConsts& k,
                                      const TowerConsts& tc) {
  F2<NW> S, X2, W, YS, SZ, S2, X3t, X2Z, W2, Bd, YS2, SS2, H, t;
  f2_mul<NW>(S, T.y, T.z, k, tc);
  f2_sqr<NW>(X2, T.x, k, tc);
  f2_small<NW>(W, X2, 3, k);
  f2_mul<NW>(YS, T.y, S, k, tc);
  f2_mul<NW>(SZ, S, T.z, k, tc);
  f2_sqr<NW>(S2, S, k, tc);
  f2_mul<NW>(X3t, X2, T.x, k, tc);
  f2_mul<NW>(X2Z, X2, T.z, k, tc);
  f2_sqr<NW>(W2, W, k, tc);
  f2_mul<NW>(Bd, T.x, YS, k, tc);
  f2_sqr<NW>(YS2, YS, k, tc);
  f2_mul<NW>(SS2, S, S2, k, tc);
  f2_add<NW>(t, SZ, SZ, k);
  f2_mul_fp<NW>(l.a, t, yP, k);  // A = 2 S Z yP
  f2_small<NW>(t, X2Z, 3, k);
  f2_mul_fp<NW>(l.negc, t, xP, k);  // C = 3 X^2 Z xP
  f2_small<NW>(t, Bd, 8, k);
  f2_sub<NW>(H, W2, t, k);
  f2_mul<NW>(t, H, S, k, tc);  // HS
  f2_add<NW>(T.x, t, t, k);
  f2_small<NW>(t, Bd, 4, k);
  f2_sub<NW>(t, t, H, k);
  f2_mul<NW>(t, W, t, k, tc);  // Wt
  f2_small<NW>(H, YS2, 8, k);
  f2_sub<NW>(T.y, t, H, k);
  f2_small<NW>(T.z, SS2, 8, k);
  f2_small<NW>(t, X3t, 3, k);  // D
  f2_add<NW>(H, YS, YS, k);    // B
  f2_sub<NW>(l.dmb, t, H, k);
  f2_neg<NW>(l.negc, l.negc, k);
}

// Chord line through T and affine Q evaluated at P, and T <- T + Q
// (incomplete mixed addition, theta = Y - y2 Z, lambda = X - x2 Z).
template <int NW>
__device__ __noinline__ void add_step(G2Proj<NW>& T, Line<NW>& l, const F2<NW>& Qx,
                                      const F2<NW>& Qy, const uint32_t* xP, const uint32_t* yP,
                                      const FieldConsts& k, const TowerConsts& tc) {
  F2<NW> th, lam, l2, th2, l3, G, Zt, H, t, u;
  f2_mul<NW>(t, Qy, T.z, k, tc);
  f2_sub<NW>(th, T.y, t, k);
  f2_mul<NW>(t, Qx, T.z, k, tc);
  f2_sub<NW>(lam, T.x, t, k);
  f2_sqr<NW>(l2, lam, k, tc);
  f2_sqr<NW>(th2, th, k, tc);
  f2_mul<NW>(t, th, Qx, k, tc);
  f2_mul<NW>(u, lam, Qy, k, tc);
  f2_sub<NW>(l.dmb, t, u, k);
  f2_mul_fp<NW>(l.a, lam, yP, k);
  f2_mul_fp<NW>(l.negc, th, xP, k);
  f2_neg<NW>(l.negc, l.negc, k);
  f2_mul<NW>(l3, l2, lam, k, tc);
  f2_mul<NW>(G, T.x, l2, k, tc);
  f2_mul<NW>(Zt, T.z, th2, k, tc);
  f2_add<NW>(H, l3, Zt, k);
  f2_add<NW>(t, G, G, k);
  f2_sub<NW>(H, H, t, k);
  f2_mul<NW>(T.x, lam, H, k, tc);
  f2_sub<NW>(t, G, H, k);
  f2_mul<NW>(t, th, t, k, tc);
  f2_mul<NW>(u, T.y, l3, k, tc);
  f2_sub<NW>(T.y, t, u, k);
  f2_mul<NW>(T.z, T.z, l3, k, tc);
}

// -------------------------------------------------------- miller lane ---
template <int NW>
__device__ __forceinline__ void tail_const(F2<NW>& r, const TowerConsts& tc, int which) {
  fp_copy<NW>(r.c[0], tc.tail[which][0]);
  fp_copy<NW>(r.c[1], tc.tail[which][1]);
}

// One lane of _miller_body: f and T after the Miller loop over the loop
// bits (MSB-first, leading one skipped), from T = (Qx : Qy : 1), f = 1.
template <int NW>
__device__ __noinline__ void miller_loop(F12<NW>& f, G2Proj<NW>& T, const uint32_t* xP,
                                         const uint32_t* yP, const F2<NW>& Qx, const F2<NW>& Qy,
                                         const uint8_t* bits, int nbits, const FieldConsts& k,
                                         const TowerConsts& tc) {
  Line<NW> l;
  T.x = Qx;
  T.y = Qy;
  for (int c = 0; c < 2; ++c)
    for (int w = 0; w < NW; ++w) T.z.c[c][w] = c == 0 ? k.one[w] : 0u;
  f12_one<NW>(f, k);
  for (int b = 0; b < nbits; ++b) {
    dbl_step<NW>(T, l, xP, yP, k, tc);
    f12_sqr<NW>(f, f, k, tc);
    f12_sparse_mul<NW>(f, f, l, k, tc);
    if (bits[b]) {
      add_step<NW>(T, l, Qx, Qy, xP, yP, k, tc);
      f12_sparse_mul<NW>(f, f, l, k, tc);
    }
  }
}

// One lane of _miller_conj_tail: the Miller loop, conjugation when the loop
// parameter is negative, and on BN curves the chord lines through
// Q1 = pi(Q) and Q2 = -pi^2(Q).
template <int NW>
__device__ __noinline__ void miller_lane(F12<NW>& f, const uint32_t* xP, const uint32_t* yP,
                                         const F2<NW>& Qx, const F2<NW>& Qy,
                                         const uint8_t* bits, int nbits, const FieldConsts& k,
                                         const TowerConsts& tc) {
  G2Proj<NW> T;
  Line<NW> l;
  miller_loop<NW>(f, T, xP, yP, Qx, Qy, bits, nbits, k, tc);
  if (tc.conj_end) f12_conj<NW>(f, k);
  if (tc.bn_tail) {
    if (tc.conj_end) f2_neg<NW>(T.y, T.y, k);
    F2<NW> q1x, q1y, q2x, q2y, c;
    q1x = Qx;
    fp_neg<NW>(q1x.c[1], Qx.c[1], k);
    tail_const<NW>(c, tc, 0);
    f2_mul<NW>(q1x, q1x, c, k, tc);
    q1y = Qy;
    fp_neg<NW>(q1y.c[1], Qy.c[1], k);
    tail_const<NW>(c, tc, 1);
    f2_mul<NW>(q1y, q1y, c, k, tc);
    tail_const<NW>(c, tc, 2);
    f2_mul<NW>(q2x, Qx, c, k, tc);
    tail_const<NW>(c, tc, 3);
    f2_mul<NW>(q2y, Qy, c, k, tc);
    f2_neg<NW>(q2y, q2y, k);
    add_step<NW>(T, l, q1x, q1y, xP, yP, k, tc);
    f12_sparse_mul<NW>(f, f, l, k, tc);
    add_step<NW>(T, l, q2x, q2y, xP, yP, k, tc);
    f12_sparse_mul<NW>(f, f, l, k, tc);
  }
}

}  // namespace mlt
