// G2 point arithmetic for one thread's registers, for the G2 addsel kernel
// (g2_kernels.cu; the ladders and the add, doubling and dblsel kernels of
// g2_smul_kernels.cu take B3, f2_mul_b3's branches and the layout from here): port of
// mathlib_tpu/ops/kernels/g2_pallas.py Row2Ctx and _rcb_add.
//
// Layout: a point batch is (3, 2, L, n) 16-bit limbs in 32-bit words, the
// reference's lane-major structure of arrays (coefficient q = c*2 + j of
// coordinate c, Fp2 component j); one thread owns one lane and reads it with
// lanes.cuh's load_T / store_T, as the pairing kernels read T.
//
// Fp2 is Fp[u]/(u^2 + 1).  A product is tower_rows.cuh's f2_mul with
// tc.n == 1, which is Row2Ctx's Karatsuba exactly: t0 = a0 b0, t1 = a1 b1,
// t2 = (a0 + a1)(b0 + b1), c0 = t0 - t1 (fp_mul_small by 1 is a copy),
// c1 = t2 - (t0 + t1).  The add is RCB (eprint 2015/1060, Alg 7, a = 0) in
// the reference's exact operation order, so the relaxed [0, 2p) limbs that
// come out are the reference kernel's.
#pragma once

#include <cstdint>

#include "lanes.cuh"

namespace mlt {

// the twist constant 3 b2 = c0 + c1 u, both small (0 <= c < 256, not both 0)
struct B3 {
  int c0, c1;
};

// a * b3 by the four branches of Row2Ctx.mul_b3 (small multiples are
// RowCtx.mul_small's add chain, fp_mul_small).  r may alias a.
template <int NW>
__device__ __noinline__ void f2_mul_b3(F2<NW>& r, const F2<NW>& a, B3 b3, const FieldConsts& k) {
  uint32_t x[NW], y[NW];
  if (b3.c1 == 0) {
    fp_mul_small<NW>(x, a.c[0], b3.c0, k);
    fp_mul_small<NW>(y, a.c[1], b3.c0, k);
  } else if (b3.c0 == 0) {
    fp_mul_small<NW>(y, a.c[1], b3.c1, k);
    fp_neg<NW>(x, y, k);
    fp_mul_small<NW>(y, a.c[0], b3.c1, k);
  } else if (b3.c0 == b3.c1) {
    fp_sub<NW>(x, a.c[0], a.c[1], k);
    fp_add<NW>(y, a.c[0], a.c[1], k);
    fp_mul_small<NW>(x, x, b3.c0, k);
    fp_mul_small<NW>(y, y, b3.c0, k);
  } else {
    uint32_t s[NW], t[NW];
    fp_mul_small<NW>(s, a.c[0], b3.c0, k);
    fp_mul_small<NW>(t, a.c[1], b3.c1, k);
    fp_sub<NW>(x, s, t, k);
    fp_mul_small<NW>(s, a.c[1], b3.c0, k);
    fp_mul_small<NW>(t, a.c[0], b3.c1, k);
    fp_add<NW>(y, s, t, k);
  }
  fp_copy<NW>(r.c[0], x);
  fp_copy<NW>(r.c[1], y);
}

// The point formula is a real call (__noinline__), with its Fp2 products as
// calls too: nvcc 12.9 crashed when it inlined the G1 formulas into a
// one-thread ladder, and a G2 point is twice a G1 point.  Points and
// temporaries (~10 Fp2 values, 240 words) live on the thread's stack.

// RCB Algorithm 7 (a = 0) over Fp2: O = P + Q, complete (_rcb_add).  O may
// alias P or Q.
template <int NW>
__device__ __noinline__ void rcb_add2(G2Proj<NW>& O, const G2Proj<NW>& P, const G2Proj<NW>& Q,
                                      const FieldConsts& k, const TowerConsts& tc, B3 b3) {
  F2<NW> t0, t1, t2, s3, s4, s5, u, v;
  f2_mul<NW>(t0, P.x, Q.x, k, tc);
  f2_mul<NW>(t1, P.y, Q.y, k, tc);
  f2_mul<NW>(t2, P.z, Q.z, k, tc);
  f2_add<NW>(u, P.x, P.y, k);
  f2_add<NW>(v, Q.x, Q.y, k);
  f2_mul<NW>(s3, u, v, k, tc);
  f2_add<NW>(u, P.y, P.z, k);
  f2_add<NW>(v, Q.y, Q.z, k);
  f2_mul<NW>(s4, u, v, k, tc);
  f2_add<NW>(u, P.x, P.z, k);
  f2_add<NW>(v, Q.x, Q.z, k);
  f2_mul<NW>(s5, u, v, k, tc);
  // t3 = s3 - (t0 + t1); t4 = s4 - (t1 + t2); ln = s5 - (t0 + t2)
  f2_add<NW>(u, t0, t1, k);
  f2_sub<NW>(s3, s3, u, k);  // s3 := t3
  f2_add<NW>(u, t1, t2, k);
  f2_sub<NW>(s4, s4, u, k);  // s4 := t4
  f2_add<NW>(u, t0, t2, k);
  f2_sub<NW>(s5, s5, u, k);  // s5 := ln
  // t0_3 = (t0 + t0) + t0
  f2_add<NW>(u, t0, t0, k);
  f2_add<NW>(t0, u, t0, k);        // t0 := t0_3
  f2_mul_b3<NW>(t2, t2, b3, k);    // t2 := t2b
  f2_mul_b3<NW>(s5, s5, b3, k);    // s5 := lnb
  f2_add<NW>(u, t1, t2, k);        // u := z3t
  f2_sub<NW>(v, t1, t2, k);        // v := t1m
  // xa = t3*t1m, xb = t4*lnb, ya = t1m*z3t, yb = lnb*t0_3, za = z3t*t4, zb = t0_3*t3
  F2<NW> xa, xb;
  f2_mul<NW>(xa, s3, v, k, tc);
  f2_mul<NW>(xb, s4, s5, k, tc);
  f2_mul<NW>(v, v, u, k, tc);     // v := ya
  f2_mul<NW>(s5, s5, t0, k, tc);  // s5 := yb
  f2_mul<NW>(u, u, s4, k, tc);    // u := za
  f2_mul<NW>(t0, t0, s3, k, tc);  // t0 := zb
  f2_sub<NW>(O.x, xa, xb, k);
  f2_add<NW>(O.y, v, s5, k);
  f2_add<NW>(O.z, u, t0, k);
}

// The launchers' shared parts: Fp2 with u^2 = -1 (tc.n = 1; the rest of the
// tower constants is unused here), 32 threads a block so that 4,096 lanes
// spread over 128 SMs, and L = 24 only (12 words: BLS12-381, the one curve
// with an even limb count in the reference's gate).
inline TowerConsts g2_tower() {
  TowerConsts tc = {};
  tc.n = 1;
  return tc;
}

constexpr int kG2Threads = 32;

inline dim3 g2_grid(int n) { return dim3((unsigned)((n + kG2Threads - 1) / kG2Threads)); }

}  // namespace mlt

#define MLT_G2_DISPATCH(L, ...)          \
  switch (L) {                           \
    case 24: {                           \
      constexpr int NW = 12;             \
      __VA_ARGS__;                       \
      break;                             \
    }                                    \
    default:                             \
      return -1;                         \
  }                                      \
  return (int)cudaGetLastError();
