// Fp2 arithmetic for one thread's lane and the tower's constants (port of
// mathlib_tpu/ops/kernels/pairing_pallas.py RowTower, eager path), shared by
// the G2 kernels (g2_rows.cuh, g2_kernels.cu, g2_smul_kernels.cu) and the
// split pairing kernels' launchers (TowerConsts).
//
// Every function computes what the reference's RowTower computes, operation
// for operation (Karatsuba order), so the relaxed [0, 2p) limbs that come out
// are the reference's.  A value here is NW 32-bit words (fp_rows.cuh); an f2
// is two of them.  Every function may be called with its output aliasing an
// input: results are built in temporaries first.
//
// q_mul (f2_mul) is a real call (__noinline__, as is fp_pow in fp_rows.cuh),
// its field muls inlined: the one-thread G2 formulas that call it
// (g2_rows.cuh) are far beyond what nvcc 12.9 survives inlined (it crashed
// on two inlined point formulas of a G1 kernel).
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
struct G2Proj {  // projective T = (X : Y : Z) on the twist
  F2<NW> x, y, z;
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

// a * m by the reference's add chain (RowCtx.mul_small), m >= 1
template <int NW>
__device__ __forceinline__ void f2_small(F2<NW>& r, const F2<NW>& a, int m,
                                         const FieldConsts& k) {
  fp_mul_small<NW>(r.c[0], a.c[0], m, k);
  fp_mul_small<NW>(r.c[1], a.c[1], m, k);
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

}  // namespace mlt
