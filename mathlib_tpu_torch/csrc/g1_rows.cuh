// G1 point arithmetic for one thread's registers, shared by the G1 kernels
// (g1_kernels.cu, g1_split_kernels.cu) and the hash-to-G1 kernel
// (hash_kernels.cu): port of mathlib_tpu/ops/kernels/g1_pallas.py
// _rcb_add_rows and _rcb_dbl_rows.
//
// Layout: a point batch is (3, L, n) 16-bit limbs in 32-bit words, the
// reference's lane-major structure of arrays.  One thread owns one lane:
// thread i reads limb l of coordinate c at [c][l][i], so a warp reads 128
// consecutive bytes per limb (coalesced), packs limb pairs into NW = L/2
// 32-bit words in registers, computes, and unpacks on the way out.
//
// The formulas are RCB (eprint 2015/1060, Algs 7 and 9, a = 0) in the
// reference's exact operation order: in the relaxed domain [0, 2p) a
// different order of adds, subs or small-multiple chains can land on the
// other representative.  Negation is the reference's sub(0, Y) with 2p added
// back, not p - Y.
#pragma once

#include <cstdint>

#include "fp_rows.cuh"

namespace mlt {

template <int NW>
struct Point {
  uint32_t x[NW], y[NW], z[NW];
};

template <int NW>
__device__ __forceinline__ void load_coord(uint32_t* w, const uint32_t* src, int c,
                                           int64_t n, int64_t i) {
  const uint32_t* base = src + (int64_t)c * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    w[j] = (base[(2 * j) * n] & 0xFFFFu) | (base[(2 * j + 1) * n] << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_coord(uint32_t* dst, const uint32_t* w, int c,
                                            int64_t n, int64_t i) {
  uint32_t* base = dst + (int64_t)c * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[(2 * j) * n] = w[j] & 0xFFFFu;
    base[(2 * j + 1) * n] = w[j] >> 16;
  }
}

template <int NW>
__device__ __forceinline__ void load_point(Point<NW>& P, const uint32_t* src, int64_t n,
                                           int64_t i) {
  load_coord<NW>(P.x, src, 0, n, i);
  load_coord<NW>(P.y, src, 1, n, i);
  load_coord<NW>(P.z, src, 2, n, i);
}

template <int NW>
__device__ __forceinline__ void store_point(uint32_t* dst, const Point<NW>& P, int64_t n,
                                            int64_t i) {
  store_coord<NW>(dst, P.x, 0, n, i);
  store_coord<NW>(dst, P.y, 1, n, i);
  store_coord<NW>(dst, P.z, 2, n, i);
}

// The two point formulas are real calls (__noinline__), each with its 12 or
// 8 field muls inlined and fully unrolled.  Inlining them too, into the
// one-thread ladders, makes nvcc 12.9 crash (segfault); as calls they pass
// their points through the thread's stack (L1), ~100 words against ~3,600
// products.

// RCB Algorithm 7 (a = 0): O = P + Q, complete.  O may alias P or Q.
template <int NW>
__device__ __noinline__ void rcb_add(Point<NW>& O, const Point<NW>& P, const Point<NW>& Q,
                                        const FieldConsts& k, int b3) {
  uint32_t t0[NW], t1[NW], t2[NW], s3[NW], s4[NW], s5[NW], u[NW], v[NW];
  fp_mul<NW>(t0, P.x, Q.x, k);
  fp_mul<NW>(t1, P.y, Q.y, k);
  fp_mul<NW>(t2, P.z, Q.z, k);
  fp_add<NW>(u, P.x, P.y, k);
  fp_add<NW>(v, Q.x, Q.y, k);
  fp_mul<NW>(s3, u, v, k);
  fp_add<NW>(u, P.y, P.z, k);
  fp_add<NW>(v, Q.y, Q.z, k);
  fp_mul<NW>(s4, u, v, k);
  fp_add<NW>(u, P.x, P.z, k);
  fp_add<NW>(v, Q.x, Q.z, k);
  fp_mul<NW>(s5, u, v, k);
  // t3 = s3 - (t0 + t1); t4 = s4 - (t1 + t2); ln = s5 - (t0 + t2)
  fp_add<NW>(u, t0, t1, k);
  fp_sub<NW>(s3, s3, u, k);  // s3 := t3
  fp_add<NW>(u, t1, t2, k);
  fp_sub<NW>(s4, s4, u, k);  // s4 := t4
  fp_add<NW>(u, t0, t2, k);
  fp_sub<NW>(s5, s5, u, k);  // s5 := ln
  // t0_3 = (t0 + t0) + t0
  fp_add<NW>(u, t0, t0, k);
  fp_add<NW>(t0, u, t0, k);  // t0 := t0_3
  fp_mul_small<NW>(t2, t2, b3, k);  // t2 := t2b
  fp_mul_small<NW>(s5, s5, b3, k);  // s5 := lnb
  fp_add<NW>(u, t1, t2, k);         // u := z3t
  fp_sub<NW>(v, t1, t2, k);         // v := t1m
  // xa = t3*t1m, xb = t4*lnb, ya = t1m*z3t, yb = lnb*t0_3, za = z3t*t4, zb = t0_3*t3
  uint32_t xa[NW], xb[NW];
  fp_mul<NW>(xa, s3, v, k);
  fp_mul<NW>(xb, s4, s5, k);
  fp_mul<NW>(v, v, u, k);    // v := ya
  fp_mul<NW>(s5, s5, t0, k);  // s5 := yb
  fp_mul<NW>(u, u, s4, k);   // u := za
  fp_mul<NW>(t0, t0, s3, k);  // t0 := zb
  fp_sub<NW>(O.x, xa, xb, k);
  fp_add<NW>(O.y, v, s5, k);
  fp_add<NW>(O.z, u, t0, k);
}

// RCB Algorithm 9 (a = 0): O = 2P.  O may alias P.
template <int NW>
__device__ __noinline__ void rcb_dbl(Point<NW>& O, const Point<NW>& P, const FieldConsts& k,
                                        int b3) {
  uint32_t t0[NW], t1[NW], zz[NW], xy[NW], z3t[NW], t2[NW], y3t[NW], u[NW];
  fp_mul<NW>(t0, P.y, P.y, k);
  fp_mul<NW>(t1, P.y, P.z, k);
  fp_mul<NW>(zz, P.z, P.z, k);
  fp_mul<NW>(xy, P.x, P.y, k);
  fp_mul_small<NW>(z3t, t0, 8, k);
  fp_mul_small<NW>(t2, zz, b3, k);
  fp_add<NW>(y3t, t0, t2, k);
  fp_add<NW>(u, t2, t2, k);
  fp_add<NW>(u, u, t2, k);   // u := t2_3
  fp_sub<NW>(t0, t0, u, k);  // t0 := t0m
  // dxa = t0m*xy, dya = t2*z3t, dyb = t0m*y3t, dz = t1*z3t
  fp_mul<NW>(xy, t0, xy, k);
  fp_mul<NW>(t2, t2, z3t, k);
  fp_mul<NW>(y3t, t0, y3t, k);
  fp_mul<NW>(O.z, t1, z3t, k);
  fp_add<NW>(O.x, xy, xy, k);
  fp_add<NW>(O.y, t2, y3t, k);
}

// y = sub(0, y) in the relaxed domain
template <int NW>
__device__ __forceinline__ void neg_y(uint32_t* y, const FieldConsts& k) {
  uint32_t zero[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) zero[j] = 0;
  fp_sub<NW>(y, zero, y, k);
}

}  // namespace mlt
