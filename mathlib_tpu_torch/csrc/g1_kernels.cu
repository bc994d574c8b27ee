// G1 group-law kernels for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/g1_pallas.py.
//
//   g1_add_kernel     <- g1_pallas.py:_add_kernel     (add_pallas)
//   g1_double_kernel  <- g1_pallas.py:_double_kernel  (double_pallas)
//   g1_addsel_kernel  <- g1_pallas.py:_addsel_kernel  (addsel_pallas)
//   g1_smul_kernel    <- g1_pallas.py:_smul_kernel    (smul_pallas)
//
// Layout: a point batch is (3, L, n) 16-bit limbs in 32-bit words, the
// reference's lane-major structure of arrays.  One thread owns one lane:
// thread i reads limb l of coordinate c at [c][l][i], so a warp reads 128
// consecutive bytes per limb (coalesced), packs limb pairs into NW = L/2
// 32-bit words in registers, computes, and unpacks on the way out.
//
// The formulas are RCB (eprint 2015/1060, Algs 7 and 9, a = 0) in the
// reference's exact operation order (g1_pallas.py _rcb_add_rows and
// _rcb_dbl_rows): in the relaxed domain [0, 2p) a different order of adds,
// subs or small-multiple chains can land on the other representative.
//
// What bounds these kernels on an H100 is the integer multiply issue rate
// and registers, not bytes: an RCB add is 12 field muls (3,600 32x32->64
// multiplies at NW = 12) for 288 bytes in and 144 out.  The design keeps
// every operand in registers, with one lane per thread and no shared memory;
// a point is 36 words, and the add holds two points plus temporaries, so
// spills to local memory are accepted here.  Later work: PTX carry chains
// (madc), fewer registers per lane (a point add split over several threads),
// and fusing the MSM's row gather into addsel.
//
// Every launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

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
// 8 field muls inlined and fully unrolled.  Inlining them too, into the smul
// ladder, makes nvcc 12.9 crash (segfault); as calls they pass their points
// through the thread's stack (L1), ~100 words against ~3,600 multiplies.

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

template <int NW>
__device__ __forceinline__ void select_point(Point<NW>& O, bool sel, const Point<NW>& A,
                                             const Point<NW>& B) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    O.x[j] = sel ? A.x[j] : B.x[j];
    O.y[j] = sel ? A.y[j] : B.y[j];
    O.z[j] = sel ? A.z[j] : B.z[j];
  }
}

template <int NW>
__global__ void g1_add_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                              uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> a, b;
  load_point<NW>(a, P, n, i);
  load_point<NW>(b, Q, n, i);
  rcb_add<NW>(a, a, b, k, b3);
  store_point<NW>(out, a, n, i);
}

template <int NW>
__global__ void g1_double_kernel(const uint32_t* __restrict__ P, uint32_t* __restrict__ out,
                                 int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> a;
  load_point<NW>(a, P, n, i);
  rcb_dbl<NW>(a, a, k, b3);
  store_point<NW>(out, a, n, i);
}

// out = sel ? P + Q : Q -- the MSM's segmented-scan combiner
template <int NW>
__global__ void g1_addsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                                 const uint8_t* __restrict__ sel, uint32_t* __restrict__ out,
                                 int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> b;
  load_point<NW>(b, Q, n, i);
  if (sel[i]) {
    Point<NW> a;
    load_point<NW>(a, P, n, i);
    rcb_add<NW>(b, a, b, k, b3);
  }
  store_point<NW>(out, b, n, i);
}

// out = [k]Q per lane: MSB-first double, add, select from infinity; the
// accumulator stays in registers across all nbits steps
template <int NW>
__global__ void g1_smul_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                               uint32_t* __restrict__ out, int n, int nbits, FieldConsts k,
                               int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> q, acc, A;
  load_point<NW>(q, Q, n, i);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    acc.x[j] = 0;
    acc.y[j] = k.one[j];
    acc.z[j] = 0;
  }
  for (int b = nbits - 1; b >= 0; --b) {
    rcb_dbl<NW>(acc, acc, k, b3);
    rcb_add<NW>(A, acc, q, k, b3);
    const bool bit = (s[(int64_t)(b >> 4) * n + i] >> (b & 15)) & 1u;
    select_point<NW>(acc, bit, A, acc);
  }
  store_point<NW>(out, acc, n, i);
}

constexpr int kThreads = 128;

inline FieldConsts make_consts(const uint32_t* words, int nw) {
  // words: p[nw], 2p[nw], one[nw], np0 (host memory)
  FieldConsts k = {};
  for (int j = 0; j < nw; ++j) {
    k.p[j] = words[j];
    k.p2[j] = words[nw + j];
    k.one[j] = words[2 * nw + j];
  }
  k.np0 = words[3 * nw];
  return k;
}

inline dim3 grid_for(int n) { return dim3((unsigned)((n + kThreads - 1) / kThreads)); }

}  // namespace mlt

using namespace mlt;

// instantiate for L = 16 (BN254's p) and L = 24 (BLS12-381's and BLS12-377's p)
#define MLT_DISPATCH(L, ...)             \
  switch (L) {                           \
    case 16: {                           \
      constexpr int NW = 8;              \
      __VA_ARGS__;                       \
      break;                             \
    }                                    \
    case 24: {                           \
      constexpr int NW = 12;             \
      __VA_ARGS__;                       \
      break;                             \
    }                                    \
    default:                             \
      return -1;                         \
  }                                      \
  return (int)cudaGetLastError();

extern "C" int mlt_g1_add(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, int L,
                          const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_DISPATCH(L, g1_add_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      P, Q, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_double(const uint32_t* P, uint32_t* out, int n, int L,
                             const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_DISPATCH(L, g1_double_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      P, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_addsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3,
                             cudaStream_t stream) {
  MLT_DISPATCH(L, g1_addsel_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_smul(const uint32_t* Q, const uint32_t* s, uint32_t* out, int n, int L,
                           int S, int nbits, const uint32_t* consts, int b3,
                           cudaStream_t stream) {
  if (nbits > 16 * S) return -1;
  MLT_DISPATCH(L, g1_smul_kernel<NW><<<grid_for(n), kThreads, 0, stream>>>(
                      Q, s, out, n, nbits, make_consts(consts, NW), b3))
}
