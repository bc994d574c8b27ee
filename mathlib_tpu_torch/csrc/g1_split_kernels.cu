// The MSM's G1 kernels for Hopper (sm_90a), one RCB formula spread over the
// warps of a block: port of mathlib_tpu/ops/kernels/g1_pallas.py
//
//   g1_add_kernel     <- g1_pallas.py:_add_kernel     (add_pallas)
//   g1_addsel_kernel  <- g1_pallas.py:_addsel_kernel  (addsel_pallas)
//   g1_double_kernel  <- g1_pallas.py:_double_kernel  (double_pallas)
//
// out = P + Q, out = sel ? P + Q : Q (the MSM scan's combiner), and out = 2P,
// on (3, L, n) int32 words holding 16-bit limbs, Montgomery form, relaxed to
// [0, 2p), as the other G1 kernels (g1_rows.cuh has the layout).
//
// What bounds them on an H100 is the integer multiply rate: an add is 12
// field products (7,056 32-bit multiply-adds at NW = 12) for 288 bytes in and
// 144 out.  The one-thread design (rcb_add in g1_rows.cuh) holds two points
// and eight temporaries a thread: 255 registers, a stack, spills, 8 warps an
// SM, and 12 dependent products of latency a lane.  Here the add's shape is
// used instead: its 12 products fall into two layers of six independent ones
// (t0, t1, t2, s3, s4, s5; then xa, xb, ya, yb, za, zb) with a short linear
// middle between them.  A block owns 32 lanes and has six warps; thread t of
// every warp works on lane blockIdx.x * 32 + t, so each load and store is a
// 128-byte run, and
//
//   1. warp w stages one coordinate (P's X, Y, Z, Q's X, Y, Z) of the 32
//      lanes into shared memory;
//   2. warp w computes product w of the first layer from shared memory;
//   3. warp w computes the two middle values its second-layer product needs
//      (rcb_add's adds, subs and b3 chains, in rcb_add's order) from the six
//      first-layer products, and multiplies;
//   4. warps 0-2 form X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb, one
//      coordinate each, and store (Q's limbs where sel is 0).
//
// The doubling (RCB Alg 9, rcb_dbl) is 8 products in two layers of four
// (Y Y, Y Z, Z Z, X Y; then t0m xy, t2 z3t, t0m y3t, t1 z3t) for 288 bytes:
// the same design over four warps.  The MSM runs it at 16 lanes (one a
// window) and Horner at one, so what it pays there is the latency of a
// lane, two products instead of eight.
//
// A thread holds two operands and one product: no stack, no spill (ptxas'
// report is on chip_smoke.py's build lines), and a lane waits for two
// products, not twelve or eight.  A block none of whose lanes adds copies
// Q.  Shared memory: 12 slots of NW x 32 words (18 KB at NW = 12) for the
// add, 7 for the doubling.  The field product is fp_mul_ptx (PTX carry
// chains): 1-2 % faster than fp_mul in these kernels on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md section 6).
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_rows.cuh"

namespace mlt {

constexpr int kSplitLanes = 32;
constexpr int kSplitThreads = 6 * kSplitLanes;
// blocks an SM must hold: caps the registers at 65,536 / (3 x 192) = 112
constexpr int kSplitMinBlocks = 3;

// slots: 0-5 P's X, Y, Z and Q's X, Y, Z, then (once the first layer has
// read them) the second layer's xa, xb, ya, yb, za, zb; 6-11 the first
// layer's t0, t1, t2, s3, s4, s5
template <int NW>
using Slots = uint32_t[12][NW][kSplitLanes];

template <int NW>
__device__ __forceinline__ void slot_get(uint32_t* v, const uint32_t (*s)[kSplitLanes], int t) {
#pragma unroll
  for (int j = 0; j < NW; ++j) v[j] = s[j][t];
}

template <int NW>
__device__ __forceinline__ void slot_put(uint32_t (*s)[kSplitLanes], const uint32_t* v, int t) {
#pragma unroll
  for (int j = 0; j < NW; ++j) s[j][t] = v[j];
}

// coordinate c of lane i copied limb for limb (an unselected lane's Q)
template <int NW>
__device__ __forceinline__ void copy_coord(uint32_t* dst, const uint32_t* src, int c, int64_t n,
                                           int64_t i) {
  const int64_t base = (int64_t)c * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) dst[base + j * n] = src[base + j * n];
}

// the middle values of RCB Alg 7, each from the first layer's products
enum Mid { kT3, kT4, kLnb, kT0x3, kZ3t, kT1m };

// r = one middle value, by rcb_add's operations in rcb_add's order
template <int NW>
__device__ __forceinline__ void rcb_mid(uint32_t* r, int id, const Slots<NW>& S, int t,
                                        const FieldConsts& k, int b3) {
  uint32_t u[NW], v[NW];
  switch (id) {
    case kT3:  // s3 - (t0 + t1)
      slot_get<NW>(u, S[6], t);
      slot_get<NW>(v, S[7], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, S[9], t);
      fp_sub<NW>(r, v, u, k);
      break;
    case kT4:  // s4 - (t1 + t2)
      slot_get<NW>(u, S[7], t);
      slot_get<NW>(v, S[8], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, S[10], t);
      fp_sub<NW>(r, v, u, k);
      break;
    case kLnb:  // b3 (s5 - (t0 + t2))
      slot_get<NW>(u, S[6], t);
      slot_get<NW>(v, S[8], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, S[11], t);
      fp_sub<NW>(u, v, u, k);
      fp_mul_small<NW>(r, u, b3, k);
      break;
    case kT0x3:  // (t0 + t0) + t0
      slot_get<NW>(v, S[6], t);
      fp_add<NW>(u, v, v, k);
      fp_add<NW>(r, u, v, k);
      break;
    default:  // kZ3t: t1 + b3 t2; kT1m: t1 - b3 t2
      slot_get<NW>(u, S[8], t);
      fp_mul_small<NW>(u, u, b3, k);
      slot_get<NW>(v, S[7], t);
      if (id == kZ3t) {
        fp_add<NW>(r, v, u, k);
      } else {
        fp_sub<NW>(r, v, u, k);
      }
  }
}

// warp w's second-layer product: xa = t3 t1m, xb = t4 lnb, ya = t1m z3t,
// yb = lnb t0_3, za = z3t t4, zb = t0_3 t3
__constant__ int kMidA[6] = {kT3, kT4, kT1m, kLnb, kZ3t, kT0x3};
__constant__ int kMidB[6] = {kT1m, kLnb, kZ3t, kT0x3, kT4, kT3};

// out = P + Q (SEL false) or sel ? P + Q : Q (SEL true), for the 32 lanes
// of this block
template <int NW, bool SEL>
__device__ __forceinline__ void split_add(const uint32_t* __restrict__ P,
                                          const uint32_t* __restrict__ Q,
                                          const uint8_t* __restrict__ sel,
                                          uint32_t* __restrict__ out, int n, const FieldConsts& k,
                                          int b3) {
  __shared__ Slots<NW> S;
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int64_t i = (int64_t)blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  const bool adds = live && (!SEL || sel[i]);
  if (SEL && !__syncthreads_or(adds)) {  // no lane of the block adds: out = Q
    if (w < 3 && live) copy_coord<NW>(out, Q, w, n, i);
    return;
  }
  {  // 1. stage coordinate w % 3 of P (w < 3) or Q
    uint32_t v[NW] = {};
    if (live) load_coord<NW>(v, w < 3 ? P : Q, w % 3, n, i);
    slot_put<NW>(S[w], v, t);
  }
  __syncthreads();
  {  // 2. t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2; s3, s4, s5 from sums of two coordinates
    uint32_t a[NW], b[NW];
    if (w < 3) {
      slot_get<NW>(a, S[w], t);
      slot_get<NW>(b, S[w + 3], t);
    } else {  // s3: (X, Y), s4: (Y, Z), s5: (X, Z)
      const int c0 = w == 4 ? 1 : 0, c1 = w == 3 ? 1 : 2;
      uint32_t u[NW];
      slot_get<NW>(a, S[c0], t);
      slot_get<NW>(u, S[c1], t);
      fp_add<NW>(a, a, u, k);
      slot_get<NW>(b, S[c0 + 3], t);
      slot_get<NW>(u, S[c1 + 3], t);
      fp_add<NW>(b, b, u, k);
    }
    fp_mul_ptx<NW>(a, a, b, k);
    slot_put<NW>(S[6 + w], a, t);
  }
  __syncthreads();
  {  // 3. the second layer; slots 0-5 are free since the last barrier
    uint32_t a[NW], b[NW];
    rcb_mid<NW>(a, kMidA[w], S, t, k, b3);
    rcb_mid<NW>(b, kMidB[w], S, t, k, b3);
    fp_mul_ptx<NW>(a, a, b, k);
    slot_put<NW>(S[w], a, t);
  }
  __syncthreads();
  if (w < 3 && live) {  // 4. X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb
    if (adds) {
      uint32_t a[NW], b[NW];
      slot_get<NW>(a, S[2 * w], t);
      slot_get<NW>(b, S[2 * w + 1], t);
      if (w == 0) {
        fp_sub<NW>(a, a, b, k);
      } else {
        fp_add<NW>(a, a, b, k);
      }
      store_coord<NW>(out, a, w, n, i);
    } else {
      copy_coord<NW>(out, Q, w, n, i);
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_add_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                  uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  split_add<NW, false>(P, Q, nullptr, out, n, k, b3);
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_addsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, int b3) {
  split_add<NW, true>(P, Q, sel, out, n, k, b3);
}

constexpr int kDblThreads = 4 * kSplitLanes;
// blocks an SM must hold: caps the registers at 65,536 / (4 x 128) = 128
constexpr int kDblMinBlocks = 4;

// slots: 0-2 P's X, Y, Z, then (once the first layer has read them) the
// second layer's dxa, dya, dyb; 3-6 the first layer's t0 = Y Y, t1 = Y Z,
// zz = Z Z, xy = X Y, and dz over t1, which warp 3 alone reads
template <int NW>
using DblSlots = uint32_t[7][NW][kSplitLanes];

// warp w's operands of the second layer: dxa = t0m xy, dya = t2 z3t,
// dyb = t0m y3t, dz = t1 z3t, each middle value by rcb_dbl's operations in
// rcb_dbl's order (z3t = 8 t0, t2 = b3 zz, y3t = t0 + t2,
// t0m = t0 - ((t2 + t2) + t2))
template <int NW>
__device__ __forceinline__ void dbl_mid(uint32_t* a, uint32_t* b, int w, const DblSlots<NW>& S,
                                        int t, const FieldConsts& k, int b3) {
  uint32_t t0[NW], u[NW];
  slot_get<NW>(t0, S[3], t);
  if (w == 1 || w == 3) {
    fp_mul_small<NW>(b, t0, 8, k);  // z3t
    if (w == 1) {
      slot_get<NW>(u, S[5], t);
      fp_mul_small<NW>(a, u, b3, k);  // t2
    } else {
      slot_get<NW>(a, S[4], t);  // t1
    }
    return;
  }
  slot_get<NW>(u, S[5], t);
  fp_mul_small<NW>(u, u, b3, k);  // t2
  if (w == 2) {
    fp_add<NW>(b, t0, u, k);  // y3t
  } else {
    slot_get<NW>(b, S[6], t);  // xy
  }
  fp_add<NW>(a, u, u, k);
  fp_add<NW>(a, a, u, k);  // t2_3
  fp_sub<NW>(a, t0, a, k);  // t0m
}

// out = 2P for the 32 lanes of this block
template <int NW>
__device__ __forceinline__ void split_dbl(const uint32_t* __restrict__ P,
                                          uint32_t* __restrict__ out, int n, const FieldConsts& k,
                                          int b3) {
  __shared__ DblSlots<NW> S;
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int64_t i = (int64_t)blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  if (w < 3) {  // 1. stage coordinate w of P
    uint32_t v[NW] = {};
    if (live) load_coord<NW>(v, P, w, n, i);
    slot_put<NW>(S[w], v, t);
  }
  __syncthreads();
  {  // 2. t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y
    uint32_t a[NW], b[NW];
    slot_get<NW>(a, S[w == 2 ? 2 : w == 3 ? 0 : 1], t);
    slot_get<NW>(b, S[w == 0 || w == 3 ? 1 : 2], t);
    fp_mul_ptx<NW>(a, a, b, k);
    slot_put<NW>(S[3 + w], a, t);
  }
  __syncthreads();
  uint32_t a[NW], b[NW];  // 3. the middle values, then the second layer
  dbl_mid<NW>(a, b, w, S, t, k, b3);
  fp_mul_ptx<NW>(a, a, b, k);
  slot_put<NW>(S[w == 3 ? 4 : w], a, t);
  __syncthreads();
  if (w < 3 && live) {  // 4. X3 = dxa + dxa, Y3 = dya + dyb, Z3 = dz
    slot_get<NW>(a, S[w == 0 ? 0 : w == 1 ? 1 : 4], t);
    if (w == 0) {
      fp_add<NW>(a, a, a, k);
    } else if (w == 1) {
      slot_get<NW>(b, S[2], t);
      fp_add<NW>(a, a, b, k);
    }
    store_coord<NW>(out, a, w, n, i);
  }
}

template <int NW>
__global__ void __launch_bounds__(kDblThreads, kDblMinBlocks)
    g1_double_kernel(const uint32_t* __restrict__ P, uint32_t* __restrict__ out, int n,
                     FieldConsts k, int b3) {
  split_dbl<NW>(P, out, n, k, b3);
}

inline dim3 split_grid(int n) { return dim3((unsigned)((n + kSplitLanes - 1) / kSplitLanes)); }

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
  MLT_DISPATCH(L, g1_add_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_addsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3,
                             cudaStream_t stream) {
  MLT_DISPATCH(L, g1_addsel_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

extern "C" int mlt_g1_double(const uint32_t* P, uint32_t* out, int n, int L,
                             const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_DISPATCH(L, g1_double_kernel<NW><<<split_grid(n), kDblThreads, 0, stream>>>(
                      P, out, n, make_consts(consts, NW), b3))
}
