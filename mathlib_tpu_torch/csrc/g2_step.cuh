// The G2 ladder's step on a block's warps, shared by every G2 point kernel
// for Hopper (sm_90a): the ladders (g2_smul_kernels.cu), the add, doubling
// and addsel kernels (g2_point_kernels.cu) and dblsel (g2_dblsel_kernels.cu),
// each source its own nvcc process.  Port of the point arithmetic of
// mathlib_tpu/ops/kernels/g2_pallas.py (Row2Ctx, _rcb_add, _rcb_double).
//
// Layout: a point batch is (3, 2, L, n) 16-bit limbs in 32-bit words, the
// reference's lane-major structure of arrays (coefficient q = c*2 + j of
// coordinate c, Fp2 component j, read and written with fp_rows.cuh's
// load_fp / store_fp).  Fp2 is Fp[u]/(u^2 + 1); a product is Row2Ctx's
// Karatsuba, t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1), c0 = t0 - t1,
// c1 = t2 - (t0 + t1), each piece one base-field product.  The doubling is
// RCB (eprint 2015/1060) Alg 9 over Fp2 in _rcb_double's order, two layers
// of 12 field products; the add is Alg 7 (a = 0) in _rcb_add's order, two
// layers of 18.
//
// A block owns LB lanes (16 or 32) and has a worker of LB threads for each
// field product of a layer (18; the doubling's kernel 12); thread t of every
// worker works on lane blockIdx.x * LB + t, so each load and store of a limb
// is a run of consecutive words.  One half of a ladder bit, the doubling
// D = 2 acc or the add A = D + Q, is five steps with a barrier after each
// of the first four (half_bit):
//
//   1. the first layer: worker x makes field product x (Fp2 product x / 3,
//      piece x % 3): Y Y, Y Z, Z Z, X Y of acc (12 workers), or t0, t1, t2,
//      s3, s4, s5 of D and Q (18);
//   2. worker v forms component v % 2 of the first layer's Fp2 product v / 2
//      from its pieces (c0 = t0 - t1, c1 = t2 - (t0 + t1));
//   3. worker v forms component v % 2 of middle value v / 2: t0m, t2, z3t,
//      y3t, or t3, t4, lnb, t0_3, z3t, t1m (b3 by Row2Ctx.mul_b3's branches);
//   4. the second layer: dxa, dya, dyb, dz, or xa, xb, ya, yb, za, zb;
//   5. the caller's: point_out gives worker w < 6 component w of the result
//      (D = (dxa + dxa, dya + dyb, dz), or A = (xa - xb, ya + yb, za + zb)),
//      which each kernel stores or selects its own way (one step-5 store
//      shared by both halves of the ladder made its cofactor ladders 1-2 %
//      slower on an H100).
//
// The operands, the products and the middle values stay in shared memory
// (a layout of slots of NW x LB words, Slots), and a thread holds two
// operands and one product at a time: no stack, no spill at 18 warps,
// whose five warps on one scheduler leave 96 registers a thread
// (kStepRegs).  Each field product gets the reference's operands; the adds
// and subs in between may run in any order, since each returns the unique
// value in [0, 2p) of its residue mod 2p, so the limbs that come out are
// the reference kernel's.
//
// The kernels take the reference's gate: beta = -1 and a small twist
// constant b3 = 3 b2 (B3): L = 24 (12 words, BLS12-381) and L = 18 (9
// words, FP256BN on the card) are built, the second in each source's twin.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fp_rows.cuh"

namespace mlt {

// the twist constant 3 b2 = c0 + c1 u, both small (0 <= c < 256, not both 0)
struct B3 {
  int c0, c1;
};

template <int NW>
__device__ __forceinline__ void fp_neg(uint32_t* r, const uint32_t* a, const FieldConsts& k) {
  uint32_t z[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) z[j] = 0;
  fp_sub<NW>(r, z, a, k);
}

constexpr int kLadderWorkers = 18;  // one a field product of the add's layers
constexpr int kDblWorkers = 12;     // one a field product of the doubling's
constexpr int kStepRegs = 96;       // the one-step kernels' register cap (18 warps)

// where a block's shared slots start, each NW words for each of its LB
// lanes: the point buffers (coordinate c's component j at c * 2 + j), Q, a
// layer's field products K (Fp2 product e's piece p at 3e + p), the first
// layer's Fp2 products F (e's component j at 2e + j), the middle values M
// (value m's component j at 2m + j), and the slot count
template <int PT, int Q, int K, int F, int M, int N>
struct Slots {
  static constexpr int kPt = PT, kQ = Q, kK = K, kF = F, kM = M, kN = N;
};
// the ladder: acc and D, Q, K 18, F 12, M 12 (the scalar limbs after them)
using LadderSlots = Slots<0, 12, 18, 36, 48, 60>;
// the add and addsel: P, Q, K 18, F 12, M 12
using AddSlots = Slots<0, 6, 12, 30, 42, 54>;
// the doubling: P, K 12, F 8, M 8 (no Q)
using DblSlots = Slots<0, 0, 6, 18, 26, 34>;

template <int NW, int LB>
__device__ __forceinline__ void sget(uint32_t* v, const uint32_t* sm, int s, int t) {
  const uint32_t* p = sm + s * (NW * LB) + t;
#pragma unroll
  for (int j = 0; j < NW; ++j) v[j] = p[j * LB];
}

template <int NW, int LB>
__device__ __forceinline__ void sput(uint32_t* sm, int s, const uint32_t* v, int t) {
  uint32_t* p = sm + s * (NW * LB) + t;
#pragma unroll
  for (int j = 0; j < NW; ++j) p[j * LB] = v[j];
}

// component j of Fp2 product e from its Karatsuba pieces (Row2Ctx's
// product, u^2 = -1): c0 = t0 - t1, c1 = t2 - (t0 + t1)
template <int NW, int LB, class S>
__device__ __forceinline__ void kara(uint32_t* r, const uint32_t* sm, int e, int j, int t,
                                     const FieldConsts& k) {
  uint32_t a[NW], b[NW];
  sget<NW, LB>(a, sm, S::kK + 3 * e, t);
  sget<NW, LB>(b, sm, S::kK + 3 * e + 1, t);
  if (j == 0) {
    fp_sub<NW>(r, a, b, k);
    return;
  }
  fp_add<NW>(a, a, b, k);
  sget<NW, LB>(b, sm, S::kK + 3 * e + 2, t);
  fp_sub<NW>(r, b, a, k);
}

// component j of b3 (a0 + a1 u) by the branch of Row2Ctx.mul_b3 that b3
// takes (small multiples are RowCtx.mul_small's add chain, fp_mul_small)
template <int NW>
__device__ __forceinline__ void b3_comp(uint32_t* r, const uint32_t* a0, const uint32_t* a1,
                                        int j, B3 b3, const FieldConsts& k) {
  if (b3.c1 == 0) {
    if (j == 0) {
      fp_mul_small<NW>(r, a0, b3.c0, k);
    } else {
      fp_mul_small<NW>(r, a1, b3.c0, k);
    }
  } else if (b3.c0 == 0) {
    if (j == 0) {
      fp_mul_small<NW>(r, a1, b3.c1, k);
      fp_neg<NW>(r, r, k);
    } else {
      fp_mul_small<NW>(r, a0, b3.c1, k);
    }
  } else if (b3.c0 == b3.c1) {
    if (j == 0) {
      fp_sub<NW>(r, a0, a1, k);
    } else {
      fp_add<NW>(r, a0, a1, k);
    }
    fp_mul_small<NW>(r, r, b3.c0, k);
  } else {
    uint32_t u[NW];
    if (j == 0) {
      fp_mul_small<NW>(r, a0, b3.c0, k);
      fp_mul_small<NW>(u, a1, b3.c1, k);
      fp_sub<NW>(r, r, u, k);
    } else {
      fp_mul_small<NW>(r, a1, b3.c0, k);
      fp_mul_small<NW>(u, a0, b3.c1, k);
      fp_add<NW>(r, r, u, k);
    }
  }
}

// component j of b3 t2 (the doubling's t2 = b3 zz, the add's t2b), the
// first layer's Fp2 product 2 in F + 4, 5
template <int NW, int LB, class S>
__device__ __forceinline__ void b3_prod2(uint32_t* r, const uint32_t* sm, int j, int t, B3 b3,
                                         const FieldConsts& k) {
  uint32_t a0[NW], a1[NW];
  sget<NW, LB>(a0, sm, S::kF + 4, t);
  sget<NW, LB>(a1, sm, S::kF + 5, t);
  b3_comp<NW>(r, a0, a1, j, b3, k);
}

// component j of an Fp2 operand x of the point in slots P..P+5: x < 3 a
// coordinate, 3 X + Y, 4 Y + Z, 5 X + Z (the add's sums, f2_add)
template <int NW, int LB>
__device__ __forceinline__ void pt_get(uint32_t* r, const uint32_t* sm, int P, int x, int j,
                                       int t, const FieldConsts& k) {
  if (x < 3) {
    sget<NW, LB>(r, sm, P + 2 * x + j, t);
    return;
  }
  const int c0 = x == 4 ? 1 : 0, c1 = x == 3 ? 1 : 2;
  uint32_t u[NW];
  sget<NW, LB>(r, sm, P + 2 * c0 + j, t);
  sget<NW, LB>(u, sm, P + 2 * c1 + j, t);
  fp_add<NW>(r, r, u, k);
}

// Karatsuba piece p of an Fp2 operand whose component j get(r, j) reads:
// a0 (p = 0), a1 (p = 1), a0 + a1 (p = 2)
template <int NW, class Get>
__device__ __forceinline__ void piece(uint32_t* r, int p, const Get& get, const FieldConsts& k) {
  if (p < 2) {
    get(r, p);
    return;
  }
  uint32_t u[NW];
  get(r, 0);
  get(u, 1);
  fp_add<NW>(r, r, u, k);
}

// the Fp2 operands of each layer's products [h][e], h = 0 the doubling, 1
// the add: the first layers' as point operands (pt_get: Y Y, Y Z, Z Z, X Y;
// then D's and Q's X, Y, Z, X + Y, Y + Z, X + Z), the second layers' as the
// first of the value's two slots, 2e for the first layer's Fp2 product e
// (from F) and M0 + 2m for middle value m (from M), so that one table
// serves every layout (dxa = t0m xy, dya = t2 z3t, dyb = t0m y3t,
// dz = t1 z3t, t1 and xy the first layer's Fp2 products; xa = t3 t1m,
// xb = t4 lnb, ya = t1m z3t, yb = lnb t0_3, za = z3t t4, zb = t0_3 t3)
// (static: each source that includes this header keeps its own copy)
constexpr int8_t M0 = 16;  // the code of middle value 0
static __constant__ int8_t kPtA[2][6] = {{1, 1, 2, 0}, {0, 1, 2, 3, 4, 5}};
static __constant__ int8_t kPtB[2][6] = {{1, 2, 2, 1}, {0, 1, 2, 3, 4, 5}};
static __constant__ int8_t kMidA[2][6] = {{M0 + 0, M0 + 2, M0 + 0, 2},
                                          {M0 + 0, M0 + 2, M0 + 10, M0 + 4, M0 + 8, M0 + 6}};
static __constant__ int8_t kMidB[2][6] = {{6, M0 + 4, M0 + 6, M0 + 4},
                                          {M0 + 10, M0 + 4, M0 + 8, M0 + 6, M0 + 2, M0 + 0}};

// the slot of a second-layer operand's code in layout S
template <class S>
__device__ __forceinline__ int mid_slot(int code) {
  return code < M0 ? S::kF + code : S::kM + code - M0;
}

// field product x (Fp2 product x / 3, piece x % 3) of layer `lay` of the
// doubling (h = 0: operands from the point in slots A) or the add (h = 1:
// D in slots A and Q), into slot K + x
template <int NW, int LB, class S>
__device__ __forceinline__ void product(uint32_t* sm, int h, int lay, int x, int A, int t,
                                        const FieldConsts& k) {
  const int e = x / 3, p = x - 3 * e;
  uint32_t a[NW], b[NW];
  if (lay == 0) {
    const int xa = kPtA[h][e], xb = kPtB[h][e], B = h == 0 ? A : S::kQ;
    piece<NW>(a, p, [&](uint32_t* r, int j) { pt_get<NW, LB>(r, sm, A, xa, j, t, k); }, k);
    piece<NW>(b, p, [&](uint32_t* r, int j) { pt_get<NW, LB>(r, sm, B, xb, j, t, k); }, k);
  } else {
    const int sa = mid_slot<S>(kMidA[h][e]), sb = mid_slot<S>(kMidB[h][e]);
    piece<NW>(a, p, [&](uint32_t* r, int j) { sget<NW, LB>(r, sm, sa + j, t); }, k);
    piece<NW>(b, p, [&](uint32_t* r, int j) { sget<NW, LB>(r, sm, sb + j, t); }, k);
  }
  fp_mul<NW>(a, a, b, k);
  sput<NW, LB>(sm, S::kK + x, a, t);
}

// component j of the doubling's middle value m from the first layer's Fp2
// products in F (t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y): 0 t0m = t0 -
// ((t2 + t2) + t2), 1 t2 = b3 zz, 2 z3t = 8 t0, 3 y3t = t0 + t2
template <int NW, int LB, class S>
__device__ __forceinline__ void dbl_mid(uint32_t* r, const uint32_t* sm, int m, int j, int t,
                                        const FieldConsts& k, B3 b3) {
  uint32_t t0[NW];
  sget<NW, LB>(t0, sm, S::kF + j, t);
  if (m == 2) {
    fp_mul_small<NW>(r, t0, 8, k);
    return;
  }
  b3_prod2<NW, LB, S>(r, sm, j, t, b3, k);  // t2
  if (m == 3) {
    fp_add<NW>(r, t0, r, k);
  } else if (m == 0) {
    uint32_t u[NW];
    fp_add<NW>(u, r, r, k);
    fp_add<NW>(u, u, r, k);
    fp_sub<NW>(r, t0, u, k);
  }
}

// component j of the add's middle value m from the first layer's Fp2
// products in F (t0, t1, t2, s3, s4, s5): 0 t3 = s3 - (t0 + t1),
// 1 t4 = s4 - (t1 + t2), 2 lnb = b3 (s5 - (t0 + t2)), 3 t0_3 = (t0 + t0) +
// t0, 4 z3t = t1 + b3 t2, 5 t1m = t1 - b3 t2
template <int NW, int LB, class S>
__device__ __forceinline__ void add_mid(uint32_t* r, const uint32_t* sm, int m, int j, int t,
                                        const FieldConsts& k, B3 b3) {
  uint32_t u[NW], v[NW];
  if (m < 2) {  // s - (ta + tb)
    sget<NW, LB>(u, sm, S::kF + 2 * m + j, t);
    sget<NW, LB>(v, sm, S::kF + 2 * (m + 1) + j, t);
    fp_add<NW>(u, u, v, k);
    sget<NW, LB>(v, sm, S::kF + 2 * (m + 3) + j, t);
    fp_sub<NW>(r, v, u, k);
  } else if (m == 2) {  // ln = s5 - (t0 + t2), both components, then b3
    uint32_t w[NW];
    sget<NW, LB>(u, sm, S::kF + 0, t);
    sget<NW, LB>(v, sm, S::kF + 4, t);
    fp_add<NW>(u, u, v, k);
    sget<NW, LB>(v, sm, S::kF + 10, t);
    fp_sub<NW>(w, v, u, k);
    sget<NW, LB>(u, sm, S::kF + 1, t);
    sget<NW, LB>(v, sm, S::kF + 5, t);
    fp_add<NW>(u, u, v, k);
    sget<NW, LB>(v, sm, S::kF + 11, t);
    fp_sub<NW>(v, v, u, k);
    b3_comp<NW>(r, w, v, j, b3, k);
  } else if (m == 3) {
    sget<NW, LB>(v, sm, S::kF + j, t);
    fp_add<NW>(u, v, v, k);
    fp_add<NW>(r, u, v, k);
  } else {
    b3_prod2<NW, LB, S>(v, sm, j, t, b3, k);  // t2b
    sget<NW, LB>(u, sm, S::kF + 2 + j, t);    // t1
    if (m == 4) {
      fp_add<NW>(r, u, v, k);
    } else {
      fp_sub<NW>(r, u, v, k);
    }
  }
}

// component j of coordinate c of the doubling's result (h = 0: X3 = dxa +
// dxa, Y3 = dya + dyb, Z3 = dz) or the add's (h = 1: X3 = xa - xb,
// Y3 = ya + yb, Z3 = za + zb) from the second layer's products
template <int NW, int LB, class S>
__device__ __forceinline__ void point_out(uint32_t* r, const uint32_t* sm, int h, int c, int j,
                                          int t, const FieldConsts& k) {
  uint32_t u[NW];
  if (h == 0) {
    if (c == 2) {
      kara<NW, LB, S>(r, sm, 3, j, t, k);
    } else if (c == 0) {
      kara<NW, LB, S>(u, sm, 0, j, t, k);
      fp_add<NW>(r, u, u, k);
    } else {
      kara<NW, LB, S>(r, sm, 1, j, t, k);
      kara<NW, LB, S>(u, sm, 2, j, t, k);
      fp_add<NW>(r, r, u, k);
    }
    return;
  }
  kara<NW, LB, S>(r, sm, 2 * c, j, t, k);
  kara<NW, LB, S>(u, sm, 2 * c + 1, j, t, k);
  if (c == 0) {
    fp_sub<NW>(r, r, u, k);
  } else {
    fp_add<NW>(r, r, u, k);
  }
}

// one half of a ladder bit (this header's comment, steps 1-5) on layout S: the
// doubling (h = 0) of the point in slots A, or the add (h = 1) of the
// points in slots A and S::kQ, with a barrier after each of steps 1-4;
// step 5 is out(), on every thread (point_out gives a worker its
// component of the result)
template <int NW, int LB, class S, class Out>
__device__ __forceinline__ void half_bit(uint32_t* sm, int h, int A, int w, int t,
                                         const FieldConsts& k, B3 b3, const Out& out) {
  const int nx = h == 0 ? 12 : 18;  // field products of a layer
  const int nf = h == 0 ? 8 : 12;   // components of the first layer's Fp2 products
  if (w < nx) product<NW, LB, S>(sm, h, 0, w, A, t, k);
  __syncthreads();
  if (w < nf) {
    uint32_t r[NW];
    kara<NW, LB, S>(r, sm, w >> 1, w & 1, t, k);
    sput<NW, LB>(sm, S::kF + w, r, t);
  }
  __syncthreads();
  if (w < nf) {
    uint32_t r[NW];
    if (h == 0) {
      dbl_mid<NW, LB, S>(r, sm, w >> 1, w & 1, t, k, b3);
    } else {
      add_mid<NW, LB, S>(r, sm, w >> 1, w & 1, t, k, b3);
    }
    sput<NW, LB>(sm, S::kM + w, r, t);
  }
  __syncthreads();
  if (w < nx) product<NW, LB, S>(sm, h, 1, w, 0, t, k);
  __syncthreads();
  out();
}

// lanes a block: 16 while the 16-lane blocks fit on the card's SMs in one
// wave (n <= 16 SMs, 2,112 lanes on an H100), else 32: the ladders and the
// one-step kernels are latency-bound, so below that more, smaller blocks
// finish sooner (on an H100 the add took 0.0158 ms at 2,112 lanes in
// 16-lane blocks and 0.0192 in 32-lane ones, at 4,096 lanes 0.0214 and
// 0.0196)
inline cudaError_t ladder_lanes(int n, int* lanes) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *lanes = n <= 16 * sms ? 16 : 32;
  return err;
}

constexpr int kMaxDevices = 64;

// raise kern's dynamic shared memory cap to bytes where this device's is
// lower (raised: the cap set so far on each device, one array a kernel), so
// that a launcher pays cudaFuncSetAttribute once per kernel and device
template <class Kern>
cudaError_t smem_cap(Kern kern, size_t bytes, int* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = (int)bytes;
  return err;
}

// one launch of kern on ceil(n / LB) blocks of `workers` workers of LB
// threads, with `slots` slots and `extra` more words a lane of dynamic shared
// memory (kern's cap raised first where needed: `raised` is kern's array of
// smem_cap); returns the launch's CUDA error
template <int NW, int LB, class Kern, class... Args>
int launch_blocks(Kern kern, int* raised, int workers, int slots, int extra, int n,
                  cudaStream_t stream, Args... args) {
  const size_t bytes = (size_t)(slots * NW + extra) * LB * sizeof(uint32_t);
  const cudaError_t err = smem_cap(kern, bytes, raised);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + LB - 1) / LB, workers * LB, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// the word count of the G2 launchers of a source: 12 (L = 24, BLS12-381),
// or 9 (L = 18, FP256BN) in its NW = 9 twin, where this header's
// namespace is mlt_nw9 (words.cuh).  BN254 and
// BLS12-377 run the weier route, not these kernels, so there is no NW = 8.
#ifdef MLT_NW9
constexpr int kG2Words = 9;
#else
constexpr int kG2Words = 12;
#endif

// the launchers' common head: -1 for an L other than this source's
// 2 kG2Words, nothing to do for n = 0, else launch(nw, lb) with nw and lb
// std::integral_constants of the words an element and of the block's lanes
// by ladder_lanes (or the CUDA error of reading the SM count).  Each
// instantiation of a launcher's lambda keeps its own static cap array.
template <class Launch>
int by_block_lanes(int n, int L, const Launch& launch) {
  if (L != 2 * kG2Words) return -1;
  if (n == 0) return 0;
  int lanes = 0;
  const cudaError_t err = ladder_lanes(n, &lanes);
  if (err != cudaSuccess) return (int)err;
  constexpr std::integral_constant<int, kG2Words> nw{};
  if (lanes == 16) return launch(nw, std::integral_constant<int, 16>{});
  return launch(nw, std::integral_constant<int, 32>{});
}

}  // namespace mlt
