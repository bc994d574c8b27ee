// G2 point kernels for Hopper (sm_90a) on one body, the G2 ladder's steps,
// whose base-field products are spread over the warps of a block: port of
// mathlib_tpu/ops/kernels/g2_pallas.py's fused chain kernels and of its add,
// doubling and ladder step.
//
//   g2_ladder_kernel<.., STATIC = false> <- g2_pallas.py:_g2_smul_kernel
//                                          (g2_smul_pallas)
//   g2_ladder_kernel<.., STATIC = true>  <- g2_pallas.py:_g2_smul_static_kernel
//                                          (g2_smul_static_pallas)
//   g2_add_kernel                        <- g2_pallas.py:_add_kernel (add_pallas)
//   g2_double_kernel                     <- g2_pallas.py:_double_kernel
//                                          (double_pallas)
//   g2_dblsel_kernel                     <- g2_pallas.py:_dblsel_kernel
//                                          (dblsel_pallas)
//
// out = [k]Q on (3, 2, L, n) points (g2_rows.cuh has the layout), MSB first
// from infinity: per-lane scalars (G2Ctx.scalar_mul: each bit a doubling
// D = 2 acc, an add A = D + Q and acc = bit ? A : D), or one MSB-first bit
// array shared by every lane (HashG2Ctx's cofactor ladders: a doubling at
// every bit, the add only at one-bits, no select; the bits are a small
// device array, so one build serves every scalar).  out = P + Q and
// out = 2P are one half of a ladder bit each, in one launch, and
// out = sel ? 2P + Q : 2P is one whole bit with acc read from P.
//
// What bounds them on an H100 is the integer multiply rate: a bit of the
// per-lane ladder is 20 Fp2 products, 60 field products (35,280 32-bit
// multiply-adds at NW = 12) for a lane whose points stay on chip.  The
// one-thread design it replaced waited for 60 dependent products a bit in
// one thread (145 registers, a 2,376-byte stack).  Here a bit's products
// fall into four layers of independent ones, each Fp2 product split by
// Row2Ctx's Karatsuba (a0 b0, a1 b1, (a0 + a1)(b0 + b1)) into three field
// products: the doubling (RCB Alg 9 over Fp2, _rcb_double's order) is two
// layers of 12, the add (RCB Alg 7, rcb_add2's order) two layers of 18.
// A block owns LB lanes (16 or 32) and has a worker of LB threads for each
// field product of a layer (18; the doubling's kernel 12); thread t of
// every worker works on lane blockIdx.x * LB + t, so each load and store of
// a limb is a run of consecutive words.  Each half of a bit, the doubling
// D = 2 acc and the add A = D + Q, is five steps with a barrier after each
// (half_bit):
//
//   1. the first layer: worker x makes field product x (Fp2 product x / 3,
//      piece x % 3): Y Y, Y Z, Z Z, X Y of acc (12 workers), or t0, t1, t2,
//      s3, s4, s5 of D and Q (18);
//   2. worker v forms component v % 2 of the first layer's Fp2 product v / 2
//      from its pieces (c0 = t0 - t1, c1 = t2 - (t0 + t1));
//   3. worker v forms component v % 2 of middle value v / 2: t0m, t2, z3t,
//      y3t, or t3, t4, lnb, t0_3, z3t, t1m (b3 by f2_mul_b3's branches);
//   4. the second layer: dxa, dya, dyb, dz, or xa, xb, ya, yb, za, zb;
//   5. one Fp component a worker of D = (dxa + dxa, dya + dyb, dz), into
//      the point buffer acc does not use, or of acc = bit ? (xa - xb,
//      ya + yb, za + zb) : D, lane by lane, into acc's.  A block none of
//      whose lanes has the bit takes D as acc after the doubling (the select
//      would throw A away).  The add and doubling kernels stage P (and Q)
//      into the slots, run steps 1-5 once and store the result: every lane
//      takes it, so there is no select and no barrier after step 5.  The
//      dblsel kernel stages P and Q into the ladder's slots and runs one
//      bit (both halves, h a runtime value), its add's step 5 storing
//      sel ? A : D straight out.
//      half_bit runs steps 1-4 and leaves step 5 to its caller, each half
//      with its own store (with one store shared by both halves of the
//      ladder, its cofactor ladders ran 1-2 % slower on an H100).
//
// Q, acc, D, the products and the middle values stay in shared memory for
// all nbits steps (60 slots of NW x LB words: 90 KB at NW = 12 and 32
// lanes, dynamic, above the 48 KB static limit; the per-lane scalar limbs
// after them; dblsel takes the ladder's 60 without the limbs, the add 54,
// the doubling 34), and a thread holds two operands and one product at a
// time: no stack, no spill at 18 warps, whose five warps on one scheduler
// leave 96 registers a thread, the cap the add, doubling and dblsel kernels
// set (ptxas' report is on chip_smoke.py's build lines).  Ten barriers a bit, five where no lane of the block has
// it.  Each field product gets the reference's operands; the adds and subs
// in between may run in any order, since each returns the unique value in
// [0, 2p) of its residue mod 2p, so the limbs that come out are the
// one-thread formulas' and the reference kernel's.
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return the CUDA error of reading the card's SM count,
// of raising the kernel's dynamic shared memory cap (once per kernel and
// device) or of the launch (or -1 for an L other than 24, or for more bits
// than the scalar limbs hold).
#include <cuda_runtime.h>

#include <cstdint>

#include "g2_rows.cuh"

namespace mlt {

constexpr int kLadderWorkers = 18;  // one a field product of the add's layers
constexpr int kDblWorkers = 12;     // one a field product of the doubling's
constexpr int kStepRegs = 96;       // the add, doubling and dblsel kernels' register cap

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
// the add: P, Q, K 18, F 12, M 12
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

// component j of Fp2 product e from its Karatsuba pieces (f2_mul with
// tc.n == 1): c0 = t0 - t1, c1 = t2 - (t0 + t1)
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

// component j of b3 (a0 + a1 u) by the branch of f2_mul_b3 (g2_rows.cuh)
// that b3 takes
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
constexpr int8_t M0 = 16;  // the code of middle value 0
__constant__ int8_t kPtA[2][6] = {{1, 1, 2, 0}, {0, 1, 2, 3, 4, 5}};
__constant__ int8_t kPtB[2][6] = {{1, 2, 2, 1}, {0, 1, 2, 3, 4, 5}};
__constant__ int8_t kMidA[2][6] = {{M0 + 0, M0 + 2, M0 + 0, 2},
                                   {M0 + 0, M0 + 2, M0 + 10, M0 + 4, M0 + 8, M0 + 6}};
__constant__ int8_t kMidB[2][6] = {{6, M0 + 4, M0 + 6, M0 + 4},
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

// one half of a ladder bit (module comment, steps 1-5) on layout S: the
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

// out = [k]Q for the LB lanes of this block (module comment): per-lane
// scalars in (S, n) plain 16-bit limbs (STATIC false), or the MSB-first
// bits shared by every lane (STATIC true).
template <int NW, int LB, bool STATIC>
__global__ void __launch_bounds__(kLadderWorkers * LB, 32 / LB)
    g2_ladder_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                     const uint8_t* __restrict__ bits, int nbits, uint32_t* __restrict__ out,
                     int n, FieldConsts k, B3 b3) {
  using S = LadderSlots;
  extern __shared__ uint32_t sm[];
  uint32_t* limbs = sm + S::kN * NW * LB;  // [limb][lane]
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (!STATIC) {
    for (int l = w; l < (nbits + 15) / 16; l += kLadderWorkers) {
      limbs[l * LB + t] = live ? s[(int64_t)l * n + i] : 0u;
    }
  }
  if (w < 6) {  // Q's component w; acc = infinity ((0, 0) : (R mod p, 0) : (0, 0))
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, Q, w, n, i);
    sput<NW, LB>(sm, S::kQ + w, v, t);
#pragma unroll
    for (int j = 0; j < NW; ++j) v[j] = w == 2 ? k.one[j] : 0u;
    sput<NW, LB>(sm, S::kPt + w, v, t);
  }
  __syncthreads();
  int cur = 0;  // acc is point buffer cur; D goes to the other
  for (int step = 0; step < nbits; ++step) {
    const int A = S::kPt + 6 * cur, D = S::kPt + 6 * (cur ^ 1);
    bool bit = false;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // the doubling D = 2 acc, then the add A = D + Q
      if (h == 1 && !__syncthreads_or(bit)) {  // no lane of the block adds: acc = D
        cur ^= 1;
        break;
      }
      half_bit<NW, LB, S>(sm, h, h == 0 ? A : D, w, t, k, b3, [&] {
        if (h == 0) {  // D, and this lane's bit
          if (w < 6) {
            uint32_t r[NW];
            point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
            sput<NW, LB>(sm, D + w, r, t);
          }
          if (STATIC) {
            bit = bits[step] != 0;
          } else {
            const int b = nbits - 1 - step;
            bit = (limbs[(b >> 4) * LB + t] >> (b & 15)) & 1u;
          }
        } else {
          if (w < 6) {  // acc = bit ? A : D, into acc's buffer (last read by the doubling)
            uint32_t r[NW];
            if (bit) {
              point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
            } else {
              sget<NW, LB>(r, sm, D + w, t);
            }
            sput<NW, LB>(sm, A + w, r, t);
          }
          __syncthreads();
        }
      });
    }
  }
  if (w < 6 && live) {
    uint32_t v[NW];
    sget<NW, LB>(v, sm, S::kPt + 6 * cur + w, t);
    store_fp<NW>(out, v, w, n, i);
  }
}

// out = P + Q (RCB Alg 7 over Fp2) for the LB lanes of this block: workers
// 0-5 stage P's components, 6-11 Q's, then the add's half of a ladder bit
// on 18 workers, each lane taking its result, stored straight out
template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_add_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                  uint32_t* __restrict__ out, int n, FieldConsts k, B3 b3) {
  using S = AddSlots;
  extern __shared__ uint32_t sm[];
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (w < 12) {
    const int c = w < 6 ? w : w - 6;
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, w < 6 ? P : Q, c, n, i);
    sput<NW, LB>(sm, (w < 6 ? S::kPt : S::kQ) + c, v, t);
  }
  __syncthreads();
  half_bit<NW, LB, S>(sm, 1, S::kPt, w, t, k, b3, [&] {
    if (w < 6 && live) {
      uint32_t r[NW];
      point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
      store_fp<NW>(out, r, w, n, i);
    }
  });
}

// out = 2P (RCB Alg 9 over Fp2) for the LB lanes of this block: workers 0-5
// stage P's components, then the doubling's half of a ladder bit on 12
// workers, stored straight out
template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_double_kernel(const uint32_t* __restrict__ P, uint32_t* __restrict__ out, int n,
                     FieldConsts k, B3 b3) {
  using S = DblSlots;
  extern __shared__ uint32_t sm[];
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (w < 6) {
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, P, w, n, i);
    sput<NW, LB>(sm, S::kPt + w, v, t);
  }
  __syncthreads();
  half_bit<NW, LB, S>(sm, 0, S::kPt, w, t, k, b3, [&] {
    if (w < 6 && live) {
      uint32_t r[NW];
      point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
      store_fp<NW>(out, r, w, n, i);
    }
  });
}

// out = sel ? 2P + Q : 2P (RCB Alg 9 then Alg 7 over Fp2: one bit of the
// ladder with acc read from P) for the LB lanes of this block, on the
// ladder's slots: workers 0-5 stage P's components into point buffer 0,
// 6-11 Q's, the doubling's half puts D into buffer 1, and, where a lane of
// the block has sel, the add's half D + Q stores sel ? A : D straight out,
// lane by lane; a block none of whose lanes has sel stores D.  h is a
// runtime value, as in the ladder: with the two halves inlined apart the
// kernel took 4 % longer at 4,096 lanes and 8 % at 2,112 on an H100
// (PERF.md section 6).
template <int NW, int LB>
__global__ void __maxnreg__(kStepRegs)
    g2_dblsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, B3 b3) {
  using S = LadderSlots;
  constexpr int D = S::kPt + 6;
  extern __shared__ uint32_t sm[];
  const int t = threadIdx.x % LB;
  const int w = threadIdx.x / LB;
  const int i = blockIdx.x * LB + t;
  const bool live = i < n;
  if (w < 12) {
    const int c = w < 6 ? w : w - 6;
    uint32_t v[NW] = {};
    if (live) load_fp<NW>(v, w < 6 ? P : Q, c, n, i);
    sput<NW, LB>(sm, (w < 6 ? S::kPt : S::kQ) + c, v, t);
  }
  __syncthreads();
  const bool adds = live && sel[i];
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // the doubling D = 2P, then the add A = D + Q
    if (h == 1 && !__syncthreads_or(adds)) {  // no lane of the block adds: out = D
      if (w < 6 && live) {
        uint32_t r[NW];
        sget<NW, LB>(r, sm, D + w, t);
        store_fp<NW>(out, r, w, n, i);
      }
      return;
    }
    half_bit<NW, LB, S>(sm, h, h == 0 ? S::kPt : D, w, t, k, b3, [&] {
      if (h == 0) {  // D into point buffer 1
        if (w < 6) {
          uint32_t r[NW];
          point_out<NW, LB, S>(r, sm, 0, w >> 1, w & 1, t, k);
          sput<NW, LB>(sm, D + w, r, t);
        }
      } else if (w < 6 && live) {  // sel ? A : D, straight out
        uint32_t r[NW];
        if (adds) {
          point_out<NW, LB, S>(r, sm, 1, w >> 1, w & 1, t, k);
        } else {
          sget<NW, LB>(r, sm, D + w, t);
        }
        store_fp<NW>(out, r, w, n, i);
      }
    });
  }
}

// lanes a block: 16 while the 16-lane blocks fit on the card's SMs in one
// wave (n <= 16 SMs, 2,112 lanes on an H100), else 32: the ladder and the
// add and doubling kernels are latency-bound, so below that more, smaller
// blocks finish sooner (on an H100 the add took 0.0158 ms at 2,112 lanes
// in 16-lane blocks and 0.0192 in 32-lane ones, at 4,096 lanes 0.0214 and
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

template <int NW, int LB, bool STATIC>
int launch_ladder(const uint32_t* Q, const uint32_t* s, const uint8_t* bits, int nbits,
                  uint32_t* out, int n, const FieldConsts& k, B3 b3, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const int limbs = STATIC ? 0 : (nbits + 15) / 16;
  const size_t bytes = (size_t)(LadderSlots::kN * NW + limbs) * LB * sizeof(uint32_t);
  auto kern = g2_ladder_kernel<NW, LB, STATIC>;
  const cudaError_t err = smem_cap(kern, bytes, raised);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + LB - 1) / LB, kLadderWorkers * LB, bytes, stream>>>(Q, s, bits, nbits, out, n, k,
                                                                 b3);
  return (int)cudaGetLastError();
}

template <bool STATIC>
int ladder(const uint32_t* Q, const uint32_t* s, const uint8_t* bits, int nbits, uint32_t* out,
           int n, int L, const uint32_t* consts, B3 b3, cudaStream_t stream) {
  if (L != 24) return -1;
  if (n == 0) return 0;
  constexpr int NW = 12;
  const FieldConsts k = make_consts(consts, NW);
  int lanes = 0;
  const cudaError_t err = ladder_lanes(n, &lanes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 16) {
    return launch_ladder<NW, 16, STATIC>(Q, s, bits, nbits, out, n, k, b3, stream);
  }
  return launch_ladder<NW, 32, STATIC>(Q, s, bits, nbits, out, n, k, b3, stream);
}

// one launch of the add (Q given) or the doubling (Q null) on LB-lane blocks
template <int NW, int LB>
int launch_step(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, const FieldConsts& k,
                B3 b3, cudaStream_t stream) {
  const int blocks = (n + LB - 1) / LB;
  if (Q != nullptr) {
    static int raised[kMaxDevices] = {};
    const size_t bytes = (size_t)AddSlots::kN * NW * LB * sizeof(uint32_t);
    auto kern = g2_add_kernel<NW, LB>;
    const cudaError_t err = smem_cap(kern, bytes, raised);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks, kLadderWorkers * LB, bytes, stream>>>(P, Q, out, n, k, b3);
  } else {
    static int raised[kMaxDevices] = {};
    const size_t bytes = (size_t)DblSlots::kN * NW * LB * sizeof(uint32_t);
    auto kern = g2_double_kernel<NW, LB>;
    const cudaError_t err = smem_cap(kern, bytes, raised);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks, kDblWorkers * LB, bytes, stream>>>(P, out, n, k, b3);
  }
  return (int)cudaGetLastError();
}

template <int NW, int LB>
int launch_dblsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out, int n,
                  const FieldConsts& k, B3 b3, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const size_t bytes = (size_t)LadderSlots::kN * NW * LB * sizeof(uint32_t);
  auto kern = g2_dblsel_kernel<NW, LB>;
  const cudaError_t err = smem_cap(kern, bytes, raised);
  if (err != cudaSuccess) return (int)err;
  kern<<<(n + LB - 1) / LB, kLadderWorkers * LB, bytes, stream>>>(P, Q, sel, out, n, k, b3);
  return (int)cudaGetLastError();
}

int dblsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out, int n, int L,
           const uint32_t* consts, B3 b3, cudaStream_t stream) {
  if (L != 24) return -1;
  if (n == 0) return 0;
  constexpr int NW = 12;
  const FieldConsts k = make_consts(consts, NW);
  int lanes = 0;
  const cudaError_t err = ladder_lanes(n, &lanes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 16) return launch_dblsel<NW, 16>(P, Q, sel, out, n, k, b3, stream);
  return launch_dblsel<NW, 32>(P, Q, sel, out, n, k, b3, stream);
}

int point_step(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, int L,
               const uint32_t* consts, B3 b3, cudaStream_t stream) {
  if (L != 24) return -1;
  if (n == 0) return 0;
  constexpr int NW = 12;
  const FieldConsts k = make_consts(consts, NW);
  int lanes = 0;
  const cudaError_t err = ladder_lanes(n, &lanes);
  if (err != cudaSuccess) return (int)err;
  if (lanes == 16) return launch_step<NW, 16>(P, Q, out, n, k, b3, stream);
  return launch_step<NW, 32>(P, Q, out, n, k, b3, stream);
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_g2_smul(const uint32_t* Q, const uint32_t* s, int S, int nbits, uint32_t* out,
                           int n, int L, const uint32_t* consts, int b3c0, int b3c1,
                           cudaStream_t stream) {
  if (nbits < 0 || nbits > 16 * S) return -1;
  return ladder<false>(Q, s, nullptr, nbits, out, n, L, consts, B3{b3c0, b3c1}, stream);
}

extern "C" int mlt_g2_smul_static(const uint32_t* Q, const uint8_t* bits, int nbits,
                                  uint32_t* out, int n, int L, const uint32_t* consts, int b3c0,
                                  int b3c1, cudaStream_t stream) {
  return ladder<true>(Q, nullptr, bits, nbits, out, n, L, consts, B3{b3c0, b3c1}, stream);
}

extern "C" int mlt_g2_add(const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, int L,
                          const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  return point_step(P, Q, out, n, L, consts, B3{b3c0, b3c1}, stream);
}

extern "C" int mlt_g2_double(const uint32_t* P, uint32_t* out, int n, int L,
                             const uint32_t* consts, int b3c0, int b3c1, cudaStream_t stream) {
  return point_step(P, nullptr, out, n, L, consts, B3{b3c0, b3c1}, stream);
}

extern "C" int mlt_g2_dblsel(const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
                             uint32_t* out, int n, int L, const uint32_t* consts, int b3c0,
                             int b3c1, cudaStream_t stream) {
  return dblsel(P, Q, sel, out, n, L, consts, B3{b3c0, b3c1}, stream);
}
