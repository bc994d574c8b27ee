// Hash-to-G1 kernel for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/hash_pallas.py.
//
//   hash_g1_kernel  <- hash_pallas.py:_hash_g1_kernel (hash_g1_pallas)
//
// Per lane, as _hash_g1_kernel per tile: for each of u0 and u1 the
// simplified SWU map onto the 11-isogenous curve E' (RFC 9380 6.6.2; the
// exceptional t2 = 0 case selects B/(ZA)), the sign fix (RFC sgn0 parity,
// or the BBS big-endian sign of kilic custom.go:99-105), the isogeny to E
// evaluated projectively by Horner (no inversion: X = xn*yd, Y = y*yn*xd,
// Z = xd*yd), then one RCB add of the two points and the [h_eff] ladder (a
// double at every bit after the first, the add at one-bits, negated when
// h_eff < 0).
//
// Every step is the reference body's operation for operation, in 32-bit
// words (fp_rows.cuh: REDC's output does not depend on the digit size), so
// the output limbs are the body's bit for bit:
//   * inversion and square roots by the body's 4-bit fixed-window chain
//     (_pow_ref): a 16-entry table base^0..base^15 (base^0 = R mod p), the
//     leading nbits % 4 bits selected from it, then per window 4 squarings
//     and ONE unconditional product with the selected entry;
//   * the sign from the canonical integer: from_mont (a product with the
//     literal 1) and a conditional subtraction of p; the negation is the
//     relaxed sub(0, y);
//   * the RCB add and double in the order of the reference's row formulas
//     (g1_pallas.py _rcb_add_rows and _rcb_dbl_rows), their products in the
//     layers of add_layer1/2 and dbl_layer1/2 (g1_split_kernels.cu).
// Only the order of independent products changes, and each product's
// operands are the body's; fp_add, fp_sub and fp_mul_small return the one
// value in [0, 2p) of their residue, so their grouping is free.
//
// Design.  A lane runs on four groups of two threads; a product is
// fp_mul_group (fp_group.cuh): each thread of a group holds six of an
// element's twelve words.  Group w of all 16 lanes of a block is warp w
// (128 threads a block, 256 blocks at 4,096 lanes, 2 blocks an SM at 62 KB
// of shared memory each), so each warp runs one code path and its shuffles
// never diverge.  Two threads a product, not four: at 4,096 lanes the
// square roots keep every warp busy and the card issues the products'
// instructions as fast as it can, and a product over two threads costs
// ~0.6x the instructions of one over four (a longer carry chain per thread,
// but half the shuffles and m products); 1.69-1.72 ms against 2.25 ms at
// 4,096 lanes, the same 1.14-1.16 ms at 1,024 (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 6).  The lane's values and its four window
// tables (16 entries each) sit in shared memory as [word][lane] slots; a
// thread reads and writes its own words of them, and a linear step (add,
// sub, the b3 chains, the sign, the compares) is done on the whole element
// by each thread of the group, read from a slot (the group's own scratch
// slot for a product it has just made).  Phases,
// a block barrier after each:
//   A. the two maps' heads, u0 on group 0 and u1 on group 1: Z u^2, t2,
//      the inversion chain (489 products), x1, g(x1), x2, g(x2); groups 2
//      and 3 take the signs of u0 and u1;
//   B. the four square roots, g(x1) and g(x2) of each map, one a group
//      (484 products), with each candidate's sign and map's y1^2 = g(x1)
//      test;
//   C. the eight Horner polynomials of the two isogenies, two a group
//      (yn and xd, or yd and xn, of one map: 25 or 26 products), x chosen
//      by the test;
//   D. y chosen and sign-fixed, yn xd and Y on groups 0 and 1, X and Z on
//      2 and 3; the RCB add of the two points (each layer's six products
//      over the four groups: two on groups 0 and 1); then per bit of
//      |h_eff| the doubling's two layers (a product a group) and, at a
//      one-bit, the add's two layers with the sum P; the accumulator is
//      read from the last layer's slots (acc = D or A).
// A lane's critical path is ~1,150 dependent products instead of 3,638,
// and a thread holds a few slices and at most three whole elements: no
// stack, no spill (ptxas' report is on chip_smoke.py's build lines).
//
// Inputs: u0, u1 (L, n) Montgomery limbs; the curve's constants as a small
// device array of 32-bit words (four polynomial lengths, then Z, A, B, -B/A,
// B/(ZA) and the isogeny coefficients low-degree-first, NW words each); the
// bits of p - 2, (p + 1)/4 and |h_eff| as device arrays; the sign mode and
// h_eff < 0 as arguments.  One build serves every curve that passes the gate
// (p = 3 mod 4 with G1 isogeny data: BLS12-381 today), so only NW = 12 is
// instantiated.  Bound on this card: operations (a BLS12-381 lane is ~3,640
// field products for 192 bytes in and 144 out).
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "fp_group.cuh"
#include "g1_rows.cuh"

namespace mlt {

constexpr int kHashG = 2;                              // threads a product
constexpr int kHashLanes = 32 / kHashG;                // lanes a block: a warp a group
constexpr int kHashThreads = 4 * kHashG * kHashLanes;  // four groups (warps) a lane
constexpr int kHashMinBlocks = 4;                      // caps the registers at 128

// one slot: NW words for each of the block's lanes
template <int NW>
using HSlot = uint32_t[NW][kHashLanes];

template <int NW>
struct HashSlots {
  union {
    HSlot<NW> tab[4][16];  // phases A and B: a window table a group
    struct {
      HSlot<NW> ev[2][4];  // each map's xn, xd, yn, yd
      HSlot<NW> pt[2][3];  // the two mapped points
      HSlot<NW> f[6];      // an add's first layer: t0, t1, t2, s3, s4, s5
      HSlot<NW> s[6];      // its second layer: xa, xb, ya, yb, za, zb
      HSlot<NW> df[4];     // a doubling's first layer: t0, t1, zz, xy
      HSlot<NW> d[4];      // its second layer: dxa, dya, dz, dyb
      HSlot<NW> sum[3];    // P = the two points' sum, the ladder's base
    } late;
  };
  HSlot<NW> x1[2], x2[2], gx1[2], gx2[2], y[2][2];
  HSlot<NW> scratch[4];  // a group's own, for its gathers
  uint32_t su[2][kHashLanes], sy[2][2][kHashLanes], sq[2][kHashLanes];
};

// The device constant array: four polynomial lengths, then these field
// constants, then the isogeny coefficients.
enum HashConst { kZ = 0, kA, kB, kNegBOverA, kBOverZA, kNumConsts };

template <int NW>
__device__ __forceinline__ const uint32_t* hash_const(const uint32_t* hc, int idx) {
  return hc + 4 + idx * NW;
}

struct HashBits {
  const uint8_t* inv;
  int ninv;
  const uint8_t* sqrt;
  int nsqrt;
};

// the sign bit of a canonical integer s: RFC sgn0 (parity), or the BBS
// big-endian sign s <= p - s (_le_neg; s = 0 is positive, since then
// p - s = p); the highest word where s and p - s differ decides
template <int NW>
__device__ __forceinline__ uint32_t canon_sign(const uint32_t* s, int sign_be,
                                               const FieldConsts& k) {
  if (!sign_be) return s[0] & 1u;
  uint32_t neg[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)k.p[j] - s[j] - borrow;
    neg[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t r = 1;
#pragma unroll
  for (int j = 0; j < NW; ++j) r = s[j] != neg[j] ? (uint32_t)(s[j] < neg[j]) : r;
  return r;
}

// One thread of a group: lane t of the block, words [g K, g K + K) of every
// element (its slice).  Every member is called by the whole warp.
template <int NW>
struct HashGroup {
  static constexpr int K = NW / kHashG;
  int t, g;
  uint32_t p[K];
  uint32_t np0;
  HSlot<NW>* scratch;

  __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) const {
    fp_mul_group<NW, kHashG>(r, a, b, p, np0, g);
  }
  // this thread's words of a slot, and back
  __device__ __forceinline__ void get(uint32_t* v, const HSlot<NW>& s) const {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = s[g * K + j][t];
  }
  __device__ __forceinline__ void put(HSlot<NW>& s, const uint32_t* v) const {
#pragma unroll
    for (int j = 0; j < K; ++j) s[g * K + j][t] = v[j];
  }
  // the whole element of a slot
  __device__ __forceinline__ void full(uint32_t* f, const HSlot<NW>& s) const {
#pragma unroll
    for (int j = 0; j < NW; ++j) f[j] = s[j][t];
  }
  // this thread's words of a whole element f (registers) or c (memory)
  __device__ __forceinline__ void slice(uint32_t* v, const uint32_t* f) const {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = group_word<NW, kHashG>(f, g, j);
  }
  __device__ __forceinline__ void cslice(uint32_t* v, const uint32_t* c) const {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = c[g * K + j];
  }
  // the whole element of the group's slices v, through its scratch slot
  __device__ __forceinline__ void gather(uint32_t* f, const uint32_t* v) const {
    __syncwarp();
    put(*scratch, v);
    __syncwarp();
    full(f, *scratch);
  }
  // sign bit of the Montgomery value whose slices are v
  __device__ __forceinline__ uint32_t sign(const uint32_t* v, int sign_be,
                                           const FieldConsts& k) const {
    uint32_t one[K], s[K], f[NW];
#pragma unroll
    for (int j = 0; j < K; ++j) one[j] = g == 0 && j == 0;
    mul(s, v, one);
    gather(f, s);
    fp_canon<NW>(f, f, k);
    return canon_sign<NW>(f, sign_be, k);
  }
  // r = a^e (slices), e's MSB-first bits in a device array, by the body's
  // 4-bit fixed window (_pow_ref), the table in the group's 16 slots (a
  // thread writes and reads only its own words of them)
  __device__ __forceinline__ void pow_win4(uint32_t* r, const uint32_t* a, const uint8_t* bits,
                                           int nbits, HSlot<NW>* tab,
                                           const FieldConsts& k) const {
    uint32_t e[K], acc[K];
    slice(e, k.one);
    put(tab[0], e);
    put(tab[1], a);
#pragma unroll
    for (int j = 0; j < K; ++j) e[j] = a[j];
#pragma unroll 1
    for (int i = 2; i < 16; ++i) {
      mul(e, e, a);
      put(tab[i], e);
    }
    const int head = nbits % 4;
    int d = 0;
    for (int i = 0; i < head; ++i) d = 2 * d + __ldg(bits + i);
    get(acc, tab[d]);  // head == 0: tab[0], the 1 of R mod p
#pragma unroll 1
    for (int i = head; i < nbits; i += 4) {
      d = __ldg(bits + i) * 8 + __ldg(bits + i + 1) * 4 + __ldg(bits + i + 2) * 2 +
          __ldg(bits + i + 3);
#pragma unroll 1
      for (int s = 0; s < 5; ++s) {  // four squarings, then the product with tab[d]
        if (s < 4) {
#pragma unroll
          for (int j = 0; j < K; ++j) e[j] = acc[j];
        } else {
          get(e, tab[d]);
        }
        mul(acc, acc, e);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = acc[j];
  }
};

// coordinate c (the whole element) of a point in slots: form 0 its X, Y, Z;
// form 1 a doubling's second layer dxa, dya, dz, dyb: (dxa + dxa,
// dya + dyb, dz); form 2 an add's second layer xa, xb, ya, yb, za, zb:
// (xa - xb, ya + yb, za + zb) (_rcb_dbl_rows' and _rcb_add_rows' last steps)
template <int NW>
struct HashPoint {
  const HSlot<NW>* s;
  int form;
  __device__ __forceinline__ void get(uint32_t* r, int c, const HashGroup<NW>& G,
                                      const FieldConsts& k) const {
    uint32_t u[NW];
    if (form == 0) {
      G.full(r, s[c]);
    } else if (form == 1) {
      G.full(r, s[c]);
      if (c == 0) {
        fp_add<NW>(r, r, r, k);
      } else if (c == 1) {
        G.full(u, s[3]);
        fp_add<NW>(r, r, u, k);
      }
    } else {
      G.full(r, s[2 * c]);
      G.full(u, s[2 * c + 1]);
      if (c == 0) {
        fp_sub<NW>(r, r, u, k);
      } else {
        fp_add<NW>(r, r, u, k);
      }
    }
  }
};

// r = product e of the add's first layer (add_layer1): t0 = X1 X2,
// t1 = Y1 Y2, t2 = Z1 Z2, s3 = (X1 + Y1)(X2 + Y2), s4 = (Y1 + Z1)(Y2 + Z2),
// s5 = (X1 + Z1)(X2 + Z2)
template <int NW>
__device__ __forceinline__ void hash_add_l1(uint32_t* r, int e, const HashPoint<NW>& P1,
                                            const HashPoint<NW>& P2, const HashGroup<NW>& G,
                                            const FieldConsts& k) {
  constexpr int K = NW / kHashG;
  uint32_t A[NW], B[NW], a[K], b[K];
  if (e < 3) {
    P1.get(A, e, G, k);
    P2.get(B, e, G, k);
  } else {
    const int c0 = e == 4 ? 1 : 0, c1 = e == 3 ? 1 : 2;
    uint32_t u[NW];
    P1.get(A, c0, G, k);
    P1.get(u, c1, G, k);
    fp_add<NW>(A, A, u, k);
    P2.get(B, c0, G, k);
    P2.get(u, c1, G, k);
    fp_add<NW>(B, B, u, k);
  }
  G.slice(a, A);
  G.slice(b, B);
  G.mul(r, a, b);
}

// the middle values of RCB Alg 7, each by _rcb_add_rows' operations in its order
// from the first layer's slots f: t0, t1, t2, s3, s4, s5
enum HashMid { kT3, kT4, kLnb, kT0x3, kZ3t, kT1m };

template <int NW>
__device__ __forceinline__ void hash_add_mid(uint32_t* r, int id, const HSlot<NW>* f,
                                             const HashGroup<NW>& G, const FieldConsts& k,
                                             int b3) {
  uint32_t u[NW], v[NW];
  switch (id) {
    case kT3:  // s3 - (t0 + t1)
      G.full(u, f[0]);
      G.full(v, f[1]);
      fp_add<NW>(u, u, v, k);
      G.full(v, f[3]);
      fp_sub<NW>(r, v, u, k);
      break;
    case kT4:  // s4 - (t1 + t2)
      G.full(u, f[1]);
      G.full(v, f[2]);
      fp_add<NW>(u, u, v, k);
      G.full(v, f[4]);
      fp_sub<NW>(r, v, u, k);
      break;
    case kLnb:  // b3 (s5 - (t0 + t2))
      G.full(u, f[0]);
      G.full(v, f[2]);
      fp_add<NW>(u, u, v, k);
      G.full(v, f[5]);
      fp_sub<NW>(u, v, u, k);
      fp_mul_small<NW>(r, u, b3, k);
      break;
    case kT0x3:  // (t0 + t0) + t0
      G.full(v, f[0]);
      fp_add<NW>(u, v, v, k);
      fp_add<NW>(r, u, v, k);
      break;
    default:  // kZ3t: t1 + b3 t2; kT1m: t1 - b3 t2
      G.full(u, f[2]);
      fp_mul_small<NW>(u, u, b3, k);
      G.full(v, f[1]);
      if (id == kZ3t) {
        fp_add<NW>(r, v, u, k);
      } else {
        fp_sub<NW>(r, v, u, k);
      }
  }
}

// r = product e of the add's second layer: xa = t3 t1m, xb = t4 lnb,
// ya = t1m z3t, yb = lnb t0_3, za = z3t t4, zb = t0_3 t3 (3 bits an id)
constexpr uint32_t kHashMidA = kT3 | kT4 << 3 | kT1m << 6 | kLnb << 9 | kZ3t << 12 | kT0x3 << 15;
constexpr uint32_t kHashMidB = kT1m | kLnb << 3 | kZ3t << 6 | kT0x3 << 9 | kT4 << 12 | kT3 << 15;

template <int NW>
__device__ __forceinline__ void hash_add_l2(uint32_t* r, int e, const HSlot<NW>* f,
                                            const HashGroup<NW>& G, const FieldConsts& k,
                                            int b3) {
  constexpr int K = NW / kHashG;
  uint32_t A[NW], a[K], b[K];
  hash_add_mid<NW>(A, (kHashMidA >> (3 * e)) & 7, f, G, k, b3);
  G.slice(a, A);
  hash_add_mid<NW>(A, (kHashMidB >> (3 * e)) & 7, f, G, k, b3);
  G.slice(b, A);
  G.mul(r, a, b);
}

// r = product w of the doubling's first layer (dbl_layer1): t0 = Y Y,
// t1 = Y Z, zz = Z Z, xy = X Y
template <int NW>
__device__ __forceinline__ void hash_dbl_l1(uint32_t* r, int w, const HashPoint<NW>& P,
                                            const HashGroup<NW>& G, const FieldConsts& k) {
  constexpr int K = NW / kHashG;
  uint32_t A[NW], a[K], b[K];
  P.get(A, w == 2 ? 2 : w == 3 ? 0 : 1, G, k);
  G.slice(a, A);
  P.get(A, w == 0 || w == 3 ? 1 : 2, G, k);
  G.slice(b, A);
  G.mul(r, a, b);
}

// r = product w of the doubling's second layer (dbl_layer2): dxa = t0m xy,
// dya = t2 z3t, dyb = t0m y3t, dz = t1 z3t, each middle value by
// _rcb_dbl_rows' operations in its order (z3t = 8 t0, t2 = b3 zz, y3t = t0 + t2,
// t0m = t0 - ((t2 + t2) + t2)) from the first layer's slots df
template <int NW>
__device__ __forceinline__ void hash_dbl_l2(uint32_t* r, int w, const HSlot<NW>* df,
                                            const HashGroup<NW>& G, const FieldConsts& k,
                                            int b3) {
  constexpr int K = NW / kHashG;
  uint32_t t0[NW], u[NW], A[NW], a[K], b[K];
  G.full(t0, df[0]);
  if (w == 1 || w == 3) {
    fp_mul_small<NW>(A, t0, 8, k);  // z3t
    G.slice(b, A);
    if (w == 1) {
      G.full(u, df[2]);
      fp_mul_small<NW>(A, u, b3, k);  // t2
    } else {
      G.full(A, df[1]);  // t1
    }
  } else {
    G.full(u, df[2]);
    fp_mul_small<NW>(u, u, b3, k);  // t2
    if (w == 2) {
      fp_add<NW>(A, t0, u, k);  // y3t
    } else {
      G.full(A, df[3]);  // xy
    }
    G.slice(b, A);
    fp_add<NW>(A, u, u, k);
    fp_add<NW>(A, A, u, k);   // t2_3
    fp_sub<NW>(A, t0, A, k);  // t0m
  }
  G.slice(a, A);
  G.mul(r, a, b);
}

template <int NW>
__global__ void __launch_bounds__(kHashThreads, kHashMinBlocks)
    hash_g1_kernel(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1, HashBits hb,
                   const uint8_t* __restrict__ hbits, int nh, int hneg,
                   const uint32_t* __restrict__ hc, int sign_be, uint32_t* __restrict__ out,
                   int n, FieldConsts k, int b3) {
  constexpr int K = NW / kHashG;
  extern __shared__ uint4 hash_smem[];  // one HashSlots, above the 48 KB of static memory
  HashSlots<NW>& S = *reinterpret_cast<HashSlots<NW>*>(hash_smem);
  const int w = threadIdx.x / 32;  // the group: one warp
  HashGroup<NW> G;
  G.t = (threadIdx.x & 31) / kHashG;
  G.g = threadIdx.x & (kHashG - 1);
  G.np0 = k.np0;
  G.scratch = &S.scratch[w];
#pragma unroll
  for (int j = 0; j < K; ++j) G.p[j] = group_word<NW, kHashG>(k.p, G.g, j);
  const int t = G.t, g = G.g;
  const int64_t i = (int64_t)blockIdx.x * kHashLanes + t;
  const bool live = i < n;
  uint32_t a[K], b[K], c[K], F[NW], H[NW];

  {  // ---- A. map w's head (w < 2); the sign of u_{w - 2} (w >= 2)
    const int m = w & 1;
    uint32_t u[K] = {};
    if (live) load_words<K>(u, m ? u1 : u0, n, i, g * K);
    if (w >= 2) {
      const uint32_t su = G.sign(u, sign_be, k);
      if (g == 0) S.su[m][t] = su;
    } else {
      uint32_t t1[K];
      G.mul(t1, u, u);
      G.cslice(c, hash_const<NW>(hc, kZ));
      G.mul(t1, t1, c);  // Z u^2
      G.mul(a, t1, t1);
      G.gather(F, a);
      G.gather(H, t1);
      fp_add<NW>(F, F, H, k);  // t2 = Z^2 u^4 + Z u^2
      const bool t2_zero = fp_is_zero<NW>(F, k);
      G.slice(a, F);
      G.pow_win4(a, a, hb.inv, hb.ninv, S.tab[m], k);  // inv(0) = 0
      G.gather(F, a);
      fp_add<NW>(F, F, k.one, k);
      G.slice(a, F);
      G.cslice(c, hash_const<NW>(hc, kNegBOverA));
      G.mul(b, a, c);
      G.cslice(c, hash_const<NW>(hc, kBOverZA));
#pragma unroll
      for (int j = 0; j < K; ++j) b[j] = t2_zero ? c[j] : b[j];  // x1
      G.put(S.x1[m], b);
      G.mul(a, b, b);
      G.gather(F, a);
      fp_add<NW>(F, F, hash_const<NW>(hc, kA), k);
      G.slice(a, F);
      G.mul(a, a, b);
      G.gather(F, a);
      fp_add<NW>(F, F, hash_const<NW>(hc, kB), k);
      G.slice(a, F);  // g(x1)
      G.put(S.gx1[m], a);
      G.mul(c, t1, b);  // x2
      G.put(S.x2[m], c);
      G.mul(c, t1, t1);
      G.mul(c, t1, c);
      G.mul(c, a, c);  // g(x2) = g(x1) Z^3 u^6
      G.put(S.gx2[m], c);
    }
  }
  __syncthreads();
  {  // ---- B. the square root of g(x1) (s = 0) or g(x2) (s = 1) of map m
    const int m = w >> 1, s = w & 1;
    G.get(a, s ? S.gx2[m] : S.gx1[m]);
    G.pow_win4(a, a, hb.sqrt, hb.nsqrt, S.tab[w], k);
    G.put(S.y[m][s], a);
    if (s == 0) {  // is_square: y1^2 = g(x1)
      G.mul(b, a, a);
      G.gather(F, b);
      G.full(H, S.gx1[m]);
      const bool sq = fp_eq<NW>(F, H, k);
      if (g == 0) S.sq[m][t] = sq;
    }
    const uint32_t sy = G.sign(a, sign_be, k);
    if (g == 0) S.sy[m][s][t] = sy;
  }
  __syncthreads();
  {  // ---- C. Horner from each polynomial's leading coefficient: yn and xd
     // (w even) or yd and xn (w odd) of map m, at x = is_sq ? x1 : x2
    const int m = w >> 1;
    const bool sq = S.sq[m][t];
    G.get(a, S.x1[m]);
    G.get(b, S.x2[m]);
    uint32_t x[K];
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = sq ? a[j] : b[j];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int q = (w & 1) ? (h ? 0 : 3) : (h ? 1 : 2);
      const uint32_t* coef = hash_const<NW>(hc, kNumConsts);
      for (int r = 0; r < q; ++r) coef += hc[r] * NW;
      const int cnt = (int)hc[q];
      G.cslice(a, coef + (cnt - 1) * NW);
#pragma unroll 1
      for (int e = cnt - 2; e >= 0; --e) {
        G.mul(a, a, x);
        G.gather(F, a);
        fp_add<NW>(F, F, coef + e * NW, k);
        G.slice(a, F);
      }
      G.put(S.late.ev[m][q], a);
    }
  }
  __syncthreads();
  {  // ---- D. the points: y chosen and sign-fixed, Y = y (yn xd) on
     // groups 0 and 1; X = xn yd and Z = xd yd on groups 2 and 3
    const int m = w & 1;
    if (w < 2) {
      G.get(a, S.late.ev[m][2]);
      G.get(b, S.late.ev[m][1]);
      G.mul(a, a, b);
      const bool sq = S.sq[m][t];
      G.full(F, sq ? S.y[m][0] : S.y[m][1]);
      if (S.su[m][t] != (sq ? S.sy[m][0][t] : S.sy[m][1][t])) neg_y<NW>(F, k);
      G.slice(b, F);
      G.mul(a, b, a);
      G.put(S.late.pt[m][1], a);
    } else {
      G.get(b, S.late.ev[m][3]);
      G.get(a, S.late.ev[m][0]);
      G.mul(c, a, b);
      G.put(S.late.pt[m][0], c);
      G.get(a, S.late.ev[m][1]);
      G.mul(c, a, b);
      G.put(S.late.pt[m][2], c);
    }
  }
  __syncthreads();
  // ---- the RCB add of the two points; group w makes products w and, on
  // groups 0 and 1, w + 4 of each layer
  const HashPoint<NW> P0{S.late.pt[0], 0}, P1{S.late.pt[1], 0};
#pragma unroll 1
  for (int e = w; e < 6; e += 4) {
    hash_add_l1<NW>(a, e, P0, P1, G, k);
    G.put(S.late.f[e], a);
  }
  __syncthreads();
#pragma unroll 1
  for (int e = w; e < 6; e += 4) {
    hash_add_l2<NW>(a, e, S.late.f, G, k, b3);
    G.put(S.late.s[e], a);
  }
  __syncthreads();
  if (w < 3) {  // P = X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb
    HashPoint<NW>{S.late.s, 2}.get(F, w, G, k);
    G.slice(a, F);
    G.put(S.late.sum[w], a);
  }
  __syncthreads();
  // ---- the cofactor ladder over |h_eff|'s MSB-first bits (bits[0] == 1):
  // acc = P, then a doubling at every later bit and the add of P at one-bits
  const HashPoint<NW> Psum{S.late.sum, 0};
  HashPoint<NW> acc = Psum;
#pragma unroll 1
  for (int bit = 1; bit < nh; ++bit) {
    hash_dbl_l1<NW>(a, w, acc, G, k);
    G.put(S.late.df[w], a);
    __syncthreads();
    hash_dbl_l2<NW>(a, w, S.late.df, G, k, b3);
    G.put(S.late.d[w == 2 ? 3 : w == 3 ? 2 : w], a);
    __syncthreads();
    acc = HashPoint<NW>{S.late.d, 1};
    if (__ldg(hbits + bit)) {
#pragma unroll 1
      for (int e = w; e < 6; e += 4) {
        hash_add_l1<NW>(a, e, acc, Psum, G, k);
        G.put(S.late.f[e], a);
      }
      __syncthreads();
#pragma unroll 1
      for (int e = w; e < 6; e += 4) {
        hash_add_l2<NW>(a, e, S.late.f, G, k, b3);
        G.put(S.late.s[e], a);
      }
      __syncthreads();
      acc = HashPoint<NW>{S.late.s, 2};
    }
  }
  if (w < 3 && live) {
    acc.get(F, w, G, k);
    if (w == 1 && hneg) neg_y<NW>(F, k);
    G.slice(a, F);
    store_words<K>(out + (int64_t)w * 2 * NW * n, a, n, i, g * K);
  }
}

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_hash_g1(const uint32_t* u0, const uint32_t* u1, const uint8_t* invbits,
                           int ninv, const uint8_t* sqrtbits, int nsqrt, const uint8_t* hbits,
                           int nh, int hneg, const uint32_t* hc, int sign_be, uint32_t* out, int n,
                           int L, const uint32_t* consts, int b3, cudaStream_t stream) {
  if (L != 24) return -1;
  constexpr int NW = 12;
  const HashBits hb = {invbits, ninv, sqrtbits, nsqrt};
  const dim3 grid((unsigned)((n + kHashLanes - 1) / kHashLanes));
  const cudaError_t attr = cudaFuncSetAttribute(
      hash_g1_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(HashSlots<NW>));
  if (attr != cudaSuccess) return (int)attr;
  hash_g1_kernel<NW><<<grid, kHashThreads, sizeof(HashSlots<NW>), stream>>>(
      u0, u1, hb, hbits, nh, hneg, hc, sign_be, out, n, make_consts(consts, NW), b3);
  return (int)cudaGetLastError();
}
