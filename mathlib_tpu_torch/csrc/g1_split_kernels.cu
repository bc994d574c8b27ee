// The MSM's G1 kernels for Hopper (sm_90a), one RCB formula spread over the
// warps of a block: port of mathlib_tpu/ops/kernels/g1_pallas.py
//
//   g1_add_kernel        <- g1_pallas.py:_add_kernel        (add_pallas)
//   g1_addsel_kernel     <- g1_pallas.py:_addsel_kernel     (addsel_pallas)
//   g1_addselneg_kernel  <- g1_pallas.py:_addselneg_kernel  (addselneg_pallas)
//   g1_maddsel_kernel    <- g1_pallas.py:_maddsel_kernel    (maddsel_pallas)
//   g1_maddselneg_kernel <- g1_pallas.py:_maddselneg_kernel (maddselneg_pallas)
//   g1_double_kernel     <- g1_pallas.py:_double_kernel     (double_pallas)
//   g1_smul_ladder_kernel <- g1_pallas.py:_smul_kernel      (smul_pallas),
//                            and with STATIC _smul_static_kernel
//                            (smul_static_pallas)
//   g1_dbladd_kernel     <- g1_pallas.py:_dbladd_kernel     (dbladd_pallas)
//
// out = P + Q, out = sel ? P + Q : Q (the MSM scan's combiner), its signed
// form out = sel ? P + Q' : Q' with Q' = neg ? (X, -Y, Z) : Q, the mixed
// forms out = sel ? P + lift(Q') : lift(Q') for affine (2, L, n) Q,
// out = 2P, out = [k]Q per lane (the ladder) and out = sel ? 2P + Q : 2P
// (one bit of the ladder), on (3, L, n) int32 words holding 16-bit limbs,
// Montgomery form, relaxed to [0, 2p) (g1_rows.cuh has the layout).
//
// What bounds them on an H100 is the integer multiply rate: an add is 12
// field products (7,056 32-bit multiply-adds at NW = 12) for 288 bytes in and
// 144 out, a mixed add 11 (6,468) for 240 in.  The one-thread design (the
// formula as a call, a lane a thread) held two points and eight temporaries:
// 246-255 registers, a stack, spills, 8 warps an SM, and 12 dependent
// products of latency a lane.  Here the add's shape is used instead: its 12
// products fall into two layers of six independent ones (t0, t1, t2, s3, s4,
// s5; then xa, xb, ya, yb, za, zb) with a short linear middle between them.
// A block owns 32 lanes and has six warps; thread t of every warp works on
// lane blockIdx.x * 32 + t, so each load and store is a 128-byte run, and
//
//   1. warp w stages one coordinate (P's X, Y, Z, Q's X, Y, Z) of the 32
//      lanes into shared memory; the signed form negates Q's Y here, where
//      neg is set, so every later step reads Q';
//   2. warp w computes product w of the first layer from shared memory;
//   3. warp w computes the two middle values its second-layer product needs
//      (_rcb_add_rows' adds, subs and b3 chains, in its order) from the six
//      first-layer products, and multiplies;
//   4. warps 0-2 form X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb, one
//      coordinate each, and store (Q' where sel is 0).
//
// The mixed add (RCB Alg 7 with Z2 = 1, g1_pallas.py _madd_rows, in its
// operation order) is 11 products: warps 0-4 stage P's X, Y, Z and Q's X, Y
// (negated where NEG and neg), the first layer is five products (t0 = X1 X2,
// t1 = Y1 Y2, s3, Z1 Y2 and Z1 X2, the last two finished into t4 = Z1 Y2 +
// Y1 and lnb = b3 (Z1 X2 + X1) by the warp that made them) while warp 5
// computes t2b = b3 Z1; then the middle, the second layer and step 4 as
// above, lift(Q') = (X2, Y2', R mod p) where sel is 0.
//
// The doubling (RCB Alg 9, _rcb_dbl_rows) is 8 products in two layers of four
// (Y Y, Y Z, Z Z, X Y; then t0m xy, t2 z3t, t0m y3t, t1 z3t) for 288 bytes:
// the same design over four warps.  The MSM runs it at 16 lanes (one a
// window) and Horner at one, so what it pays there is the latency of a
// lane, two products instead of eight.
//
// The ladder (smul: RCB Alg 9 then Alg 7 at every bit, MSB first, acc =
// bit ? 2 acc + Q : 2 acc from infinity) runs the doubling's two layers on
// warps 0-3 and the add's two layers on all six a bit, with Q, acc and the
// products in shared memory for all nbits steps: four layers and four
// barriers a bit (two where no lane of the block has the bit), and nothing
// in global memory between bits.  With STATIC every lane shares one scalar,
// its MSB-first bits a uint8 device array (the cofactor clearing of
// HashG1Ctx.clear_cofactor: h_eff, 64 bits, 7 ones): the step's bit is
// read from that array, so the block skips the add's layers at every zero
// bit and runs them at every one-bit, the doubling alone costing two layers
// and two barriers.  Its layers are the add's and the
// doubling's functions (add_layer1/2, dbl_layer1/2 on slots, a point read
// through a source), on fp_mul: at 8,192 lanes and below a lane's chain of
// four layers a bit sets the time, not the instruction rate, and fp_mul's
// carries wait less than fp_mul_ptx's.  The one-thread ladder it replaced
// held 255 registers, a 704-byte stack and spills, and waited for 20
// dependent products a bit.  dbladd (out = sel ? 2P + Q : 2P) is one bit of
// this ladder with acc read from P: P and Q staged from global memory, the
// doubling's two layers, the add's two where a lane of the block has sel,
// and the store of sel ? A : D.
//
// A thread holds two operands and one product: no stack, no spill (ptxas'
// report is on chip_smoke.py's build lines), and a lane waits for two
// products, not twelve or eight.  A block none of whose lanes adds stores
// Q' (or lift(Q')) without the formula.  Shared memory: 12 slots of NW x 32
// words (18 KB at NW = 12) for the adds, 7 for the doubling, 19 and the
// scalar limbs for the ladder, 19 for dbladd.  The MSM kernels' and
// dbladd's field product is fp_mul_ptx (PTX carry chains): 1-2 % faster
// than fp_mul in the MSM kernels, 3-5 % in dbladd at 2^20 lanes and 2 % at
// 8,192, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
//
// The launchers run on the caller's stream, allocate nothing, never
// synchronise, and return cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_rows.cuh"
#include "words.cuh"

namespace mlt {

constexpr int kSplitLanes = 32;
constexpr int kSplitThreads = 6 * kSplitLanes;
// blocks an SM must hold: caps the registers at 65,536 / (3 x 192) = 112
constexpr int kSplitMinBlocks = 3;

// one slot: NW words for each of the block's 32 lanes
template <int NW>
using Slot = uint32_t[NW][kSplitLanes];

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

// coordinate c of an unselected lane's Q': Q's limbs, Y as sub(0, Y) where
// NEG and neg[i]
template <int NW, bool NEG>
__device__ __forceinline__ void store_q(uint32_t* out, const uint32_t* Q,
                                        const uint8_t* __restrict__ neg, int c, int64_t n,
                                        int64_t i, const FieldConsts& k) {
  if (NEG && c == 1 && neg[i]) {
    uint32_t y[NW];
    load_coord<NW>(y, Q, 1, n, i);
    neg_y<NW>(y, k);
    store_coord<NW>(out, y, 1, n, i);
  } else {
    copy_coord<NW>(out, Q, c, n, i);
  }
}

// coordinate c of an unselected lane's lift(Q') = (X2, Y2', R mod p)
template <int NW, bool NEG>
__device__ __forceinline__ void store_lift(uint32_t* out, const uint32_t* Q,
                                           const uint8_t* __restrict__ neg, int c, int64_t n,
                                           int64_t i, const FieldConsts& k) {
  if (c == 2) {
    store_coord<NW>(out, k.one, 2, n, i);
  } else {
    store_q<NW, NEG>(out, Q, neg, c, n, i, k);
  }
}

// the middle values of RCB Alg 7, each from the first layer's products
enum Mid { kT3, kT4, kLnb, kT0x3, kZ3t, kT1m };

// r = one middle value, by _rcb_add_rows' operations in their order, from
// the first layer's slots F: t0, t1, t2, s3, s4, s5
template <int NW>
__device__ __forceinline__ void rcb_mid(uint32_t* r, int id, const Slot<NW>* F, int t,
                                        const FieldConsts& k, int b3) {
  uint32_t u[NW], v[NW];
  switch (id) {
    case kT3:  // s3 - (t0 + t1)
      slot_get<NW>(u, F[0], t);
      slot_get<NW>(v, F[1], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, F[3], t);
      fp_sub<NW>(r, v, u, k);
      break;
    case kT4:  // s4 - (t1 + t2)
      slot_get<NW>(u, F[1], t);
      slot_get<NW>(v, F[2], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, F[4], t);
      fp_sub<NW>(r, v, u, k);
      break;
    case kLnb:  // b3 (s5 - (t0 + t2))
      slot_get<NW>(u, F[0], t);
      slot_get<NW>(v, F[2], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, F[5], t);
      fp_sub<NW>(u, v, u, k);
      fp_mul_small<NW>(r, u, b3, k);
      break;
    case kT0x3:  // (t0 + t0) + t0
      slot_get<NW>(v, F[0], t);
      fp_add<NW>(u, v, v, k);
      fp_add<NW>(r, u, v, k);
      break;
    default:  // kZ3t: t1 + b3 t2; kT1m: t1 - b3 t2
      slot_get<NW>(u, F[2], t);
      fp_mul_small<NW>(u, u, b3, k);
      slot_get<NW>(v, F[1], t);
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

// the layers' field product: fp_mul_ptx (PTX carry chains: fewer
// instructions, for the MSM kernels, whose many lanes make the instruction
// rate the limit) or fp_mul (64-bit carries the compiler schedules: a
// shorter wait, for the ladder, whose lanes wait on one chain of products)
template <int NW, bool PTX>
__device__ __forceinline__ void layer_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConsts& k) {
  if constexpr (PTX) {
    fp_mul_ptx<NW>(r, a, b, k);
  } else {
    fp_mul<NW>(r, a, b, k);
  }
}

// The layers below work on slots alone; the kernels stage from and store to
// global memory around them.  A point operand is read through a source with
// get(r, c, t, k), coordinate c of lane t: SlotPoint reads three slots, the
// ladder's LadderPoint forms its accumulator from the products in its slots.
template <int NW>
struct SlotPoint {
  const Slot<NW>* s;
  __device__ __forceinline__ void get(uint32_t* r, int c, int t, const FieldConsts&) const {
    slot_get<NW>(r, s[c], t);
  }
};

// a, b = the operands of product w of the add's first layer: t0 = X1 X2,
// t1 = Y1 Y2, t2 = Z1 Z2, s3 = (X1 + Y1)(X2 + Y2), s4 = (Y1 + Z1)(Y2 + Z2),
// s5 = (X1 + Z1)(X2 + Z2)
template <int NW, class P1, class P2>
__device__ __forceinline__ void add_operands1(uint32_t* a, uint32_t* b, int w, const P1& P,
                                              const P2& Q, int t, const FieldConsts& k) {
  if (w < 3) {
    P.get(a, w, t, k);
    Q.get(b, w, t, k);
  } else {  // s3: (X, Y), s4: (Y, Z), s5: (X, Z)
    const int c0 = w == 4 ? 1 : 0, c1 = w == 3 ? 1 : 2;
    uint32_t u[NW];
    P.get(a, c0, t, k);
    P.get(u, c1, t, k);
    fp_add<NW>(a, a, u, k);
    Q.get(b, c0, t, k);
    Q.get(u, c1, t, k);
    fp_add<NW>(b, b, u, k);
  }
}

// a = product w of the add's first layer
template <int NW, bool PTX = true, class P1, class P2>
__device__ __forceinline__ void add_layer1(uint32_t* a, int w, const P1& P, const P2& Q, int t,
                                           const FieldConsts& k) {
  uint32_t b[NW];
  add_operands1<NW>(a, b, w, P, Q, t, k);
  layer_mul<NW, PTX>(a, a, b, k);
}

// a, b = the operands of product w of the add's second layer (xa, xb, ya,
// yb, za, zb) from the first layer's slots F
template <int NW>
__device__ __forceinline__ void add_operands2(uint32_t* a, uint32_t* b, int w, const Slot<NW>* F,
                                              int t, const FieldConsts& k, int b3) {
  rcb_mid<NW>(a, kMidA[w], F, t, k, b3);
  rcb_mid<NW>(b, kMidB[w], F, t, k, b3);
}

// a = product w of the add's second layer
template <int NW, bool PTX = true>
__device__ __forceinline__ void add_layer2(uint32_t* a, int w, const Slot<NW>* F, int t,
                                           const FieldConsts& k, int b3) {
  uint32_t b[NW];
  add_operands2<NW>(a, b, w, F, t, k, b3);
  layer_mul<NW, PTX>(a, a, b, k);
}

// a = coordinate c of the sum: X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb
// from the second layer's slots G
template <int NW>
__device__ __forceinline__ void add_sum(uint32_t* a, int c, const Slot<NW>* G, int t,
                                        const FieldConsts& k) {
  uint32_t b[NW];
  slot_get<NW>(a, G[2 * c], t);
  slot_get<NW>(b, G[2 * c + 1], t);
  if (c == 0) {
    fp_sub<NW>(a, a, b, k);
  } else {
    fp_add<NW>(a, a, b, k);
  }
}

// step 4 for warp w < 3 on a lane that adds: coordinate w of the sum from
// the second layer's slots 0-5
template <int NW>
__device__ __forceinline__ void store_sum(uint32_t* out, const Slots<NW>& S, int w, int t,
                                          int64_t n, int64_t i, const FieldConsts& k) {
  uint32_t a[NW];
  add_sum<NW>(a, w, S, t, k);
  store_coord<NW>(out, a, w, n, i);
}

// out = P + Q (SEL false), sel ? P + Q : Q (SEL true), or sel ? P + Q' : Q'
// (SEL and NEG), for the 32 lanes of this block
template <int NW, bool SEL, bool NEG>
__device__ __forceinline__ void split_add(const uint32_t* __restrict__ P,
                                          const uint32_t* __restrict__ Q,
                                          const uint8_t* __restrict__ sel,
                                          const uint8_t* __restrict__ neg,
                                          uint32_t* __restrict__ out, int n, const FieldConsts& k,
                                          int b3) {
  __shared__ Slots<NW> S;
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int64_t i = (int64_t)blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  const bool adds = live && (!SEL || sel[i]);
  if (SEL && !__syncthreads_or(adds)) {  // no lane of the block adds: out = Q'
    if (w < 3 && live) store_q<NW, NEG>(out, Q, neg, w, n, i, k);
    return;
  }
  {  // 1. stage coordinate w % 3 of P (w < 3) or Q'
    uint32_t v[NW] = {};
    if (live) {
      load_coord<NW>(v, w < 3 ? P : Q, w % 3, n, i);
      if (NEG && w == 4 && neg[i]) neg_y<NW>(v, k);
    }
    slot_put<NW>(S[w], v, t);
  }
  __syncthreads();
  {  // 2. t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2; s3, s4, s5 from sums of two coordinates
    uint32_t a[NW];
    add_layer1<NW>(a, w, SlotPoint<NW>{S}, SlotPoint<NW>{S + 3}, t, k);
    slot_put<NW>(S[6 + w], a, t);
  }
  __syncthreads();
  {  // 3. the second layer; slots 0-5 are free since the last barrier
    uint32_t a[NW];
    add_layer2<NW>(a, w, S + 6, t, k, b3);
    slot_put<NW>(S[w], a, t);
  }
  __syncthreads();
  if (w < 3 && live) {  // 4. X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb
    if (adds) {
      store_sum<NW>(out, S, w, t, n, i, k);
    } else {
      store_q<NW, NEG>(out, Q, neg, w, n, i, k);
    }
  }
}

// r = one middle value of the mixed add, by rcb_madd's operations in its
// order, from the first layer's slots: 6 t0, 7 t1, 8 s3, 9 t4, 10 lnb,
// 11 t2b
template <int NW>
__device__ __forceinline__ void madd_mid(uint32_t* r, int id, const Slots<NW>& S, int t,
                                         const FieldConsts& k) {
  uint32_t u[NW], v[NW];
  switch (id) {
    case kT3:  // s3 - (t0 + t1)
      slot_get<NW>(u, S[6], t);
      slot_get<NW>(v, S[7], t);
      fp_add<NW>(u, u, v, k);
      slot_get<NW>(v, S[8], t);
      fp_sub<NW>(r, v, u, k);
      break;
    case kT4:  // Z1 Y2 + Y1, formed in the first layer
      slot_get<NW>(r, S[9], t);
      break;
    case kLnb:  // b3 (Z1 X2 + X1), formed in the first layer
      slot_get<NW>(r, S[10], t);
      break;
    case kT0x3:  // (t0 + t0) + t0
      slot_get<NW>(v, S[6], t);
      fp_add<NW>(u, v, v, k);
      fp_add<NW>(r, u, v, k);
      break;
    default:  // kZ3t: t1 + t2b; kT1m: t1 - t2b
      slot_get<NW>(u, S[11], t);
      slot_get<NW>(v, S[7], t);
      if (id == kZ3t) {
        fp_add<NW>(r, v, u, k);
      } else {
        fp_sub<NW>(r, v, u, k);
      }
  }
}

// out = sel ? P + lift(Q') : lift(Q') for affine (2, L, n) Q, Q' = Q with Y
// negated where NEG and neg, for the 32 lanes of this block.  Q must not be
// (0, 0) on a selected lane.
template <int NW, bool NEG>
__device__ __forceinline__ void split_madd(const uint32_t* __restrict__ P,
                                           const uint32_t* __restrict__ Q,
                                           const uint8_t* __restrict__ sel,
                                           const uint8_t* __restrict__ neg,
                                           uint32_t* __restrict__ out, int n,
                                           const FieldConsts& k, int b3) {
  __shared__ Slots<NW> S;
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int64_t i = (int64_t)blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  const bool adds = live && sel[i];
  if (!__syncthreads_or(adds)) {  // no lane of the block adds: out = lift(Q')
    if (w < 3 && live) store_lift<NW, NEG>(out, Q, neg, w, n, i, k);
    return;
  }
  if (w < 5) {  // 1. stage P's X, Y, Z (w < 3), Q's X and Y' (w = 3, 4)
    uint32_t v[NW] = {};
    if (live) {
      load_coord<NW>(v, w < 3 ? P : Q, w < 3 ? w : w - 3, n, i);
      if (NEG && w == 4 && neg[i]) neg_y<NW>(v, k);
    }
    slot_put<NW>(S[w], v, t);
  }
  __syncthreads();
  {  // 2. t0 = X1 X2, t1 = Y1 Y2, s3 = (X1 + Y1)(X2 + Y2), t4 = Z1 Y2 + Y1,
     // lnb = b3 (Z1 X2 + X1); warp 5: t2b = b3 Z1
    uint32_t a[NW], b[NW];
    if (w == 5) {
      slot_get<NW>(a, S[2], t);
      fp_mul_small<NW>(a, a, b3, k);
    } else {
      if (w < 2) {
        slot_get<NW>(a, S[w], t);
        slot_get<NW>(b, S[w + 3], t);
      } else if (w == 2) {
        uint32_t u[NW];
        slot_get<NW>(a, S[0], t);
        slot_get<NW>(u, S[1], t);
        fp_add<NW>(a, a, u, k);
        slot_get<NW>(b, S[3], t);
        slot_get<NW>(u, S[4], t);
        fp_add<NW>(b, b, u, k);
      } else {  // Z1 Y2 (w = 3), Z1 X2 (w = 4)
        slot_get<NW>(a, S[2], t);
        slot_get<NW>(b, S[w == 3 ? 4 : 3], t);
      }
      fp_mul_ptx<NW>(a, a, b, k);
      if (w >= 3) {  // + Y1 (w = 3), + X1 (w = 4)
        slot_get<NW>(b, S[w == 3 ? 1 : 0], t);
        fp_add<NW>(a, a, b, k);
        if (w == 4) fp_mul_small<NW>(a, a, b3, k);
      }
    }
    slot_put<NW>(S[6 + w], a, t);
  }
  __syncthreads();
  {  // 3. the second layer; slots 0-5 are free since the last barrier
    uint32_t a[NW], b[NW];
    madd_mid<NW>(a, kMidA[w], S, t, k);
    madd_mid<NW>(b, kMidB[w], S, t, k);
    fp_mul_ptx<NW>(a, a, b, k);
    slot_put<NW>(S[w], a, t);
  }
  __syncthreads();
  if (w < 3 && live) {  // 4. X3 = xa - xb, Y3 = ya + yb, Z3 = za + zb
    if (adds) {
      store_sum<NW>(out, S, w, t, n, i, k);
    } else {
      store_lift<NW, NEG>(out, Q, neg, w, n, i, k);
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_add_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                  uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  split_add<NW, false, false>(P, Q, nullptr, nullptr, out, n, k, b3);
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_addsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, int b3) {
  split_add<NW, true, false>(P, Q, sel, nullptr, out, n, k, b3);
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_addselneg_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                        const uint8_t* __restrict__ sel, const uint8_t* __restrict__ neg,
                        uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  split_add<NW, true, true>(P, Q, sel, neg, out, n, k, b3);
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_maddsel_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                      const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                      FieldConsts k, int b3) {
  split_madd<NW, false>(P, Q, sel, nullptr, out, n, k, b3);
}

template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_maddselneg_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                         const uint8_t* __restrict__ sel, const uint8_t* __restrict__ neg,
                         uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  split_madd<NW, true>(P, Q, sel, neg, out, n, k, b3);
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
// dyb = t0m y3t, dz = t1 z3t, each middle value by _rcb_dbl_rows' operations
// in its order (z3t = 8 t0, t2 = b3 zz, y3t = t0 + t2,
// t0m = t0 - ((t2 + t2) + t2)) from the first layer's slots T: t0, t1, zz, xy
template <int NW>
__device__ __forceinline__ void dbl_mid(uint32_t* a, uint32_t* b, int w, const Slot<NW>* T,
                                        int t, const FieldConsts& k, int b3) {
  uint32_t t0[NW], u[NW];
  slot_get<NW>(t0, T[0], t);
  if (w == 1 || w == 3) {
    fp_mul_small<NW>(b, t0, 8, k);  // z3t
    if (w == 1) {
      slot_get<NW>(u, T[2], t);
      fp_mul_small<NW>(a, u, b3, k);  // t2
    } else {
      slot_get<NW>(a, T[1], t);  // t1
    }
    return;
  }
  slot_get<NW>(u, T[2], t);
  fp_mul_small<NW>(u, u, b3, k);  // t2
  if (w == 2) {
    fp_add<NW>(b, t0, u, k);  // y3t
  } else {
    slot_get<NW>(b, T[3], t);  // xy
  }
  fp_add<NW>(a, u, u, k);
  fp_add<NW>(a, a, u, k);  // t2_3
  fp_sub<NW>(a, t0, a, k);  // t0m
}

// a, b = the operands of product w of the doubling's first layer: t0 = Y Y,
// t1 = Y Z, zz = Z Z, xy = X Y
template <int NW, class Pt>
__device__ __forceinline__ void dbl_operands1(uint32_t* a, uint32_t* b, int w, const Pt& P, int t,
                                              const FieldConsts& k) {
  P.get(a, w == 2 ? 2 : w == 3 ? 0 : 1, t, k);
  P.get(b, w == 0 || w == 3 ? 1 : 2, t, k);
}

// a = product w of the doubling's first layer
template <int NW, bool PTX = true, class Pt>
__device__ __forceinline__ void dbl_layer1(uint32_t* a, int w, const Pt& P, int t,
                                           const FieldConsts& k) {
  uint32_t b[NW];
  dbl_operands1<NW>(a, b, w, P, t, k);
  layer_mul<NW, PTX>(a, a, b, k);
}

// a = product w of the doubling's second layer (dxa, dya, dyb, dz) from the
// first layer's slots T
template <int NW, bool PTX = true>
__device__ __forceinline__ void dbl_layer2(uint32_t* a, int w, const Slot<NW>* T, int t,
                                           const FieldConsts& k, int b3) {
  uint32_t b[NW];
  dbl_mid<NW>(a, b, w, T, t, k, b3);
  layer_mul<NW, PTX>(a, a, b, k);
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
    uint32_t a[NW];
    dbl_layer1<NW>(a, w, SlotPoint<NW>{S}, t, k);
    slot_put<NW>(S[3 + w], a, t);
  }
  __syncthreads();
  uint32_t a[NW], b[NW];  // 3. the middle values, then the second layer
  dbl_layer2<NW>(a, w, S + 3, t, k, b3);
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

// The ladder's accumulator and its doubling D, read from the ladder's slots:
// D = (dxa + dxa, dya + dyb, dz) from the doubling's second layer d (dxa,
// dya, dz, dyb), and A = D + Q from the add's second layer g (add_sum),
// taken where `sum` is set (the step's bit): acc = bit ? A : D.
template <int NW>
struct LadderPoint {
  const Slot<NW>* d;
  const Slot<NW>* g;
  bool sum;
  __device__ __forceinline__ void get(uint32_t* r, int c, int t, const FieldConsts& k) const {
    if (sum) {
      add_sum<NW>(r, c, g, t, k);
      return;
    }
    slot_get<NW>(r, d[c], t);
    if (c == 0) {
      fp_add<NW>(r, r, r, k);
    } else if (c == 1) {
      uint32_t u[NW];
      slot_get<NW>(u, d[3], t);
      fp_add<NW>(r, r, u, k);
    }
  }
};

// the ladder's slots: Q (staged once), the doubling's second layer d (dxa,
// dya, dz, dyb), and f: the add's second layer in 0-5 and each first layer's
// products in 6-11 (the doubling's in 6-9)
template <int NW>
struct LadderSlots {
  Slot<NW> q[3];
  Slot<NW> d[4];
  Slot<NW> f[12];
};

// out = [k]Q for the 32 lanes of this block: MSB first, D = 2 acc (the
// doubling's two layers on warps 0-3), A = D + Q (the add's two layers on
// the six warps), acc = bit ? A : D, from acc = infinity; every value stays
// in shared memory across the nbits steps.  The select costs no step of its
// own: the next doubling's first layer and the final store read acc through
// LadderPoint, from the slots of D and A.  A block none of whose lanes has
// the step's bit skips the add (acc = D either way).  The block's scalar
// limbs sit in dynamic shared memory, [limb][lane].  STATIC: one scalar for
// every lane, its MSB-first bits in `bits` (s unused), the add skipped at
// its zero bits: smul_static_plain's double and add at every step, in its
// order.
template <int NW, bool STATIC>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_smul_ladder_kernel(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ s,
                          const uint8_t* __restrict__ bits, uint32_t* __restrict__ out, int n,
                          int nbits, FieldConsts k, int b3) {
  __shared__ LadderSlots<NW> S;
  extern __shared__ uint32_t limbs[];
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int i = blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  if (!STATIC) {
    for (int l = w; l < (nbits + 15) / 16; l += 6) {
      limbs[l * kSplitLanes + t] = live ? s[(int64_t)l * n + i] : 0u;
    }
  }
  {  // Q's coordinate w on warps 0-2; acc = infinity (0 : R mod p : 0) as the
     // D of dxa = 0, dya = R mod p, dz = dyb = 0 on warps 3-5
    uint32_t v[NW] = {};
    if (w < 3) {
      if (live) load_coord<NW>(v, Q, w, n, i);
      slot_put<NW>(S.q[w], v, t);
    } else if (w == 4) {
      slot_put<NW>(S.d[1], k.one, t);
    } else {
      slot_put<NW>(S.d[w == 3 ? 0 : 2], v, t);
      if (w == 3) slot_put<NW>(S.d[3], v, t);
    }
  }
  __syncthreads();
  bool bit = false;  // the last step's bit of this lane: acc is A, else D
  for (int b = nbits - 1; b >= 0; --b) {
    if (w < 4) {  // 1. the doubling's first layer, from acc
      uint32_t a[NW];
      dbl_layer1<NW, false>(a, w, LadderPoint<NW>{S.d, S.f, bit}, t, k);
      slot_put<NW>(S.f[6 + w], a, t);
    }
    __syncthreads();
    if (w < 4) {  // 2. its second layer: dxa, dya, dyb, dz into d 0, 1, 3, 2
      uint32_t a[NW];
      dbl_layer2<NW, false>(a, w, S.f + 6, t, k, b3);
      slot_put<NW>(S.d[w == 2 ? 3 : w == 3 ? 2 : w], a, t);
    }
    if (STATIC) {
      bit = __ldg(bits + (nbits - 1 - b)) != 0;
    } else {
      bit = (limbs[(b >> 4) * kSplitLanes + t] >> (b & 15)) & 1u;
    }
    if (!__syncthreads_or(bit)) continue;  // no lane of the block adds: acc = D
    {  // 3. the add's first layer, D + Q
      uint32_t a[NW];
      add_layer1<NW, false>(a, w, LadderPoint<NW>{S.d, S.f, false}, SlotPoint<NW>{S.q}, t, k);
      slot_put<NW>(S.f[6 + w], a, t);
    }
    __syncthreads();
    {  // 4. its second layer; f 0-5 were last read by step 1
      uint32_t a[NW];
      add_layer2<NW, false>(a, w, S.f + 6, t, k, b3);
      slot_put<NW>(S.f[w], a, t);
    }
    __syncthreads();
  }
  if (w < 3 && live) {
    uint32_t a[NW];
    LadderPoint<NW>{S.d, S.f, bit}.get(a, w, t, k);
    store_coord<NW>(out, a, w, n, i);
  }
}

// out = sel ? 2P + Q : 2P for the 32 lanes of this block: one bit of the
// ladder above with acc read from P.  Warps 0-2 stage P's coordinates into
// f 0-2 (free until the add's second layer), warps 3-5 Q's into q; then four
// layers of one product a warp: the doubling's two on warps 0-3, the first
// reading P, and, where a lane of the block has sel, the add's two on the
// six, D + Q; then warps 0-2 store coordinate w of LadderPoint{d, f, sel}.
// A block none of whose lanes has sel stores D without the add.  The layers
// run in a loop through one product site: with a product inlined per layer
// (four copies of fp_mul_ptx) the kernel took 12 % longer at 2^20 lanes and
// 6 % at 8,192 on an H100 (PERF.md section 6).
template <int NW>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
    g1_dbladd_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                     const uint8_t* __restrict__ sel, uint32_t* __restrict__ out, int n,
                     FieldConsts k, int b3) {
  __shared__ LadderSlots<NW> S;
  const int t = threadIdx.x & (kSplitLanes - 1);
  const int w = threadIdx.x / kSplitLanes;
  const int64_t i = (int64_t)blockIdx.x * kSplitLanes + t;
  const bool live = i < n;
  const bool adds = live && sel[i];
  {  // P's coordinate w into f w (w < 3), Q's coordinate w - 3 into q
    uint32_t v[NW] = {};
    if (live) load_coord<NW>(v, w < 3 ? P : Q, w % 3, n, i);
    slot_put<NW>(w < 3 ? S.f[w] : S.q[w - 3], v, t);
  }
  __syncthreads();
#pragma unroll 1
  for (int lay = 0; lay < 4; ++lay) {
    if (lay == 2 && !__syncthreads_or(adds)) break;  // no lane of the block adds
    if (lay >= 2 || w < 4) {
      uint32_t a[NW], b[NW];
      if (lay == 0) {  // t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y of P
        dbl_operands1<NW>(a, b, w, SlotPoint<NW>{S.f}, t, k);
      } else if (lay == 1) {  // dxa, dya, dyb, dz
        dbl_mid<NW>(a, b, w, S.f + 6, t, k, b3);
      } else if (lay == 2) {  // t0, t1, t2, s3, s4, s5 of D and Q
        add_operands1<NW>(a, b, w, LadderPoint<NW>{S.d, S.f, false}, SlotPoint<NW>{S.q}, t, k);
      } else {  // xa, xb, ya, yb, za, zb; P's f 0-2 were last read by layer 0
        add_operands2<NW>(a, b, w, S.f + 6, t, k, b3);
      }
      fp_mul_ptx<NW>(a, a, b, k);
      // layer 0 into f 6-9, 1 into d 0, 1, 3, 2, 2 into f 6-11, 3 into f 0-5
      slot_put<NW>(lay == 1 ? S.d[w == 2 ? 3 : w == 3 ? 2 : w] : S.f[lay == 3 ? w : 6 + w], a, t);
    }
    if (lay != 1) __syncthreads();  // layer 1's barrier is layer 2's vote
  }
  if (w < 3 && live) {  // sel ? A : D
    uint32_t a[NW];
    LadderPoint<NW>{S.d, S.f, adds}.get(a, w, t, k);
    store_coord<NW>(out, a, w, n, i);
  }
}

inline dim3 split_grid(int n) { return dim3((unsigned)((n + kSplitLanes - 1) / kSplitLanes)); }

}  // namespace mlt

using namespace mlt;

// L = 16 (BN254's p) and L = 24 (BLS12-381's and BLS12-377's p) here; L = 18
// (FP256BN's p on the card) in the twin g1_split_kernels_nw9.cu (words.cuh)
#define MLT_DISPATCH(L, ...) \
  MLT_WORDS(L, __VA_ARGS__)  \
  return (int)cudaGetLastError();

MLT_LAUNCHER(mlt_g1_add, const uint32_t* P, const uint32_t* Q, uint32_t* out, int n, int L,
             const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_add, P, Q, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_add_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_addsel, const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out,
             int n, int L, const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_addsel, P, Q, sel, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_addsel_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_addselneg, const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
             const uint8_t* neg, uint32_t* out, int n, int L, const uint32_t* consts, int b3,
             cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_addselneg, P, Q, sel, neg, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_addselneg_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, neg, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_maddsel, const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
             uint32_t* out, int n, int L, const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_maddsel, P, Q, sel, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_maddsel_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_maddselneg, const uint32_t* P, const uint32_t* Q, const uint8_t* sel,
             const uint8_t* neg, uint32_t* out, int n, int L, const uint32_t* consts, int b3,
             cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_maddselneg, P, Q, sel, neg, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_maddselneg_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, neg, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_dbladd, const uint32_t* P, const uint32_t* Q, const uint8_t* sel, uint32_t* out,
             int n, int L, const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_dbladd, P, Q, sel, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_dbladd_kernel<NW><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      P, Q, sel, out, n, make_consts(consts, NW), b3))
}

MLT_LAUNCHER(mlt_g1_smul, const uint32_t* Q, const uint32_t* s, uint32_t* out, int n, int L, int S,
             int nbits, const uint32_t* consts, int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_smul, Q, s, out, n, L, S, nbits, consts, b3, stream)
  if (nbits < 0 || nbits > 16 * S) return -1;
  const size_t limb_bytes = (size_t)((nbits + 15) / 16) * kSplitLanes * sizeof(uint32_t);
  MLT_DISPATCH(L, g1_smul_ladder_kernel<NW, false>
               <<<split_grid(n), kSplitThreads, limb_bytes, stream>>>(
                   Q, s, nullptr, out, n, nbits, make_consts(consts, NW), b3))
}

// the static ladder is the device hash's cofactor clearing (BLS12-381
// only): no NW = 9 twin
#ifndef MLT_NW9
extern "C" int mlt_g1_smul_static(const uint32_t* Q, const uint8_t* bits, int nbits, uint32_t* out,
                                  int n, int L, const uint32_t* consts, int b3,
                                  cudaStream_t stream) {
  if (nbits < 0) return -1;
  MLT_DISPATCH(L, g1_smul_ladder_kernel<NW, true><<<split_grid(n), kSplitThreads, 0, stream>>>(
                      Q, nullptr, bits, out, n, nbits, make_consts(consts, NW), b3))
}
#endif

MLT_LAUNCHER(mlt_g1_double, const uint32_t* P, uint32_t* out, int n, int L, const uint32_t* consts,
             int b3, cudaStream_t stream) {
  MLT_TO_NW9(mlt_g1_double, P, out, n, L, consts, b3, stream)
  MLT_DISPATCH(L, g1_double_kernel<NW><<<split_grid(n), kDblThreads, 0, stream>>>(
                      P, out, n, make_consts(consts, NW), b3))
}
