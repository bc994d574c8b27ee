// Hash-to-G1 kernel for Hopper (sm_90a): port of
// mathlib_tpu/ops/kernels/hash_pallas.py.
//
//   hash_g1_kernel  <- hash_pallas.py:_hash_g1_kernel (hash_g1_pallas)
//
// One thread runs the whole map for one lane, as _hash_g1_kernel runs it for
// a tile: for each of u0 and u1 the simplified SWU map onto the 11-isogenous
// curve E' (RFC 9380 6.6.2; the exceptional t2 = 0 case selects B/(ZA)),
// the sign fix (RFC sgn0 parity, or the BBS big-endian sign of kilic
// custom.go:99-105), the isogeny to E evaluated projectively by Horner (no
// inversion: X = xn*yd, Y = y*yn*xd, Z = xd*yd), then one RCB add of the two
// points and the [h_eff] ladder (a double at every bit after the first, the
// add at one-bits, negated when h_eff < 0).
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
//   * the RCB add and double of g1_rows.cuh.
//
// Inputs: u0, u1 (L, n) Montgomery limbs; the curve's constants as a small
// device array of 32-bit words (four polynomial lengths, then Z, A, B, -B/A,
// B/(ZA) and the isogeny coefficients low-degree-first, NW words each); the
// bits of p - 2, (p + 1)/4 and |h_eff| as device arrays; the sign mode and
// h_eff < 0 as arguments.  One build serves every curve that passes the gate
// (p = 3 mod 4 with G1 isogeny data: BLS12-381 today), so only NW = 12 is
// instantiated.
//
// Bound on this card: operations.  A BLS12-381 lane is ~3,640 field muls
// (two inversion chains of 489, four square-root chains of 484, 110 for the
// isogenies, 12 for the add, 576 for the ladder) for 192 bytes in and 144
// out.  The design runs the chains serially in one thread (inversion x2,
// then square root x4), the table on the thread's stack (768 B at 12
// words); the chain, the map and the isogeny are real calls (__noinline__,
// as nvcc 12.9 crashed on fully inlined formulas).  32 threads a block, so
// 4,096 lanes spread over 128 SMs.  Later work: spread one lane's chains
// over several threads, keep the table in registers or shared memory.
//
// The launcher runs on the caller's stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or -1 for an unsupported L).
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_rows.cuh"

namespace mlt {

// The canonical integer behind a Montgomery value: a product with the
// literal 1, then canon.
template <int NW>
__device__ __forceinline__ void from_mont_canon(uint32_t* r, const uint32_t* a,
                                                const FieldConsts& k) {
  uint32_t one[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) one[j] = j == 0;
  fp_mul<NW>(r, a, one, k);
  fp_canon<NW>(r, r, k);
}

// sign bit of a Montgomery value: RFC sgn0 (parity of the canonical
// integer), or the BBS big-endian sign std <= p - std (_le_neg; std = 0 is
// positive, since then p - std = p).
template <int NW>
__device__ __noinline__ bool hash_sign(const uint32_t* a, int sign_be, const FieldConsts& k) {
  uint32_t s[NW];
  from_mont_canon<NW>(s, a, k);
  if (!sign_be) return s[0] & 1u;
  uint32_t neg[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)k.p[j] - s[j] - borrow;
    neg[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  for (int j = NW - 1; j >= 0; --j)
    if (s[j] != neg[j]) return s[j] < neg[j];
  return true;
}

// r = a^e, e's MSB-first bits in a device array, by the body's 4-bit
// fixed window (_pow_ref).  r may alias a.
template <int NW>
__device__ __noinline__ void fp_pow_win4(uint32_t* r, const uint32_t* a, const uint8_t* bits,
                                         int nbits, const FieldConsts& k) {
  uint32_t tab[16][NW];
  fp_copy<NW>(tab[0], k.one);
  fp_copy<NW>(tab[1], a);
  for (int t = 2; t < 16; ++t) fp_mul<NW>(tab[t], tab[t - 1], a, k);
  const int head = nbits % 4;
  int d = 0;
  for (int i = 0; i < head; ++i) d = 2 * d + bits[i];
  uint32_t acc[NW];
  fp_copy<NW>(acc, tab[d]);  // head == 0: tab[0], the 1 of R mod p
  for (int i = head; i < nbits; i += 4) {
    for (int s = 0; s < 4; ++s) fp_mul<NW>(acc, acc, acc, k);
    d = bits[i] * 8 + bits[i + 1] * 4 + bits[i + 2] * 2 + bits[i + 3];
    fp_mul<NW>(acc, acc, tab[d], k);
  }
  fp_copy<NW>(r, acc);
}

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

// map_to_curve_simple_swu onto E' with the sign fix: u -> affine (x, y)
// (_sswu_body for one input).
template <int NW>
__device__ __noinline__ void sswu_map(uint32_t* x, uint32_t* y, const uint32_t* u,
                                      const uint32_t* __restrict__ hc, HashBits hb, int sign_be,
                                      const FieldConsts& k) {
  uint32_t t1[NW], t2[NW], x1[NW], x2[NW], gx1[NW], gx2[NW], w[NW];
  fp_mul<NW>(t1, u, u, k);
  fp_mul<NW>(t1, t1, hash_const<NW>(hc, kZ), k);  // Z u^2
  fp_mul<NW>(t2, t1, t1, k);
  fp_add<NW>(t2, t2, t1, k);  // Z^2 u^4 + Z u^2
  fp_pow_win4<NW>(w, t2, hb.inv, hb.ninv, k);  // inv(0) = 0
  fp_add<NW>(w, w, k.one, k);
  fp_mul<NW>(x1, w, hash_const<NW>(hc, kNegBOverA), k);
  if (fp_is_zero<NW>(t2, k)) fp_copy<NW>(x1, hash_const<NW>(hc, kBOverZA));
  fp_mul<NW>(w, x1, x1, k);
  fp_add<NW>(w, w, hash_const<NW>(hc, kA), k);
  fp_mul<NW>(w, w, x1, k);
  fp_add<NW>(gx1, w, hash_const<NW>(hc, kB), k);  // g(x1)
  fp_mul<NW>(x2, t1, x1, k);
  fp_mul<NW>(w, t1, t1, k);
  fp_mul<NW>(w, t1, w, k);
  fp_mul<NW>(gx2, gx1, w, k);  // g(x2) = g(x1) Z^3 u^6
  uint32_t y1[NW], y2[NW];
  fp_pow_win4<NW>(y1, gx1, hb.sqrt, hb.nsqrt, k);
  fp_pow_win4<NW>(y2, gx2, hb.sqrt, hb.nsqrt, k);
  fp_mul<NW>(w, y1, y1, k);
  const bool is_sq = fp_eq<NW>(w, gx1, k);
  fp_copy<NW>(x, is_sq ? x1 : x2);
  fp_copy<NW>(y, is_sq ? y1 : y2);
  if (hash_sign<NW>(u, sign_be, k) != hash_sign<NW>(y, sign_be, k)) neg_y<NW>(y, k);
}

// The rational isogeny E' -> E, projectivized: X = xn*yd, Y = y*(yn*xd),
// Z = xd*yd, each polynomial by Horner from its leading coefficient
// (_iso_project).
template <int NW>
__device__ __noinline__ void iso_project(Point<NW>& O, const uint32_t* x, const uint32_t* y,
                                         const uint32_t* __restrict__ hc, const FieldConsts& k) {
  uint32_t ev[4][NW];
  const uint32_t* coef = hash_const<NW>(hc, kNumConsts);
  for (int q = 0; q < 4; ++q) {
    const int cnt = (int)hc[q];
    fp_copy<NW>(ev[q], coef + (cnt - 1) * NW);
    for (int c = cnt - 2; c >= 0; --c) {
      fp_mul<NW>(ev[q], ev[q], x, k);
      fp_add<NW>(ev[q], ev[q], coef + c * NW, k);
    }
    coef += cnt * NW;
  }
  // ev: xn, xd, yn, yd
  fp_mul<NW>(O.x, ev[0], ev[3], k);
  fp_mul<NW>(O.z, ev[1], ev[3], k);
  fp_mul<NW>(ev[2], ev[2], ev[1], k);
  fp_mul<NW>(O.y, y, ev[2], k);
}

template <int NW>
__global__ void hash_g1_kernel(const uint32_t* __restrict__ u0, const uint32_t* __restrict__ u1,
                               HashBits hb, const uint8_t* __restrict__ hbits, int nh, int hneg,
                               const uint32_t* __restrict__ hc, int sign_be,
                               uint32_t* __restrict__ out, int n, FieldConsts k, int b3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point<NW> P, Q;
  uint32_t u[NW], x[NW], y[NW];
  load_fp<NW>(u, u0, 0, n, i);
  sswu_map<NW>(x, y, u, hc, hb, sign_be, k);
  iso_project<NW>(P, x, y, hc, k);
  load_fp<NW>(u, u1, 0, n, i);
  sswu_map<NW>(x, y, u, hc, hb, sign_be, k);
  iso_project<NW>(Q, x, y, hc, k);
  rcb_add<NW>(P, P, Q, k, b3);
  // cofactor ladder over |h_eff|'s MSB-first bits (bits[0] == 1): acc = P
  Q = P;
  for (int b = 1; b < nh; ++b) {
    rcb_dbl<NW>(Q, Q, k, b3);
    if (hbits[b]) rcb_add<NW>(Q, Q, P, k, b3);
  }
  if (hneg) neg_y<NW>(Q.y, k);
  store_point<NW>(out, Q, n, i);
}

constexpr int kHashThreads = 32;

}  // namespace mlt

using namespace mlt;

extern "C" int mlt_hash_g1(const uint32_t* u0, const uint32_t* u1, const uint8_t* invbits,
                           int ninv, const uint8_t* sqrtbits, int nsqrt, const uint8_t* hbits,
                           int nh, int hneg, const uint32_t* hc, int sign_be, uint32_t* out, int n,
                           int L, const uint32_t* consts, int b3, cudaStream_t stream) {
  if (L != 24) return -1;
  constexpr int NW = 12;
  const HashBits hb = {invbits, ninv, sqrtbits, nsqrt};
  const dim3 grid((unsigned)((n + kHashThreads - 1) / kHashThreads));
  hash_g1_kernel<NW><<<grid, kHashThreads, 0, stream>>>(u0, u1, hb, hbits, nh, hneg, hc, sign_be,
                                                        out, n, make_consts(consts, NW), b3);
  return (int)cudaGetLastError();
}
