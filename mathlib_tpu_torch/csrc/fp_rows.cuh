// Prime-field arithmetic for one thread's registers (port of
// mathlib_tpu/ops/kernels/fp_rows.py RowCtx).
//
// An element is NW 32-bit words, little-endian: the reference's 2*NW 16-bit
// limbs packed in pairs.  Values are Montgomery form with R = 2^(32*NW) =
// 2^(16*L), relaxed to [0, 2p) exactly as in the reference, and every
// function returns the same integer the reference does:
//
//   * mul   -- interleaved CIOS Montgomery product, (a*b + m*p) / R with
//              m = -a*b/p mod R, and NO final conditional subtraction (the
//              reference has none: inputs < 2p and 4p <= R keep the output
//              below 2p).  REDC's output does not depend on the digit size,
//              so 32-bit words give the reference's 16-bit-limb result.
//   * add   -- a + b, minus 2p if that is >= 2p.
//   * sub   -- a - b, plus 2p if that is negative (the reference computes
//              a - b + 2p, then subtracts 2p if the result is >= 2p).
//   * mul_small -- a * n by the reference's add chain (MSB first: double,
//              and add a at every one bit), so the relaxed representative
//              that comes out is the reference's too.
//
// Bound on this card: integer multiply issue rate and registers.  A 12-word
// mul is 2*12*12 + 12 = 300 32x32->64 multiplies (IMAD.WIDE), all operands in
// registers; there are no loads in here at all.
#pragma once

#include <cstdint>

namespace mlt {

constexpr int kMaxWords = 12;

// Per-prime constants, passed by value as a kernel parameter (constant bank).
struct FieldConsts {
  uint32_t p[kMaxWords];
  uint32_t p2[kMaxWords];   // 2p
  uint32_t one[kMaxWords];  // R mod p: 1 in Montgomery form
  uint32_t np0;             // -p^-1 mod 2^32
};

template <int NW>
__device__ __forceinline__ void fp_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = a[j];
}

// r = s - 2p if s >= 2p, else s.  r may alias s.
template <int NW>
__device__ __forceinline__ void fp_cond_sub_2p(uint32_t* r, const uint32_t* s,
                                               const FieldConsts& k) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)s[j] - k.p2[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  // no borrow out  <=>  s >= 2p
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = borrow ? s[j] : d[j];
}

// r = a + b reduced to [0, 2p).  Any of r, a, b may alias.
template <int NW>
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const FieldConsts& k) {
  uint32_t s[NW];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + carry;
    s[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  // a + b < 4p <= R: no carry out of the top word
  fp_cond_sub_2p<NW>(r, s, k);
}

// r = a - b in [0, 2p).  Any of r, a, b may alias.
template <int NW>
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const FieldConsts& k) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  // a < b: add 2p back (wraps mod R to a - b + 2p in (0, 2p))
  const uint32_t mask = 0u - borrow;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)d[j] + (k.p2[j] & mask) + carry;
    r[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
}

// r = a * b * R^-1 mod p (relaxed), interleaved CIOS.  r may alias a or b.
template <int NW>
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                       const FieldConsts& k) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t v = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)v;
    t[NW + 1] = (uint32_t)(v >> 32);
    // t = (t + m * p) / 2^32 with m chosen so the low word vanishes
    const uint32_t m = t[0] * k.np0;
    v = (uint64_t)m * k.p[0] + t[0];
    c = v >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      v = (uint64_t)m * k.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)v;
      c = v >> 32;
    }
    v = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)v;
    t[NW] = t[NW + 1] + (uint32_t)(v >> 32);
  }
  fp_copy<NW>(r, t);  // t[NW] == 0: the result is below 2p < R
}

// r = a * n for a small n > 0, by the reference's add chain.  r may alias a.
template <int NW>
__device__ __forceinline__ void fp_mul_small(uint32_t* r, const uint32_t* a, int n,
                                             const FieldConsts& k) {
  uint32_t base[NW], acc[NW];
  fp_copy<NW>(base, a);
  fp_copy<NW>(acc, a);
  int top = 31 - __clz(n);
  for (int bit = top - 1; bit >= 0; --bit) {
    fp_add<NW>(acc, acc, acc, k);
    if ((n >> bit) & 1) fp_add<NW>(acc, acc, base, k);
  }
  fp_copy<NW>(r, acc);
}

}  // namespace mlt
