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
// mul is 2*12*12 = 288 32x32->64 products (IMAD.WIDE, two 32-bit
// multiply-adds each) and 12 low products m = t[0]*np0, so 4*12*12 + 12 =
// 588 multiply-adds, all operands in registers; there are no loads in here
// at all.
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

// Element q of lane i of a (Q, L, n) array of 16-bit limbs held in 32-bit
// words (the reference's lane-major layout): limb pairs pack into NW words.
// A warp reads 128 consecutive bytes per limb.
template <int NW>
__device__ __forceinline__ void load_fp(uint32_t* w, const uint32_t* src, int q, int64_t n,
                                        int64_t i) {
  const uint32_t* base = src + (int64_t)q * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = (base[(2 * j) * n] & 0xFFFFu) | (base[(2 * j + 1) * n] << 16);
}

template <int NW>
__device__ __forceinline__ void store_fp(uint32_t* dst, const uint32_t* w, int q, int64_t n,
                                         int64_t i) {
  uint32_t* base = dst + (int64_t)q * 2 * NW * n + i;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[(2 * j) * n] = w[j] & 0xFFFFu;
    base[(2 * j + 1) * n] = w[j] >> 16;
  }
}

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

// One instruction of a PTX carry chain each.  The carry flag passes from one
// asm statement to the next: the chains below are fully unrolled over
// registers, so nothing is scheduled between the links.
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// fp_mul's CIOS product with its carries in PTX carry chains: per word of b,
// the low halves of a*b[i] go into t[0..NW-1] and the high halves into
// t[1..NW] as two chains, then the same for m*p, then t shifts down a word.
// 4 NW^2 + NW multiply-adds, as fp_mul, without fp_mul's 64-bit adds.  The
// same integer as fp_mul (REDC's output depends on a*b alone).  r may alias
// a or b.
template <int NW>
__device__ __forceinline__ void fp_mul_ptx(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                           const FieldConsts& k) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b[i];
    // t += a * b[i]; t[NW + 1] is 0 here
    t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
    t[NW] = addc_cc(t[NW], 0);
    t[NW + 1] = addc(0, 0);
    t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
    t[NW + 1] = addc(t[NW + 1], 0);
    // t += m * p, which clears t[0]; then t /= 2^32
    const uint32_t m = t[0] * k.np0;
    t[0] = mad_lo_cc(m, k.p[0], t[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(m, k.p[j], t[j]);
    t[NW] = addc_cc(t[NW], 0);
    t[NW + 1] = addc(t[NW + 1], 0);
    t[1] = mad_hi_cc(m, k.p[0], t[1]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j + 1] = madc_hi_cc(m, k.p[j], t[j + 1]);
    t[NW + 1] = addc(t[NW + 1], 0);
#pragma unroll
    for (int j = 0; j <= NW; ++j) t[j] = t[j + 1];
    t[NW + 1] = 0;
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

// r = a^e, e given by its MSB-first bits (a device array, the same for every
// thread): square, then multiply by a at each one bit, from acc = 1
// (RowTower.fp_pow and _fp_pow_kernel; the reference computes the product
// at every bit and selects it, which gives the same values).  The square is
// fp_mul(acc, acc): REDC's output depends on the product alone, so it is
// the reference's RowCtx.sqr bit for bit.  r may alias a.
template <int NW>
__device__ __noinline__ void fp_pow(uint32_t* r, const uint32_t* a, const uint8_t* bits,
                                    int nbits, const FieldConsts& k) {
  uint32_t base[NW], acc[NW];
  fp_copy<NW>(base, a);
  fp_copy<NW>(acc, k.one);
  for (int i = 0; i < nbits; ++i) {
    fp_mul<NW>(acc, acc, acc, k);
    if (bits[i]) fp_mul<NW>(acc, acc, base, k);
  }
  fp_copy<NW>(r, acc);
}

// The constants from the launcher's host array: p[nw], 2p[nw], one[nw], np0.
inline FieldConsts make_consts(const uint32_t* words, int nw) {
  FieldConsts k = {};
  for (int j = 0; j < nw; ++j) {
    k.p[j] = words[j];
    k.p2[j] = words[nw + j];
    k.one[j] = words[2 * nw + j];
  }
  k.np0 = words[3 * nw];
  return k;
}

// r = a - p if a >= p, else a: relaxed [0, 2p) -> canonical [0, p).
template <int NW>
__device__ __forceinline__ void fp_canon(uint32_t* r, const uint32_t* a, const FieldConsts& k) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = (uint64_t)a[j] - k.p[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = borrow ? a[j] : d[j];
}

template <int NW>
__device__ __forceinline__ bool fp_is_zero(const uint32_t* a, const FieldConsts& k) {
  uint32_t c[NW];
  fp_canon<NW>(c, a, k);
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) any |= c[j];
  return any == 0;
}

template <int NW>
__device__ __forceinline__ bool fp_eq(const uint32_t* a, const uint32_t* b,
                                      const FieldConsts& k) {
  uint32_t ca[NW], cb[NW];
  fp_canon<NW>(ca, a, k);
  fp_canon<NW>(cb, b, k);
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) diff |= ca[j] ^ cb[j];
  return diff == 0;
}

}  // namespace mlt
