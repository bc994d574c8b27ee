// Native host pairing engine (C++): the port's own copy of the repository's
// native/engine.cpp, built with g++ by mathlib_tpu_torch/host/native.py.
//
// The port's host finisher and oracle: G1/G2 group law and scalar mul, host
// Pippenger MSM, Miller loop + final exponentiation, Gt (Fp12)
// exponentiation.  The pairing-product check finishes its single unreduced
// device product here (one final exponentiation and a unity test).
//
// Bit-exactness contract: every algorithm mirrors mathlib_tpu_torch/host/
// {fields.py, curve.py, engine.py} (same tower construction Fp2=Fp[u]/(u²-β),
// Fp6=Fp2[v]/(v³-ξ), Fp12=Fp6[w]/(w²-v), same Miller-loop shape, same
// base-p hard-part multi-exponentiation), so the Python engine remains the
// differential oracle (tests/test_torch_host.py).
//
// Generic over CurveSpec: all constants (modulus, β, ξ, twist, x, Frobenius
// constants, hard-part base-p digits) arrive in a config blob from Python —
// one compiled library serves BLS12-381, BLS12-377, BN254 and FP256BN.
//
// Arithmetic core: L×64-bit-limb Montgomery CIOS (the algorithm the
// reference spells out in Go at driver/kilic/custom_generic.go:57-175;
// re-derived here with __uint128 accumulators, valid for any p < 2^(64L),
// including FP256BN's p ≈ 2^256).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const int MAXL = 6;

// ---------------------------------------------------------------------------
// Montgomery context
// ---------------------------------------------------------------------------

struct Mont {
  int L;
  u64 p[MAXL];
  u64 r2[MAXL];    // 2^(128L) mod p          (Montgomery form of R)
  u64 one_m[MAXL]; // 2^(64L) mod p           (Montgomery form of 1)
  u64 pm2[MAXL];   // p - 2                   (inversion exponent)
  u64 ninv;        // -p^{-1} mod 2^64
};

struct FpE {
  u64 v[MAXL];
};

static inline void fp_zero(FpE &o) { std::memset(o.v, 0, sizeof(o.v)); }

static inline bool fp_is_zero(const Mont &m, const FpE &a) {
  for (int i = 0; i < m.L; i++)
    if (a.v[i]) return false;
  return true;
}

static inline bool fp_eq(const Mont &m, const FpE &a, const FpE &b) {
  for (int i = 0; i < m.L; i++)
    if (a.v[i] != b.v[i]) return false;
  return true;
}

static inline int cmp_n(const u64 *a, const u64 *b, int L) {
  for (int i = L - 1; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

static inline u64 sub_n(u64 *o, const u64 *a, const u64 *b, int L) {
  u64 borrow = 0;
  for (int i = 0; i < L; i++) {
    u64 bi = b[i];
    u64 d = a[i] - bi;
    u64 b1 = d > a[i];
    u64 d2 = d - borrow;
    u64 b2 = d2 > d;
    o[i] = d2;
    borrow = b1 | b2;
  }
  return borrow;
}

static inline u64 add_n(u64 *o, const u64 *a, const u64 *b, int L) {
  u64 carry = 0;
  for (int i = 0; i < L; i++) {
    u128 s = (u128)a[i] + b[i] + carry;
    o[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  return carry;
}

static inline void fp_add(const Mont &m, const FpE &a, const FpE &b, FpE &o) {
  u64 t[MAXL];
  u64 carry = add_n(t, a.v, b.v, m.L);
  if (carry || cmp_n(t, m.p, m.L) >= 0) sub_n(t, t, m.p, m.L);
  std::memcpy(o.v, t, 8 * m.L);
}

static inline void fp_sub(const Mont &m, const FpE &a, const FpE &b, FpE &o) {
  u64 t[MAXL];
  u64 borrow = sub_n(t, a.v, b.v, m.L);
  if (borrow) add_n(t, t, m.p, m.L);
  std::memcpy(o.v, t, 8 * m.L);
}

static inline void fp_neg(const Mont &m, const FpE &a, FpE &o) {
  if (fp_is_zero(m, a)) {
    fp_zero(o);
    return;
  }
  sub_n(o.v, m.p, a.v, m.L);
}

// Montgomery CIOS multiply: o = a * b * R^{-1} mod p.
// Templated on the limb count so the compiler fully unrolls the inner
// loops (the generic runtime-L loop below is ~2.5x slower); dispatched
// once per call in fp_mul.
template <int L>
static void fp_mul_t(const Mont &m, const FpE &a, const FpE &b, FpE &o) {
  u64 t[L + 2];
  std::memset(t, 0, sizeof(t));
  for (int i = 0; i < L; i++) {
    u64 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < L; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + carry;
      t[j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    u128 s = (u128)t[L] + carry;
    t[L] = (u64)s;
    t[L + 1] = (u64)(s >> 64);
    u64 mi = t[0] * m.ninv;
    u128 cur = (u128)mi * m.p[0] + t[0];
    carry = (u64)(cur >> 64);
    for (int j = 1; j < L; j++) {
      cur = (u128)mi * m.p[j] + t[j] + carry;
      t[j - 1] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    s = (u128)t[L] + carry;
    t[L - 1] = (u64)s;
    t[L] = t[L + 1] + (u64)(s >> 64);
    t[L + 1] = 0;
  }
  bool ge = t[L] != 0;
  if (!ge) {
    ge = true;
    for (int i = L - 1; i >= 0; i--) {
      if (t[i] != m.p[i]) {
        ge = t[i] > m.p[i];
        break;
      }
    }
  }
  if (ge) sub_n(t, t, m.p, L);
  std::memcpy(o.v, t, 8 * L);
}

static void fp_mul_generic(const Mont &m, const FpE &a, const FpE &b, FpE &o) {
  int L = m.L;
  u64 t[MAXL + 2];
  std::memset(t, 0, sizeof(t));
  for (int i = 0; i < L; i++) {
    u64 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < L; j++) {
      u128 cur = (u128)ai * b.v[j] + t[j] + carry;
      t[j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    u128 s = (u128)t[L] + carry;
    t[L] = (u64)s;
    t[L + 1] = (u64)(s >> 64);
    u64 mi = t[0] * m.ninv;
    u128 cur = (u128)mi * m.p[0] + t[0];
    carry = (u64)(cur >> 64);
    for (int j = 1; j < L; j++) {
      cur = (u128)mi * m.p[j] + t[j] + carry;
      t[j - 1] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    s = (u128)t[L] + carry;
    t[L - 1] = (u64)s;
    t[L] = t[L + 1] + (u64)(s >> 64);
    t[L + 1] = 0;
  }
  if (t[L] || cmp_n(t, m.p, m.L) >= 0) sub_n(t, t, m.p, m.L);
  std::memcpy(o.v, t, 8 * L);
}

static inline void fp_mul(const Mont &m, const FpE &a, const FpE &b, FpE &o) {
  switch (m.L) {
    case 4:
      fp_mul_t<4>(m, a, b, o);
      return;
    case 6:
      fp_mul_t<6>(m, a, b, o);
      return;
    default:
      fp_mul_generic(m, a, b, o);
  }
}

// o = a^e for a multi-limb exponent (plain integer limbs, not Montgomery).
static void fp_pow(const Mont &m, const FpE &a, const u64 *e, int elimbs, FpE &o) {
  FpE res;
  std::memcpy(res.v, m.one_m, sizeof(res.v)); // 1 in Montgomery form
  int top = elimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int i = top; i >= 0; i--) {
    fp_mul(m, res, res, res);
    if ((e[i / 64] >> (i % 64)) & 1) fp_mul(m, res, a, res);
  }
  o = res;
}

static inline void fp_inv(const Mont &m, const FpE &a, FpE &o) {
  fp_pow(m, a, m.pm2, m.L, o);
}

static void mont_init(Mont &m, const u64 *p, int L) {
  m.L = L;
  std::memset(m.p, 0, sizeof(m.p));
  std::memcpy(m.p, p, 8 * L);
  // ninv = -p^{-1} mod 2^64 (Newton-Hensel)
  u64 inv = p[0];
  for (int i = 0; i < 6; i++) inv *= 2 - p[0] * inv;
  m.ninv = ~inv + 1;
  // one_m = 2^(64L) mod p, r2 = 2^(128L) mod p — by repeated mod-doubling
  u64 x[MAXL];
  std::memset(x, 0, sizeof(x));
  x[0] = 1;
  if (cmp_n(x, m.p, L) >= 0) sub_n(x, x, m.p, L); // p == 1 impossible; safety
  for (int i = 0; i < 64 * L; i++) {
    u64 carry = add_n(x, x, x, L);
    if (carry || cmp_n(x, m.p, L) >= 0) sub_n(x, x, m.p, L);
  }
  std::memset(m.one_m, 0, sizeof(m.one_m));
  std::memcpy(m.one_m, x, 8 * L);
  for (int i = 0; i < 64 * L; i++) {
    u64 carry = add_n(x, x, x, L);
    if (carry || cmp_n(x, m.p, L) >= 0) sub_n(x, x, m.p, L);
  }
  std::memset(m.r2, 0, sizeof(m.r2));
  std::memcpy(m.r2, x, 8 * L);
  // pm2 = p - 2
  u64 two[MAXL];
  std::memset(two, 0, sizeof(two));
  two[0] = 2;
  std::memset(m.pm2, 0, sizeof(m.pm2));
  sub_n(m.pm2, m.p, two, L);
}

// plain little-endian bytes (8L) -> Montgomery form
static void fp_from_bytes(const Mont &m, const uint8_t *in, FpE &o) {
  FpE t;
  fp_zero(t);
  for (int i = 0; i < m.L; i++) {
    u64 w = 0;
    for (int j = 7; j >= 0; j--) w = (w << 8) | in[8 * i + j];
    t.v[i] = w;
  }
  FpE r2;
  std::memcpy(r2.v, m.r2, sizeof(r2.v));
  fp_mul(m, t, r2, o);
}

// Montgomery form -> plain little-endian bytes (8L)
static void fp_to_bytes(const Mont &m, const FpE &a, uint8_t *out) {
  FpE one_plain, t;
  fp_zero(one_plain);
  one_plain.v[0] = 1;
  fp_mul(m, a, one_plain, t); // REDC: a * R^{-1}
  for (int i = 0; i < m.L; i++) {
    u64 w = t.v[i];
    for (int j = 0; j < 8; j++) {
      out[8 * i + j] = (uint8_t)(w & 0xff);
      w >>= 8;
    }
  }
}

// ---------------------------------------------------------------------------
// Tower fields (mirror mathlib_tpu_torch/host/fields.py)
// ---------------------------------------------------------------------------

struct Fp2E {
  FpE c0, c1;
};
struct Fp6E {
  Fp2E c[3];
};
struct Fp12E {
  Fp6E c[2];
};

struct Ctx {
  Mont m;
  int family; // 0 = BLS12, 1 = BN
  int twist;  // 0 = M, 1 = D
  int x_neg;
  u64 x_abs;
  FpE beta;   // Montgomery
  Fp2E xi;
  FpE b;
  Fp2E b2;
  // small-constant fast paths: beta = (-1)^beta_neg * beta_abs and
  // xi = ((-1)^{...} handled via value) with tiny magnitudes -> the
  // beta/xi multiplies become add chains instead of full fp_muls
  int beta_small; // 1 when |beta| (mod-centered) < 64
  int beta_neg;
  u64 beta_abs;
  int xi_small; // 1 when xi = (xi0, xi1) with both < 64 (plain values)
  u64 xi0, xi1;
  Fp2E frob_v; // xi^((p-1)/3)
  Fp2E frob_w; // xi^((p-1)/6)
  int ndigits; // base-p digits of the hard-part exponent
  std::vector<FpE> hard_digits_plain; // PLAIN limb values (exponent bits)
  // sparse-Miller constants: 3*b2, and psi-endomorphism coordinate
  // multipliers frob_w^{+-2} / frob_w^{+-3} (sign by twist type)
  Fp2E b2_3, psi_cx, psi_cy;
};

static inline void f2_add(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) {
  fp_add(c.m, a.c0, b.c0, o.c0);
  fp_add(c.m, a.c1, b.c1, o.c1);
}
static inline void f2_sub(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) {
  fp_sub(c.m, a.c0, b.c0, o.c0);
  fp_sub(c.m, a.c1, b.c1, o.c1);
}
static inline void f2_neg(const Ctx &c, const Fp2E &a, Fp2E &o) {
  fp_neg(c.m, a.c0, o.c0);
  fp_neg(c.m, a.c1, o.c1);
}
static inline void f2_conj(const Ctx &c, const Fp2E &a, Fp2E &o) {
  o.c0 = a.c0;
  fp_neg(c.m, a.c1, o.c1);
}

// o = a * k for tiny k >= 0 via an add chain (Montgomery-form linear)
static void fp_mul_small(const Mont &m, const FpE &a, u64 k, FpE &o) {
  if (k == 0) {
    fp_zero(o);
    return;
  }
  int top = 63;
  while (!((k >> top) & 1)) top--;
  FpE acc = a;
  for (int i = top - 1; i >= 0; i--) {
    fp_add(m, acc, acc, acc);
    if ((k >> i) & 1) fp_add(m, acc, a, acc);
  }
  o = acc;
}

// o = beta * a — add-chain fast path when beta is a small (+-) integer
static inline void fp_mul_beta(const Ctx &c, const FpE &a, FpE &o) {
  if (c.beta_small) {
    FpE t;
    fp_mul_small(c.m, a, c.beta_abs, t);
    if (c.beta_neg) fp_neg(c.m, t, o);
    else o = t;
    return;
  }
  fp_mul(c.m, c.beta, a, o);
}
static void f2_mul(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) {
  // (a0 b0 + beta a1 b1, a0 b1 + a1 b0)  — fields.py:71-76
  FpE t0, t1, t2, t3;
  fp_mul(c.m, a.c0, b.c0, t0);
  fp_mul(c.m, a.c1, b.c1, t1);
  fp_mul(c.m, a.c0, b.c1, t2);
  fp_mul(c.m, a.c1, b.c0, t3);
  FpE bt;
  fp_mul_beta(c, t1, bt);
  fp_add(c.m, t0, bt, o.c0);
  fp_add(c.m, t2, t3, o.c1);
}
static inline void f2_sqr(const Ctx &c, const Fp2E &a, Fp2E &o) {
  // (a0^2 + beta a1^2, 2 a0 a1) — one fewer fp_mul than f2_mul(a, a)
  FpE t0, t1, t01, bt;
  fp_mul(c.m, a.c0, a.c0, t0);
  fp_mul(c.m, a.c1, a.c1, t1);
  fp_mul(c.m, a.c0, a.c1, t01);
  fp_mul_beta(c, t1, bt);
  fp_add(c.m, t0, bt, o.c0);
  fp_add(c.m, t01, t01, o.c1);
}
static void f2_inv(const Ctx &c, const Fp2E &a, Fp2E &o) {
  // norm = a0^2 - beta a1^2; o = (a0, -a1) / norm   — fields.py:88-92
  FpE t0, t1, bt, norm, ninv;
  fp_mul(c.m, a.c0, a.c0, t0);
  fp_mul(c.m, a.c1, a.c1, t1);
  fp_mul_beta(c, t1, bt);
  fp_sub(c.m, t0, bt, norm);
  fp_inv(c.m, norm, ninv);
  fp_mul(c.m, a.c0, ninv, o.c0);
  FpE na1;
  fp_neg(c.m, a.c1, na1);
  fp_mul(c.m, na1, ninv, o.c1);
}
static inline bool f2_is_zero(const Ctx &c, const Fp2E &a) {
  return fp_is_zero(c.m, a.c0) && fp_is_zero(c.m, a.c1);
}
static inline bool f2_eq(const Ctx &c, const Fp2E &a, const Fp2E &b) {
  return fp_eq(c.m, a.c0, b.c0) && fp_eq(c.m, a.c1, b.c1);
}
static inline void f2_mul_xi(const Ctx &c, const Fp2E &a, Fp2E &o) {
  if (c.xi_small) {
    // xi = xi0 + xi1 u with tiny coefficients:
    // (xi0 a0 + beta xi1 a1, xi1 a0 + xi0 a1) via add chains only
    FpE s00, s10, s11, bt;
    fp_mul_small(c.m, a.c0, c.xi0, s00);
    fp_mul_small(c.m, a.c0, c.xi1, s10);
    fp_mul_small(c.m, a.c1, c.xi0, s11);
    if (c.beta_small) {
      fp_mul_small(c.m, a.c1, c.beta_abs * c.xi1, bt);
      if (c.beta_neg) fp_neg(c.m, bt, bt);
    } else {
      FpE s01;
      fp_mul_small(c.m, a.c1, c.xi1, s01);
      fp_mul_beta(c, s01, bt);
    }
    Fp2E out;
    fp_add(c.m, s00, bt, out.c0);
    fp_add(c.m, s10, s11, out.c1);
    o = out;
    return;
  }
  f2_mul(c, a, c.xi, o);
}
static void f2_pow(const Ctx &c, const Fp2E &a, const u64 *e, int elimbs, Fp2E &o) {
  Fp2E res;
  std::memcpy(res.c0.v, c.m.one_m, sizeof(res.c0.v));
  fp_zero(res.c1);
  int top = elimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int i = top; i >= 0; i--) {
    f2_sqr(c, res, res);
    if ((e[i / 64] >> (i % 64)) & 1) f2_mul(c, res, a, res);
  }
  o = res;
}

static void f6_add(const Ctx &c, const Fp6E &a, const Fp6E &b, Fp6E &o) {
  for (int i = 0; i < 3; i++) f2_add(c, a.c[i], b.c[i], o.c[i]);
}
static void f6_sub(const Ctx &c, const Fp6E &a, const Fp6E &b, Fp6E &o) {
  for (int i = 0; i < 3; i++) f2_sub(c, a.c[i], b.c[i], o.c[i]);
}
static void f6_neg(const Ctx &c, const Fp6E &a, Fp6E &o) {
  for (int i = 0; i < 3; i++) f2_neg(c, a.c[i], o.c[i]);
}
static void f6_mul(const Ctx &c, const Fp6E &a, const Fp6E &b, Fp6E &o) {
  // Toom/Karatsuba shape of fields.py:129-138
  Fp2E t0, t1, t2, s, u, r;
  f2_mul(c, a.c[0], b.c[0], t0);
  f2_mul(c, a.c[1], b.c[1], t1);
  f2_mul(c, a.c[2], b.c[2], t2);
  Fp2E c0, c1, c2;
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  f2_add(c, a.c[1], a.c[2], s);
  f2_add(c, b.c[1], b.c[2], u);
  f2_mul(c, s, u, r);
  f2_sub(c, r, t1, r);
  f2_sub(c, r, t2, r);
  f2_mul_xi(c, r, r);
  f2_add(c, t0, r, c0);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  f2_add(c, a.c[0], a.c[1], s);
  f2_add(c, b.c[0], b.c[1], u);
  f2_mul(c, s, u, r);
  f2_sub(c, r, t0, r);
  f2_sub(c, r, t1, r);
  Fp2E xt2;
  f2_mul_xi(c, t2, xt2);
  f2_add(c, r, xt2, c1);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  f2_add(c, a.c[0], a.c[2], s);
  f2_add(c, b.c[0], b.c[2], u);
  f2_mul(c, s, u, r);
  f2_sub(c, r, t0, r);
  f2_sub(c, r, t2, r);
  f2_add(c, r, t1, c2);
  o.c[0] = c0;
  o.c[1] = c1;
  o.c[2] = c2;
}
static void f6_mul_v(const Ctx &c, const Fp6E &a, Fp6E &o) {
  // (c0,c1,c2) -> (xi*c2, c0, c1)   — fields.py:143-145
  Fp2E x;
  f2_mul_xi(c, a.c[2], x);
  Fp2E a0 = a.c[0], a1 = a.c[1];
  o.c[0] = x;
  o.c[1] = a0;
  o.c[2] = a1;
}
static void f6_inv(const Ctx &c, const Fp6E &a, Fp6E &o) {
  // fields.py:147-156
  Fp2E c0, c1, c2, t, u;
  f2_mul(c, a.c[0], a.c[0], t);
  f2_mul(c, a.c[1], a.c[2], u);
  f2_mul_xi(c, u, u);
  f2_sub(c, t, u, c0);
  f2_mul(c, a.c[2], a.c[2], t);
  f2_mul_xi(c, t, t);
  f2_mul(c, a.c[0], a.c[1], u);
  f2_sub(c, t, u, c1);
  f2_mul(c, a.c[1], a.c[1], t);
  f2_mul(c, a.c[0], a.c[2], u);
  f2_sub(c, t, u, c2);
  Fp2E n0, n1, n2, norm, ninv;
  f2_mul(c, a.c[0], c0, n0);
  f2_mul(c, a.c[2], c1, n1);
  f2_mul(c, a.c[1], c2, n2);
  f2_add(c, n1, n2, t);
  f2_mul_xi(c, t, t);
  f2_add(c, n0, t, norm);
  f2_inv(c, norm, ninv);
  f2_mul(c, c0, ninv, o.c[0]);
  f2_mul(c, c1, ninv, o.c[1]);
  f2_mul(c, c2, ninv, o.c[2]);
}
static bool f6_is_zero(const Ctx &c, const Fp6E &a) {
  return f2_is_zero(c, a.c[0]) && f2_is_zero(c, a.c[1]) && f2_is_zero(c, a.c[2]);
}

static void f12_add(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) {
  f6_add(c, a.c[0], b.c[0], o.c[0]);
  f6_add(c, a.c[1], b.c[1], o.c[1]);
}
static void f12_sub(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) {
  f6_sub(c, a.c[0], b.c[0], o.c[0]);
  f6_sub(c, a.c[1], b.c[1], o.c[1]);
}
static void f12_neg(const Ctx &c, const Fp12E &a, Fp12E &o) {
  f6_neg(c, a.c[0], o.c[0]);
  f6_neg(c, a.c[1], o.c[1]);
}
static void f12_mul(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) {
  // Karatsuba shape of fields.py:177-186
  Fp6E t0, t1, s, u, r, vt1;
  f6_mul(c, a.c[0], b.c[0], t0);
  f6_mul(c, a.c[1], b.c[1], t1);
  f6_mul_v(c, t1, vt1);
  Fp6E c0, c1;
  f6_add(c, t0, vt1, c0);
  f6_add(c, a.c[0], a.c[1], s);
  f6_add(c, b.c[0], b.c[1], u);
  f6_mul(c, s, u, r);
  f6_sub(c, r, t0, r);
  f6_sub(c, r, t1, c1);
  o.c[0] = c0;
  o.c[1] = c1;
}
static inline void f12_sqr(const Ctx &c, const Fp12E &a, Fp12E &o) {
  // complex squaring over Fp6: (a0 + a1 w)^2 with w^2 = v:
  //   t = a0*a1;  c0 = (a0 + a1)(a0 + v*a1) - t - v*t;  c1 = 2t
  // 2 Fp6 muls instead of f12_mul's 3 — same value, fewer ops.
  Fp6E t, va1, s0, s1, r, vt;
  f6_mul(c, a.c[0], a.c[1], t);
  f6_mul_v(c, a.c[1], va1);
  f6_add(c, a.c[0], a.c[1], s0);
  f6_add(c, a.c[0], va1, s1);
  f6_mul(c, s0, s1, r);
  f6_sub(c, r, t, r);
  f6_mul_v(c, t, vt);
  f6_sub(c, r, vt, o.c[0]);
  f6_add(c, t, t, o.c[1]);
}
static inline void f12_conj(const Ctx &c, const Fp12E &a, Fp12E &o) {
  o.c[0] = a.c[0];
  f6_neg(c, a.c[1], o.c[1]);
}
static void f12_inv(const Ctx &c, const Fp12E &a, Fp12E &o) {
  Fp6E t0, t1, norm, ninv;
  f6_mul(c, a.c[0], a.c[0], t0);
  f6_mul(c, a.c[1], a.c[1], t1);
  f6_mul_v(c, t1, t1);
  f6_sub(c, t0, t1, norm);
  f6_inv(c, norm, ninv);
  f6_mul(c, a.c[0], ninv, o.c[0]);
  Fp6E t2;
  f6_mul(c, a.c[1], ninv, t2);
  f6_neg(c, t2, o.c[1]);
}
static void f12_one(const Ctx &c, Fp12E &o) {
  std::memset(&o, 0, sizeof(o));
  std::memcpy(o.c[0].c[0].c0.v, c.m.one_m, sizeof(o.c[0].c[0].c0.v));
}
static bool f12_is_zero6(const Ctx &c, const Fp12E &a) {
  return f6_is_zero(c, a.c[0]) && f6_is_zero(c, a.c[1]);
}
static bool f12_eq(const Ctx &c, const Fp12E &a, const Fp12E &b) {
  for (int i = 0; i < 2; i++)
    for (int j = 0; j < 3; j++)
      if (!f2_eq(c, a.c[i].c[j], b.c[i].c[j])) return false;
  return true;
}

// Granger-Scott squaring, valid ONLY on the cyclotomic subgroup (i.e.
// after the easy part of the final exponentiation): 9 Fp2 squarings
// instead of f12_sqr's 2 Fp6 muls.  Tower shape Fp12=Fp6[w]/(w^2-v),
// Fp6=Fp2[v]/(v^3-xi) — matches fields.py.
static void f12_cyc_sqr(const Ctx &c, const Fp12E &a, Fp12E &o) {
  const Fp2E g0 = a.c[0].c[0], g1 = a.c[0].c[1], g2 = a.c[0].c[2];
  const Fp2E h0 = a.c[1].c[0], h1 = a.c[1].c[1], h2 = a.c[1].c[2];
  Fp2E t0, t1, t2, t3, t4, t5, t6, t7, t8, s;
  f2_sqr(c, h1, t0);
  f2_sqr(c, g0, t1);
  f2_add(c, h1, g0, s);
  f2_sqr(c, s, t6);
  f2_sub(c, t6, t0, t6);
  f2_sub(c, t6, t1, t6); // 2 g0 h1
  f2_sqr(c, g2, t2);
  f2_sqr(c, h0, t3);
  f2_add(c, g2, h0, s);
  f2_sqr(c, s, t7);
  f2_sub(c, t7, t2, t7);
  f2_sub(c, t7, t3, t7); // 2 g2 h0
  f2_sqr(c, h2, t4);
  f2_sqr(c, g1, t5);
  f2_add(c, h2, g1, s);
  f2_sqr(c, s, t8);
  f2_sub(c, t8, t4, t8);
  f2_sub(c, t8, t5, t8);
  f2_mul_xi(c, t8, t8); // 2 g1 h2 xi
  f2_mul_xi(c, t0, t0);
  f2_add(c, t0, t1, t0); // g0^2 + xi h1^2
  f2_mul_xi(c, t2, t2);
  f2_add(c, t2, t3, t2); // h0^2 + xi g2^2
  f2_mul_xi(c, t4, t4);
  f2_add(c, t4, t5, t4); // g1^2 + xi h2^2
  Fp2E r;
  f2_sub(c, t0, g0, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t0, o.c[0].c[0]); // 2(t0 - g0) + t0
  f2_sub(c, t2, g1, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t2, o.c[0].c[1]);
  f2_sub(c, t4, g2, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t4, o.c[0].c[2]);
  f2_add(c, t8, h0, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t8, o.c[1].c[0]); // 2(t8 + h0) + t8
  f2_add(c, t6, h1, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t6, o.c[1].c[1]);
  f2_add(c, t7, h2, r);
  f2_add(c, r, r, r);
  f2_add(c, r, t7, o.c[1].c[2]);
}

// f^x (the curve parameter, sign included) for cyclotomic f; inverse on
// the cyclotomic subgroup is conjugation.
static void f12_pow_x_cyc(const Ctx &c, const Fp12E &a, Fp12E &o) {
  u64 e = c.x_abs;
  int top = 63;
  while (top >= 0 && !((e >> top) & 1)) top--;
  Fp12E res = a;
  for (int i = top - 1; i >= 0; i--) {
    f12_cyc_sqr(c, res, res);
    if ((e >> i) & 1) f12_mul(c, res, a, res);
  }
  if (c.x_neg) f12_conj(c, res, o);
  else o = res;
}

static void f6_frob(const Ctx &c, const Fp6E &a, Fp6E &o) {
  // fields.py:217-225
  Fp2E g2;
  f2_sqr(c, c.frob_v, g2);
  Fp2E t;
  f2_conj(c, a.c[0], o.c[0]);
  f2_conj(c, a.c[1], t);
  f2_mul(c, t, c.frob_v, o.c[1]);
  f2_conj(c, a.c[2], t);
  f2_mul(c, t, g2, o.c[2]);
}
static void f12_frob1(const Ctx &c, const Fp12E &a, Fp12E &o) {
  Fp6E a0, a1;
  f6_frob(c, a.c[0], a0);
  f6_frob(c, a.c[1], a1);
  for (int i = 0; i < 3; i++) f2_mul(c, a1.c[i], c.frob_w, a1.c[i]);
  o.c[0] = a0;
  o.c[1] = a1;
}
static void f12_frob(const Ctx &c, const Fp12E &a, int n, Fp12E &o) {
  Fp12E t = a;
  for (int i = 0; i < n % 12; i++) f12_frob1(c, t, t);
  o = t;
}

// o = a^e, e given as plain limbs (non-negative)
static void f12_pow(const Ctx &c, const Fp12E &a, const u64 *e, int elimbs, Fp12E &o) {
  Fp12E res;
  f12_one(c, res);
  int top = elimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int i = top; i >= 0; i--) {
    f12_sqr(c, res, res);
    if ((e[i / 64] >> (i % 64)) & 1) f12_mul(c, res, a, res);
  }
  o = res;
}

// ---------------------------------------------------------------------------
// Generic curve law (affine + Jacobian), templated over the field
// ---------------------------------------------------------------------------

template <class E> struct FOps;

template <> struct FOps<FpE> {
  static void add(const Ctx &c, const FpE &a, const FpE &b, FpE &o) { fp_add(c.m, a, b, o); }
  static void sub(const Ctx &c, const FpE &a, const FpE &b, FpE &o) { fp_sub(c.m, a, b, o); }
  static void mul(const Ctx &c, const FpE &a, const FpE &b, FpE &o) { fp_mul(c.m, a, b, o); }
  static void neg(const Ctx &c, const FpE &a, FpE &o) { fp_neg(c.m, a, o); }
  static void inv(const Ctx &c, const FpE &a, FpE &o) { fp_inv(c.m, a, o); }
  static bool is_zero(const Ctx &c, const FpE &a) { return fp_is_zero(c.m, a); }
  static bool eq(const Ctx &c, const FpE &a, const FpE &b) { return fp_eq(c.m, a, b); }
  static void one(const Ctx &c, FpE &o) { std::memcpy(o.v, c.m.one_m, sizeof(o.v)); }
  static void zero(const Ctx &, FpE &o) { fp_zero(o); }
};

template <> struct FOps<Fp2E> {
  static void add(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) { f2_add(c, a, b, o); }
  static void sub(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) { f2_sub(c, a, b, o); }
  static void mul(const Ctx &c, const Fp2E &a, const Fp2E &b, Fp2E &o) { f2_mul(c, a, b, o); }
  static void neg(const Ctx &c, const Fp2E &a, Fp2E &o) { f2_neg(c, a, o); }
  static void inv(const Ctx &c, const Fp2E &a, Fp2E &o) { f2_inv(c, a, o); }
  static bool is_zero(const Ctx &c, const Fp2E &a) { return f2_is_zero(c, a); }
  static bool eq(const Ctx &c, const Fp2E &a, const Fp2E &b) { return f2_eq(c, a, b); }
  static void one(const Ctx &c, Fp2E &o) {
    std::memcpy(o.c0.v, c.m.one_m, sizeof(o.c0.v));
    fp_zero(o.c1);
  }
  static void zero(const Ctx &, Fp2E &o) { std::memset(&o, 0, sizeof(o)); }
};

template <> struct FOps<Fp12E> {
  static void add(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) { f12_add(c, a, b, o); }
  static void sub(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) { f12_sub(c, a, b, o); }
  static void mul(const Ctx &c, const Fp12E &a, const Fp12E &b, Fp12E &o) { f12_mul(c, a, b, o); }
  static void neg(const Ctx &c, const Fp12E &a, Fp12E &o) { f12_neg(c, a, o); }
  static void inv(const Ctx &c, const Fp12E &a, Fp12E &o) { f12_inv(c, a, o); }
  static bool is_zero(const Ctx &c, const Fp12E &a) { return f12_is_zero6(c, a); }
  static bool eq(const Ctx &c, const Fp12E &a, const Fp12E &b) { return f12_eq(c, a, b); }
  static void one(const Ctx &c, Fp12E &o) { f12_one(c, o); }
  static void zero(const Ctx &, Fp12E &o) { std::memset(&o, 0, sizeof(o)); }
};

template <class E> struct Aff {
  E x, y;
  bool inf;
};

template <class E> struct Jac {
  E X, Y, Z; // Z == 0 encodes infinity
};

// Affine add/double, mirroring host/curve.py (branches and all); a = 0.
template <class E>
static Aff<E> aff_double(const Ctx &c, const Aff<E> &P) {
  using F = FOps<E>;
  Aff<E> o;
  if (P.inf || F::is_zero(c, P.y)) {
    o.inf = true;
    return o;
  }
  E x2, num, den, lam, t;
  F::mul(c, P.x, P.x, x2);
  E three, two, one;
  F::one(c, one);
  F::add(c, one, one, two);
  F::add(c, two, one, three);
  F::mul(c, three, x2, num);
  F::mul(c, two, P.y, den);
  F::inv(c, den, den);
  F::mul(c, num, den, lam);
  E x3, y3;
  F::mul(c, lam, lam, x3);
  F::sub(c, x3, P.x, x3);
  F::sub(c, x3, P.x, x3);
  F::sub(c, P.x, x3, t);
  F::mul(c, lam, t, y3);
  F::sub(c, y3, P.y, y3);
  o.x = x3;
  o.y = y3;
  o.inf = false;
  return o;
}

template <class E>
static Aff<E> aff_add(const Ctx &c, const Aff<E> &P, const Aff<E> &Q) {
  using F = FOps<E>;
  if (P.inf) return Q;
  if (Q.inf) return P;
  E dx;
  F::sub(c, P.x, Q.x, dx);
  if (F::is_zero(c, dx)) {
    E sy;
    F::add(c, P.y, Q.y, sy);
    if (F::is_zero(c, sy)) {
      Aff<E> o;
      o.inf = true;
      return o;
    }
    return aff_double<E>(c, P);
  }
  E num, den, lam, t;
  F::sub(c, Q.y, P.y, num);
  F::sub(c, Q.x, P.x, den);
  F::inv(c, den, den);
  F::mul(c, num, den, lam);
  E x3, y3;
  F::mul(c, lam, lam, x3);
  F::sub(c, x3, P.x, x3);
  F::sub(c, x3, Q.x, x3);
  F::sub(c, P.x, x3, t);
  F::mul(c, lam, t, y3);
  F::sub(c, y3, P.y, y3);
  Aff<E> o;
  o.x = x3;
  o.y = y3;
  o.inf = false;
  return o;
}

// Jacobian ops (a=0) for scalar mul / MSM — no inversions in the loop.
template <class E> static void jac_inf(const Ctx &c, Jac<E> &o) {
  FOps<E>::one(c, o.X);
  FOps<E>::one(c, o.Y);
  FOps<E>::zero(c, o.Z);
}
template <class E> static bool jac_is_inf(const Ctx &c, const Jac<E> &P) {
  return FOps<E>::is_zero(c, P.Z);
}
template <class E> static Jac<E> from_aff(const Ctx &c, const Aff<E> &P) {
  Jac<E> o;
  if (P.inf) {
    jac_inf<E>(c, o);
    return o;
  }
  o.X = P.x;
  o.Y = P.y;
  FOps<E>::one(c, o.Z);
  return o;
}
template <class E> static Aff<E> to_aff(const Ctx &c, const Jac<E> &P) {
  using F = FOps<E>;
  Aff<E> o;
  if (jac_is_inf<E>(c, P)) {
    o.inf = true;
    return o;
  }
  E zi, zi2, zi3;
  F::inv(c, P.Z, zi);
  F::mul(c, zi, zi, zi2);
  F::mul(c, zi2, zi, zi3);
  F::mul(c, P.X, zi2, o.x);
  F::mul(c, P.Y, zi3, o.y);
  o.inf = false;
  return o;
}

template <class E> static Jac<E> jac_double(const Ctx &c, const Jac<E> &P) {
  using F = FOps<E>;
  if (jac_is_inf<E>(c, P)) return P;
  if (F::is_zero(c, P.Y)) {
    Jac<E> o;
    jac_inf<E>(c, o);
    return o;
  }
  E A, B, C2, D, Ee, Ff, t;
  F::mul(c, P.X, P.X, A);
  F::mul(c, P.Y, P.Y, B);
  F::mul(c, B, B, C2);
  // D = 2((X+B)^2 - A - C)
  F::add(c, P.X, B, t);
  F::mul(c, t, t, D);
  F::sub(c, D, A, D);
  F::sub(c, D, C2, D);
  F::add(c, D, D, D);
  // E = 3A, F = E^2
  F::add(c, A, A, Ee);
  F::add(c, Ee, A, Ee);
  F::mul(c, Ee, Ee, Ff);
  Jac<E> o;
  // X3 = F - 2D
  F::sub(c, Ff, D, o.X);
  F::sub(c, o.X, D, o.X);
  // Y3 = E(D - X3) - 8C
  F::sub(c, D, o.X, t);
  F::mul(c, Ee, t, o.Y);
  E c8;
  F::add(c, C2, C2, c8);
  F::add(c, c8, c8, c8);
  F::add(c, c8, c8, c8);
  F::sub(c, o.Y, c8, o.Y);
  // Z3 = 2 Y Z
  F::mul(c, P.Y, P.Z, o.Z);
  F::add(c, o.Z, o.Z, o.Z);
  return o;
}

template <class E> static Jac<E> jac_add(const Ctx &c, const Jac<E> &P, const Jac<E> &Q) {
  using F = FOps<E>;
  if (jac_is_inf<E>(c, P)) return Q;
  if (jac_is_inf<E>(c, Q)) return P;
  E Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  F::mul(c, P.Z, P.Z, Z1Z1);
  F::mul(c, Q.Z, Q.Z, Z2Z2);
  F::mul(c, P.X, Z2Z2, U1);
  F::mul(c, Q.X, Z1Z1, U2);
  F::mul(c, Q.Z, Z2Z2, t);
  F::mul(c, P.Y, t, S1);
  F::mul(c, P.Z, Z1Z1, t);
  F::mul(c, Q.Y, t, S2);
  E H, R;
  F::sub(c, U2, U1, H);
  F::sub(c, S2, S1, R);
  if (F::is_zero(c, H)) {
    if (F::is_zero(c, R)) return jac_double<E>(c, P);
    Jac<E> o;
    jac_inf<E>(c, o);
    return o;
  }
  E I, J, V;
  F::add(c, H, H, t);
  F::mul(c, t, t, I); // (2H)^2
  F::mul(c, H, I, J);
  F::add(c, R, R, R); // r = 2(S2 - S1)
  F::mul(c, U1, I, V);
  Jac<E> o;
  // X3 = r^2 - J - 2V
  F::mul(c, R, R, o.X);
  F::sub(c, o.X, J, o.X);
  F::sub(c, o.X, V, o.X);
  F::sub(c, o.X, V, o.X);
  // Y3 = r(V - X3) - 2 S1 J
  F::sub(c, V, o.X, t);
  F::mul(c, R, t, o.Y);
  E s1j;
  F::mul(c, S1, J, s1j);
  F::add(c, s1j, s1j, s1j);
  F::sub(c, o.Y, s1j, o.Y);
  // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H
  F::add(c, P.Z, Q.Z, t);
  F::mul(c, t, t, o.Z);
  F::sub(c, o.Z, Z1Z1, o.Z);
  F::sub(c, o.Z, Z2Z2, o.Z);
  F::mul(c, o.Z, H, o.Z);
  return o;
}

// mixed add: Q affine (Z2 = 1) — 8M+3S instead of jac_add's 12M+4S
template <class E>
static Jac<E> jac_madd(const Ctx &c, const Jac<E> &P, const Aff<E> &Q) {
  using F = FOps<E>;
  if (Q.inf) return P;
  if (jac_is_inf<E>(c, P)) return from_aff<E>(c, Q);
  E Z1Z1, U2, S2, t;
  F::mul(c, P.Z, P.Z, Z1Z1);
  F::mul(c, Q.x, Z1Z1, U2);
  F::mul(c, P.Z, Z1Z1, t);
  F::mul(c, Q.y, t, S2);
  E H, R;
  F::sub(c, U2, P.X, H);
  F::sub(c, S2, P.Y, R);
  if (F::is_zero(c, H)) {
    if (F::is_zero(c, R)) return jac_double<E>(c, P);
    Jac<E> o;
    jac_inf<E>(c, o);
    return o;
  }
  E I, J, V;
  F::add(c, H, H, t);
  F::mul(c, t, t, I); // (2H)^2
  F::mul(c, H, I, J);
  F::add(c, R, R, R); // r = 2(S2 - S1)
  F::mul(c, P.X, I, V);
  Jac<E> o;
  F::mul(c, R, R, o.X);
  F::sub(c, o.X, J, o.X);
  F::sub(c, o.X, V, o.X);
  F::sub(c, o.X, V, o.X);
  F::sub(c, V, o.X, t);
  F::mul(c, R, t, o.Y);
  E s1j;
  F::mul(c, P.Y, J, s1j);
  F::add(c, s1j, s1j, s1j);
  F::sub(c, o.Y, s1j, o.Y);
  // Z3 = (Z1 + H)^2 - Z1Z1 - H^2
  F::add(c, P.Z, H, t);
  F::mul(c, t, t, o.Z);
  F::sub(c, o.Z, Z1Z1, o.Z);
  E HH;
  F::mul(c, H, H, HH);
  F::sub(c, o.Z, HH, o.Z);
  return o;
}

// scalar given as little-endian bytes
template <class E>
static Jac<E> jac_mul(const Ctx &c, const Aff<E> &P, const uint8_t *k, int klen) {
  Jac<E> R;
  jac_inf<E>(c, R);
  if (P.inf) return R;
  int top = klen * 8 - 1;
  while (top >= 0 && !((k[top / 8] >> (top % 8)) & 1)) top--;
  for (int i = top; i >= 0; i--) {
    R = jac_double<E>(c, R);
    if ((k[i / 8] >> (i % 8)) & 1) R = jac_madd<E>(c, R, P);
  }
  return R;
}

// Pippenger MSM over affine inputs; scalars n x klen LE bytes.
template <class E>
static Aff<E> msm_pippenger(const Ctx &c, int64_t n, const Aff<E> *pts,
                            const uint8_t *ks, int klen) {
  int cbits = 4;
  if (n >= 32) cbits = 8;
  if (n >= 1 << 13) cbits = 12;
  int nbits = klen * 8;
  int nwin = (nbits + cbits - 1) / cbits;
  int B = 1 << cbits;
  std::vector<Jac<E>> buckets(B);
  Jac<E> acc;
  jac_inf<E>(c, acc);
  for (int w = nwin - 1; w >= 0; w--) {
    for (int d = 0; d < cbits; d++) acc = jac_double<E>(c, acc);
    for (int b = 0; b < B; b++) jac_inf<E>(c, buckets[b]);
    for (int64_t i = 0; i < n; i++) {
      // extract window digit w of scalar i
      int bit0 = w * cbits;
      u64 digit = 0;
      for (int j = 0; j < cbits; j++) {
        int bit = bit0 + j;
        if (bit < nbits && ((ks[i * klen + bit / 8] >> (bit % 8)) & 1))
          digit |= (u64)1 << j;
      }
      if (digit) buckets[digit] = jac_madd<E>(c, buckets[digit], pts[i]);
    }
    Jac<E> run, sum;
    jac_inf<E>(c, run);
    jac_inf<E>(c, sum);
    for (int b = B - 1; b >= 1; b--) {
      run = jac_add<E>(c, run, buckets[b]);
      sum = jac_add<E>(c, sum, run);
    }
    acc = jac_add<E>(c, acc, sum);
  }
  return to_aff<E>(c, acc);
}

// ---------------------------------------------------------------------------
// Pairing (mirror host/engine.py)
// ---------------------------------------------------------------------------

// ---- sparse projective Miller loop ----------------------------------------
//
// Works on the twist E'(Fp2) directly (no Fp12 embedding, no inversions):
// T is homogeneous projective (x = X/Z, y = Y/Z); every line is scaled by
// a per-step Fp2 factor, which the final exponentiation kills (subfield
// elements f satisfy f^{p^2-1} = 1 and p^2-1 | (p^6-1)(p^2+1)).  The
// Miller value therefore differs from the textbook host engine's
// PRE-final-exp value, but final_exp(miller) is identical — the pairing
// contract (SURVEY.md appendix: output only well-defined after FExp).
//
// Line slots in the tower (Fp12 = c0 + c1 w; c_i = s0 + s1 v + s2 v^2):
//   D-type (x_hat = x w^2):  A at c0.s0, w^1 at c1.s0, w^3 at c1.s1
//   M-type (x_hat = x/w^2):  A at c0.s0, w^3 at c1.s1, w^5 at c1.s2
//     (M-type line additionally scaled by xi to clear w^{-6} powers)

struct Proj2 {
  Fp2E X, Y, Z;
};

// y^2 z = x^3 + b2 z^3 doubling — RCB 2015/1060 Alg 9 (a=0), mirroring
// ops/weier.py:87-103.
static void twist_dbl(const Ctx &c, const Proj2 &P, Proj2 &o) {
  Fp2E t0, t1, t2, xy, z3t, t2b, y3t, t2_3, t0m, x3a, Z3, y3m, x3m;
  f2_sqr(c, P.Y, t0);
  f2_mul(c, P.Y, P.Z, t1);
  f2_sqr(c, P.Z, t2);
  f2_mul(c, P.X, P.Y, xy);
  f2_add(c, t0, t0, z3t);
  f2_add(c, z3t, z3t, z3t);
  f2_add(c, z3t, z3t, z3t); // 8 Y^2
  f2_mul(c, c.b2_3, t2, t2b);
  f2_add(c, t0, t2b, y3t);
  f2_add(c, t2b, t2b, t2_3);
  f2_add(c, t2_3, t2b, t2_3);
  f2_sub(c, t0, t2_3, t0m);
  f2_mul(c, t2b, z3t, x3a);
  f2_mul(c, t1, z3t, Z3);
  f2_mul(c, t0m, y3t, y3m);
  f2_mul(c, t0m, xy, x3m);
  f2_add(c, x3m, x3m, o.X);
  f2_add(c, x3a, y3m, o.Y);
  o.Z = Z3;
}

// RCB Alg 7 complete add (a=0), Q affine (Z2 = 1) — ops/weier.py:61-84.
static void twist_add_aff(const Ctx &c, const Proj2 &P, const Fp2E &X2,
                          const Fp2E &Y2, Proj2 &o) {
  Fp2E one2;
  FOps<Fp2E>::one(c, one2);
  Fp2E xy1, xy2, yz1, yz2, xz1, xz2;
  f2_add(c, P.X, P.Y, xy1);
  f2_add(c, X2, Y2, xy2);
  f2_add(c, P.Y, P.Z, yz1);
  f2_add(c, Y2, one2, yz2);
  f2_add(c, P.X, P.Z, xz1);
  f2_add(c, X2, one2, xz2);
  Fp2E t0, t1, t2, a3, a4, a5;
  f2_mul(c, P.X, X2, t0);
  f2_mul(c, P.Y, Y2, t1);
  t2 = P.Z; // Z1 * 1
  f2_mul(c, xy1, xy2, a3);
  f2_mul(c, yz1, yz2, a4);
  f2_mul(c, xz1, xz2, a5);
  Fp2E u, t3, t4, ln;
  f2_add(c, t0, t1, u);
  f2_sub(c, a3, u, t3);
  f2_add(c, t1, t2, u);
  f2_sub(c, a4, u, t4);
  f2_add(c, t0, t2, u);
  f2_sub(c, a5, u, ln);
  Fp2E t0_3, t2b, lnb, z3t, t1m;
  f2_add(c, t0, t0, t0_3);
  f2_add(c, t0_3, t0, t0_3);
  f2_mul(c, c.b2_3, t2, t2b);
  f2_mul(c, c.b2_3, ln, lnb);
  f2_add(c, t1, t2b, z3t);
  f2_sub(c, t1, t2b, t1m);
  Fp2E x3a, x3b, y3a, y3b, z3a, z3b;
  f2_mul(c, t4, lnb, x3a);
  f2_mul(c, t3, t1m, x3b);
  f2_mul(c, lnb, t0_3, y3a);
  f2_mul(c, t1m, z3t, y3b);
  f2_mul(c, t0_3, t3, z3a);
  f2_mul(c, z3t, t4, z3b);
  f2_sub(c, x3b, x3a, o.X);
  f2_add(c, y3b, y3a, o.Y);
  f2_add(c, z3b, z3a, o.Z);
}

// scale an Fp2 by an Fp scalar (2 fp_muls)
static inline void f2_scale(const Ctx &c, const Fp2E &a, const FpE &s, Fp2E &o) {
  fp_mul(c.m, a.c0, s, o.c0);
  fp_mul(c.m, a.c1, s, o.c1);
}

// place line coefficients (A, w1or5, w3) into a sparse Fp12
static void line_to_f12(const Ctx &c, const Fp2E &A, const Fp2E &Bw3,
                        const Fp2E &Cw, Fp12E &o) {
  std::memset(&o, 0, sizeof(o));
  if (c.twist == 0) { // M-type: A (xi-scaled by caller), w^3, w^5
    f2_mul_xi(c, A, o.c[0].c[0]);
    o.c[1].c[1] = Bw3;
    o.c[1].c[2] = Cw;
  } else { // D-type: A, w^1, w^3
    o.c[0].c[0] = A;
    o.c[1].c[0] = Cw;
    o.c[1].c[1] = Bw3;
  }
}

// Fp6 schoolbook multiply skipping zero slots of b (for sparse lines):
//   c_k = sum_{i+j = k (mod 3)} a_i b_j, with a v-wrap multiplying by xi
static void f6_mul_sparse(const Ctx &c, const Fp6E &a, const Fp6E &b, Fp6E &o) {
  Fp2E acc, m;
  bool bz[3];
  for (int j = 0; j < 3; j++) bz[j] = f2_is_zero(c, b.c[j]);
  Fp6E out;
  for (int k = 0; k < 3; k++) {
    FOps<Fp2E>::zero(c, acc);
    for (int i = 0; i < 3; i++) {
      int j = k - i;
      bool wrap = j < 0;
      if (wrap) j += 3;
      if (bz[j]) continue;
      f2_mul(c, a.c[i], b.c[j], m);
      if (wrap) f2_mul_xi(c, m, m);
      f2_add(c, acc, m, acc);
    }
    out.c[k] = acc;
  }
  o = out;
}

// f <- f * line, exploiting the 3-of-12 sparsity of the line element:
// line = a0 + a1 w with a0 = (A,0,0) and a1 two-slot.  Karatsuba over
// Fp6 with sparse operands: 3 + 6 + 9 Fp2 muls instead of 18.
static void f12_mul_line(const Ctx &c, Fp12E &f, const Fp12E &ln) {
  Fp6E t0, t1, r, vt1;
  // t0 = f.c0 * (A,0,0)
  for (int j = 0; j < 3; j++) f2_mul(c, f.c[0].c[j], ln.c[0].c[0], t0.c[j]);
  f6_mul_sparse(c, f.c[1], ln.c[1], t1); // a1: at most two nonzero slots
  f6_mul_v(c, t1, vt1);
  // c1 = (f0 + f1)(a0 + a1) - t0 - t1 : a0+a1 has at most 3 nonzero slots
  Fp6E fsum, asum;
  f6_add(c, f.c[0], f.c[1], fsum);
  f6_add(c, ln.c[0], ln.c[1], asum);
  f6_mul_sparse(c, fsum, asum, r);
  f6_sub(c, r, t0, r);
  f6_sub(c, r, t1, r);
  f6_add(c, t0, vt1, f.c[0]);
  f.c[1] = r;
}

// psi endomorphism on affine twist coordinates:
// psi(x, y) = (conj(x) * frob_w^{a}, conj(y) * frob_w^{b}),
// (a, b) = embedding powers (+-2, +-3) — equals the untwist-Frobenius-
// retwist map the host applies in embedded form (engine.py:146-151).
static void psi_aff(const Ctx &c, const Fp2E &x, const Fp2E &y, Fp2E &ox,
                    Fp2E &oy) {
  Fp2E t;
  f2_conj(c, x, t);
  f2_mul(c, t, c.psi_cx, ox);
  f2_conj(c, y, t);
  f2_mul(c, t, c.psi_cy, oy);
}

// line through projective T and (for add steps) affine Q, evaluated at P,
// Fp2-scaled; appended to f.
static void miller_dbl_line(const Ctx &c, Fp12E &f, Proj2 &T, const FpE &xP,
                            const FpE &yP) {
  // A = 2 Y Z^2 yP ; w-slot = -3 X^2 Z xP ; w3 = 3 X^3 - 2 Y^2 Z
  Fp2E ZZ, YZZ, A, XX, XXZ, Cw, XXX, YY, YYZ, B, t;
  f2_sqr(c, T.Z, ZZ);
  f2_mul(c, T.Y, ZZ, YZZ);
  f2_add(c, YZZ, YZZ, t);
  f2_scale(c, t, yP, A);
  f2_sqr(c, T.X, XX);
  f2_mul(c, XX, T.Z, XXZ);
  f2_add(c, XXZ, XXZ, t);
  f2_add(c, t, XXZ, t); // 3 X^2 Z
  f2_scale(c, t, xP, Cw);
  f2_neg(c, Cw, Cw);
  f2_mul(c, XX, T.X, XXX);
  f2_add(c, XXX, XXX, B);
  f2_add(c, B, XXX, B); // 3 X^3
  f2_sqr(c, T.Y, YY);
  f2_mul(c, YY, T.Z, YYZ);
  f2_add(c, YYZ, YYZ, t);
  f2_sub(c, B, t, B); // 3 X^3 - 2 Y^2 Z
  Fp12E ln;
  line_to_f12(c, A, B, Cw, ln);
  f12_sqr(c, f, f);
  f12_mul_line(c, f, ln);
  Proj2 T2;
  twist_dbl(c, T, T2);
  T = T2;
}

static void miller_add_line(const Ctx &c, Fp12E &f, Proj2 &T, const Fp2E &x2,
                            const Fp2E &y2, const FpE &xP, const FpE &yP) {
  // E = y2 Z - Y ; F = x2 Z - X
  // A = F yP ; w-slot = -E xP ; w3 = E x2 - F y2
  Fp2E E, F, A, Cw, B, t, u;
  f2_mul(c, y2, T.Z, E);
  f2_sub(c, E, T.Y, E);
  f2_mul(c, x2, T.Z, F);
  f2_sub(c, F, T.X, F);
  f2_scale(c, F, yP, A);
  f2_scale(c, E, xP, Cw);
  f2_neg(c, Cw, Cw);
  f2_mul(c, E, x2, t);
  f2_mul(c, F, y2, u);
  f2_sub(c, t, u, B);
  Fp12E ln;
  line_to_f12(c, A, B, Cw, ln);
  f12_mul_line(c, f, ln);
  Proj2 T2;
  twist_add_aff(c, T, x2, y2, T2);
  T = T2;
}

static void miller_single(const Ctx &c, const Aff<FpE> &P, const Aff<Fp2E> &Q,
                          Fp12E &out) {
  if (P.inf || Q.inf) {
    f12_one(c, out);
    return;
  }
  // loop count: BLS12 -> |x|; BN -> |6x + 2| (can exceed 64 bits)
  u128 cnt;
  int m_neg;
  if (c.family == 0) {
    cnt = c.x_abs;
    m_neg = c.x_neg;
  } else {
    __int128 x = (__int128)c.x_abs * (c.x_neg ? -1 : 1);
    __int128 mm = 6 * x + 2;
    m_neg = mm < 0;
    cnt = (u128)(m_neg ? -mm : mm);
  }

  Fp12E f;
  f12_one(c, f);
  Proj2 T;
  T.X = Q.x;
  T.Y = Q.y;
  FOps<Fp2E>::one(c, T.Z);
  int top = 127;
  while (top >= 0 && !((cnt >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    miller_dbl_line(c, f, T, P.x, P.y);
    if ((cnt >> i) & 1) miller_add_line(c, f, T, Q.x, Q.y, P.x, P.y);
  }

  if (c.family == 0) {
    if (m_neg) f12_conj(c, f, f);
    out = f;
    return;
  }
  // BN: extra Frobenius lines (optimal ate): T += psi(Q), T += -psi^2(Q)
  if (m_neg) {
    f12_conj(c, f, f);
    f2_neg(c, T.Y, T.Y);
  }
  Fp2E q1x, q1y, q2x, q2y;
  psi_aff(c, Q.x, Q.y, q1x, q1y);
  psi_aff(c, q1x, q1y, q2x, q2y);
  f2_neg(c, q2y, q2y);
  miller_add_line(c, f, T, q1x, q1y, P.x, P.y);
  miller_add_line(c, f, T, q2x, q2y, P.x, P.y);
  out = f;
}

static void final_exp(const Ctx &c, const Fp12E &fin, Fp12E &out) {
  // easy part: t = conj(f) * inv(f); f = frob^2(t) * t
  Fp12E t, fi, f;
  f12_inv(c, fin, fi);
  f12_conj(c, fin, t);
  f12_mul(c, t, fi, t);
  f12_frob(c, t, 2, f);
  f12_mul(c, f, t, f);
  if (c.family == 0) {
    // BLS12 hard part via the Hayashida-Hayasaka-Teruya decomposition
    // (matches fexp_factor = 3, see params.py):
    //   3 (p^4 - p^2 + 1)/r = (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3
    // 5 x-pows with cyclotomic squarings; cyclotomic inverse = conj.
    Fp12E u, m1, m2, m3, r2;
    // m1 = (f^(x-1))^(x-1)
    f12_pow_x_cyc(c, f, u);
    f12_conj(c, f, t);
    f12_mul(c, u, t, u); // f^(x-1)
    f12_pow_x_cyc(c, u, m1);
    f12_conj(c, u, t);
    f12_mul(c, m1, t, m1);
    // m2 = m1^x * frob(m1)
    f12_pow_x_cyc(c, m1, m2);
    f12_frob1(c, m1, t);
    f12_mul(c, m2, t, m2);
    // m3 = m2^(x^2) * frob^2(m2) * conj(m2)
    f12_pow_x_cyc(c, m2, m3);
    f12_pow_x_cyc(c, m3, m3);
    f12_frob(c, m2, 2, t);
    f12_mul(c, m3, t, m3);
    f12_conj(c, m2, t);
    f12_mul(c, m3, t, m3);
    // out = m3 * f^3
    f12_cyc_sqr(c, f, r2);
    f12_mul(c, r2, f, r2);
    f12_mul(c, m3, r2, out);
    return;
  }
  // BN / FP256BN hard part: multi-exp over frobenius powers with base-p
  // digits (shared squarings are cyclotomic).
  int n = c.ndigits;
  std::vector<Fp12E> bases(n);
  bases[0] = f;
  for (int i = 1; i < n; i++) f12_frob1(c, bases[i - 1], bases[i]);
  // subset-product table
  std::vector<Fp12E> table(1 << n);
  f12_one(c, table[0]);
  for (int i = 0; i < n; i++) {
    int bit = 1 << i;
    for (int s = 0; s < bit; s++) f12_mul(c, table[s], bases[i], table[s | bit]);
  }
  // max bit length over digits
  int L = c.m.L;
  int nbits = 0;
  for (int j = 0; j < n; j++) {
    for (int bi = L * 64 - 1; bi >= 0; bi--) {
      if ((c.hard_digits_plain[j].v[bi / 64] >> (bi % 64)) & 1) {
        if (bi + 1 > nbits) nbits = bi + 1;
        break;
      }
    }
  }
  Fp12E res;
  f12_one(c, res);
  for (int i = nbits - 1; i >= 0; i--) {
    f12_cyc_sqr(c, res, res);
    int idx = 0;
    for (int j = 0; j < n; j++)
      if ((c.hard_digits_plain[j].v[i / 64] >> (i % 64)) & 1) idx |= 1 << j;
    if (idx) f12_mul(c, res, table[idx], res);
  }
  out = res;
}

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

static std::vector<Ctx *> g_ctxs;
static std::mutex g_mu;

static inline u64 rd_u64(const uint8_t *&p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  p += 8;
  return v;
}
static inline uint32_t rd_u32(const uint8_t *&p) {
  uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
               ((uint32_t)p[3] << 24);
  p += 4;
  return v;
}

extern "C" {

// cfg layout (little-endian):
//   u32 L, u32 family, u32 twist, u32 x_neg, u64 x_abs,
//   fp p, fp beta, fp2 xi, fp b, fp2 b2, fp2 frob_v, fp2 frob_w,
//   u32 ndigits, ndigits * fp hard_digits        (fp = 8L plain LE bytes)
// frob_v/frob_w/beta/xi/b/b2 are plain (non-Montgomery) canonical values.
int32_t mlt_ctx_new(const uint8_t *cfg, int64_t len) {
  const uint8_t *q = cfg;
  uint32_t L = rd_u32(q);
  if (L > (uint32_t)MAXL) return -1;
  Ctx *c = new Ctx();
  c->family = (int)rd_u32(q);
  c->twist = (int)rd_u32(q);
  c->x_neg = (int)rd_u32(q);
  c->x_abs = rd_u64(q);
  u64 p[MAXL] = {0};
  for (uint32_t i = 0; i < L; i++) p[i] = rd_u64(q);
  mont_init(c->m, p, (int)L);
  int fb = 8 * (int)L;
  // detect tiny beta / xi from the PLAIN cfg values for the add-chain
  // fast paths (beta is canonical mod p, so -1 arrives as p-1 etc.)
  auto plain_small = [&](const uint8_t *b, u64 *out) -> bool {
    u64 v = 0;
    for (int i = 7; i >= 0; i--) v = (v << 8) | b[i];
    for (int i = 8; i < fb; i++)
      if (b[i]) return false;
    if (v >= 64) return false;
    *out = v;
    return true;
  };
  auto plain_small_signed = [&](const uint8_t *b, u64 *mag, int *neg) -> bool {
    if (plain_small(b, mag)) {
      *neg = 0;
      return true;
    }
    // p - value small?  compute p - v limb-wise
    u64 vl[MAXL], d[MAXL];
    for (uint32_t i = 0; i < L; i++) {
      u64 w = 0;
      for (int j = 7; j >= 0; j--) w = (w << 8) | b[8 * i + j];
      vl[i] = w;
    }
    sub_n(d, c->m.p, vl, (int)L);
    for (uint32_t i = 1; i < L; i++)
      if (d[i]) return false;
    if (d[0] >= 64) return false;
    *mag = d[0];
    *neg = 1;
    return true;
  };
  c->beta_small = plain_small_signed(q, &c->beta_abs, &c->beta_neg) ? 1 : 0;
  fp_from_bytes(c->m, q, c->beta);
  q += fb;
  u64 x0 = 0, x1 = 0;
  int xs0 = plain_small(q, &x0);
  fp_from_bytes(c->m, q, c->xi.c0);
  q += fb;
  int xs1 = plain_small(q, &x1);
  fp_from_bytes(c->m, q, c->xi.c1);
  q += fb;
  c->xi_small = (xs0 && xs1) ? 1 : 0;
  c->xi0 = x0;
  c->xi1 = x1;
  fp_from_bytes(c->m, q, c->b);
  q += fb;
  fp_from_bytes(c->m, q, c->b2.c0);
  q += fb;
  fp_from_bytes(c->m, q, c->b2.c1);
  q += fb;
  fp_from_bytes(c->m, q, c->frob_v.c0);
  q += fb;
  fp_from_bytes(c->m, q, c->frob_v.c1);
  q += fb;
  fp_from_bytes(c->m, q, c->frob_w.c0);
  q += fb;
  fp_from_bytes(c->m, q, c->frob_w.c1);
  q += fb;
  uint32_t nd = rd_u32(q);
  c->ndigits = (int)nd;
  c->hard_digits_plain.resize(nd);
  for (uint32_t j = 0; j < nd; j++) {
    FpE d;
    fp_zero(d);
    for (uint32_t i = 0; i < L; i++) d.v[i] = rd_u64(q);
    c->hard_digits_plain[j] = d; // PLAIN limbs (exponent), no Montgomery
  }
  (void)len;
  // sparse-Miller constants
  f2_add(*c, c->b2, c->b2, c->b2_3);
  f2_add(*c, c->b2_3, c->b2, c->b2_3);
  Fp2E fw2, fw3;
  f2_sqr(*c, c->frob_w, fw2);
  f2_mul(*c, fw2, c->frob_w, fw3);
  if (c->twist == 0) { // M-type embedding powers are w^{-2}, w^{-3}
    f2_inv(*c, fw2, c->psi_cx);
    f2_inv(*c, fw3, c->psi_cy);
  } else {
    c->psi_cx = fw2;
    c->psi_cy = fw3;
  }
  std::lock_guard<std::mutex> g(g_mu);
  g_ctxs.push_back(c);
  return (int32_t)(g_ctxs.size() - 1);
}

} // extern "C"

static inline Ctx &ctx(int32_t h) { return *g_ctxs[(size_t)h]; }

// wire: G1 point = [1B inf][fp x][fp y]; G2 = [1B inf][fp2 x][fp2 y]
static void rd_g1(const Ctx &c, const uint8_t *in, Aff<FpE> &P) {
  int fb = 8 * c.m.L;
  P.inf = in[0] != 0;
  if (P.inf) {
    fp_zero(P.x);
    fp_zero(P.y);
    return;
  }
  fp_from_bytes(c.m, in + 1, P.x);
  fp_from_bytes(c.m, in + 1 + fb, P.y);
}
static void wr_g1(const Ctx &c, const Aff<FpE> &P, uint8_t *out) {
  int fb = 8 * c.m.L;
  out[0] = P.inf ? 1 : 0;
  if (P.inf) {
    std::memset(out + 1, 0, 2 * fb);
    return;
  }
  fp_to_bytes(c.m, P.x, out + 1);
  fp_to_bytes(c.m, P.y, out + 1 + fb);
}
static void rd_g2(const Ctx &c, const uint8_t *in, Aff<Fp2E> &P) {
  int fb = 8 * c.m.L;
  P.inf = in[0] != 0;
  if (P.inf) {
    std::memset(&P.x, 0, sizeof(P.x));
    std::memset(&P.y, 0, sizeof(P.y));
    return;
  }
  fp_from_bytes(c.m, in + 1, P.x.c0);
  fp_from_bytes(c.m, in + 1 + fb, P.x.c1);
  fp_from_bytes(c.m, in + 1 + 2 * fb, P.y.c0);
  fp_from_bytes(c.m, in + 1 + 3 * fb, P.y.c1);
}
static void wr_g2(const Ctx &c, const Aff<Fp2E> &P, uint8_t *out) {
  int fb = 8 * c.m.L;
  out[0] = P.inf ? 1 : 0;
  if (P.inf) {
    std::memset(out + 1, 0, 4 * fb);
    return;
  }
  fp_to_bytes(c.m, P.x.c0, out + 1);
  fp_to_bytes(c.m, P.x.c1, out + 1 + fb);
  fp_to_bytes(c.m, P.y.c0, out + 1 + 2 * fb);
  fp_to_bytes(c.m, P.y.c1, out + 1 + 3 * fb);
}
static void rd_f12(const Ctx &c, const uint8_t *in, Fp12E &a) {
  int fb = 8 * c.m.L;
  const uint8_t *q = in;
  for (int i = 0; i < 2; i++)
    for (int j = 0; j < 3; j++) {
      fp_from_bytes(c.m, q, a.c[i].c[j].c0);
      q += fb;
      fp_from_bytes(c.m, q, a.c[i].c[j].c1);
      q += fb;
    }
}
static void wr_f12(const Ctx &c, const Fp12E &a, uint8_t *out) {
  int fb = 8 * c.m.L;
  uint8_t *q = out;
  for (int i = 0; i < 2; i++)
    for (int j = 0; j < 3; j++) {
      fp_to_bytes(c.m, a.c[i].c[j].c0, q);
      q += fb;
      fp_to_bytes(c.m, a.c[i].c[j].c1, q);
      q += fb;
    }
}

extern "C" {

void mlt_g1_add(int32_t h, const uint8_t *P, const uint8_t *Q, uint8_t *out) {
  Ctx &c = ctx(h);
  Aff<FpE> a, b;
  rd_g1(c, P, a);
  rd_g1(c, Q, b);
  Aff<FpE> r = aff_add<FpE>(c, a, b);
  wr_g1(c, r, out);
}
void mlt_g2_add(int32_t h, const uint8_t *P, const uint8_t *Q, uint8_t *out) {
  Ctx &c = ctx(h);
  Aff<Fp2E> a, b;
  rd_g2(c, P, a);
  rd_g2(c, Q, b);
  Aff<Fp2E> r = aff_add<Fp2E>(c, a, b);
  wr_g2(c, r, out);
}
void mlt_g1_mul(int32_t h, const uint8_t *P, const uint8_t *k, int32_t klen,
                uint8_t *out) {
  Ctx &c = ctx(h);
  Aff<FpE> a;
  rd_g1(c, P, a);
  Aff<FpE> r = to_aff<FpE>(c, jac_mul<FpE>(c, a, k, klen));
  wr_g1(c, r, out);
}
void mlt_g2_mul(int32_t h, const uint8_t *P, const uint8_t *k, int32_t klen,
                uint8_t *out) {
  Ctx &c = ctx(h);
  Aff<Fp2E> a;
  rd_g2(c, P, a);
  Aff<Fp2E> r = to_aff<Fp2E>(c, jac_mul<Fp2E>(c, a, k, klen));
  wr_g2(c, r, out);
}
void mlt_g1_msm(int32_t h, int64_t n, const uint8_t *Ps, const uint8_t *ks,
                int32_t klen, uint8_t *out) {
  Ctx &c = ctx(h);
  int fb = 8 * c.m.L;
  int psz = 1 + 2 * fb;
  std::vector<Aff<FpE>> pts((size_t)n);
  for (int64_t i = 0; i < n; i++) rd_g1(c, Ps + i * psz, pts[(size_t)i]);
  Aff<FpE> r = msm_pippenger<FpE>(c, n, pts.data(), ks, klen);
  wr_g1(c, r, out);
}
void mlt_miller(int32_t h, int32_t npairs, const uint8_t *Ps, const uint8_t *Qs,
                uint8_t *out) {
  Ctx &c = ctx(h);
  int fb = 8 * c.m.L;
  int p1 = 1 + 2 * fb, p2 = 1 + 4 * fb;
  Fp12E f;
  f12_one(c, f);
  for (int32_t i = 0; i < npairs; i++) {
    Aff<FpE> P;
    Aff<Fp2E> Q;
    rd_g1(c, Ps + i * p1, P);
    rd_g2(c, Qs + i * p2, Q);
    Fp12E fi;
    miller_single(c, P, Q, fi);
    f12_mul(c, f, fi, f);
  }
  wr_f12(c, f, out);
}
void mlt_final_exp(int32_t h, const uint8_t *f_in, uint8_t *out) {
  Ctx &c = ctx(h);
  Fp12E f, r;
  rd_f12(c, f_in, f);
  final_exp(c, f, r);
  wr_f12(c, r, out);
}
void mlt_f12_mul(int32_t h, const uint8_t *a, const uint8_t *b, uint8_t *out) {
  Ctx &c = ctx(h);
  Fp12E x, y, r;
  rd_f12(c, a, x);
  rd_f12(c, b, y);
  f12_mul(c, x, y, r);
  wr_f12(c, r, out);
}
void mlt_f12_inv(int32_t h, const uint8_t *a, uint8_t *out) {
  Ctx &c = ctx(h);
  Fp12E x, r;
  rd_f12(c, a, x);
  f12_inv(c, x, r);
  wr_f12(c, r, out);
}
void mlt_f12_pow(int32_t h, const uint8_t *a, const uint8_t *e, int32_t elen,
                 int32_t e_neg, uint8_t *out) {
  Ctx &c = ctx(h);
  Fp12E x, r;
  rd_f12(c, a, x);
  if (e_neg) {
    Fp12E xi;
    f12_inv(c, x, xi);
    x = xi;
  }
  // exponent bytes -> limbs
  std::vector<u64> limbs((size_t)(elen + 7) / 8, 0);
  for (int i = 0; i < elen; i++) limbs[(size_t)i / 8] |= (u64)e[i] << (8 * (i % 8));
  if (limbs.empty()) limbs.push_back(0);
  f12_pow(c, x, limbs.data(), (int)limbs.size(), r);
  wr_f12(c, r, out);
}

} // extern "C"
