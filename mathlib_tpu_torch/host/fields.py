"""Exact host-side field towers (Python ints); the port's own copy of
``mathlib_tpu/host/fields.py``.

This is the *reference engine*: bit-exact, branch-friendly code that derives
the device constants (Frobenius twist factors) and serves as the differential
oracle for the device code. It is generic
over any CurveSpec (the reference hard-codes three separate backends instead;
cf. driver/kilic, driver/gurvy, driver/amcl in IBM/mathlib).

Tower construction (matches kilic/gnark conventions):
    Fp2  = Fp[u]  / (u^2 - beta)
    Fp6  = Fp2[v] / (v^3 - xi)
    Fp12 = Fp6[w] / (w^2 - v)

Element encodings: fp = int, fp2 = (c0, c1), fp6 = (fp2, fp2, fp2),
fp12 = (fp6, fp6). All coefficients are canonical ints in [0, p).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

from ..curves.params import CurveSpec, _f2_sqrt, _fp_sqrt, hard_part_digits

Fp2 = Tuple[int, int]
Fp6 = Tuple[Fp2, Fp2, Fp2]
Fp12 = Tuple[Fp6, Fp6]


class Tower:
    """All tower-field arithmetic for one CurveSpec."""

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.p = spec.p
        self.beta = spec.beta
        self.xi = spec.xi
        p = self.p
        # Frobenius constants: u^p = u * beta^((p-1)/2) = -u (beta non-residue),
        # v^p = v * xi^((p-1)/3), w^p = w * xi^((p-1)/6).
        assert (p - 1) % 6 == 0
        self.frob_v = self.f2_pow(self.xi, (p - 1) // 3)
        self.frob_w = self.f2_pow(self.xi, (p - 1) // 6)

    # ---- Fp ---------------------------------------------------------------
    def fp_inv(self, a: int) -> int:
        return pow(a, self.p - 2, self.p)

    def fp_sqrt(self, a: int) -> Optional[int]:
        return _fp_sqrt(a, self.p)

    # ---- Fp2 ----------------------------------------------------------------
    def f2(self, c0: int, c1: int = 0) -> Fp2:
        return (c0 % self.p, c1 % self.p)

    F2_ZERO = property(lambda self: (0, 0))
    F2_ONE = property(lambda self: (1, 0))

    def f2_add(self, a: Fp2, b: Fp2) -> Fp2:
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def f2_sub(self, a: Fp2, b: Fp2) -> Fp2:
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def f2_neg(self, a: Fp2) -> Fp2:
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    def f2_mul(self, a: Fp2, b: Fp2) -> Fp2:
        p, beta = self.p, self.beta
        return (
            (a[0] * b[0] + beta * a[1] * b[1]) % p,
            (a[0] * b[1] + a[1] * b[0]) % p,
        )

    def f2_sqr(self, a: Fp2) -> Fp2:
        return self.f2_mul(a, a)

    def f2_muls(self, a: Fp2, s: int) -> Fp2:
        p = self.p
        return (a[0] * s % p, a[1] * s % p)

    def f2_conj(self, a: Fp2) -> Fp2:
        return (a[0], (-a[1]) % self.p)

    def f2_inv(self, a: Fp2) -> Fp2:
        p, beta = self.p, self.beta
        norm = (a[0] * a[0] - beta * a[1] * a[1]) % p
        ninv = pow(norm, p - 2, p)
        return (a[0] * ninv % p, (-a[1]) * ninv % p)

    def f2_pow(self, a: Fp2, e: int) -> Fp2:
        res: Fp2 = (1, 0)
        base = a
        while e:
            if e & 1:
                res = self.f2_mul(res, base)
            base = self.f2_sqr(base)
            e >>= 1
        return res

    def f2_sqrt(self, a: Fp2) -> Optional[Fp2]:
        return _f2_sqrt(a, self.p, self.beta)

    def f2_is_zero(self, a: Fp2) -> bool:
        return a[0] == 0 and a[1] == 0

    def f2_mul_xi(self, a: Fp2) -> Fp2:
        return self.f2_mul(a, self.xi)

    # ---- Fp6 ----------------------------------------------------------------
    F6_ZERO = property(lambda self: ((0, 0), (0, 0), (0, 0)))
    F6_ONE = property(lambda self: ((1, 0), (0, 0), (0, 0)))

    def f6_add(self, a: Fp6, b: Fp6) -> Fp6:
        f = self.f2_add
        return (f(a[0], b[0]), f(a[1], b[1]), f(a[2], b[2]))

    def f6_sub(self, a: Fp6, b: Fp6) -> Fp6:
        f = self.f2_sub
        return (f(a[0], b[0]), f(a[1], b[1]), f(a[2], b[2]))

    def f6_neg(self, a: Fp6) -> Fp6:
        f = self.f2_neg
        return (f(a[0]), f(a[1]), f(a[2]))

    def f6_mul(self, a: Fp6, b: Fp6) -> Fp6:
        m, add, sub, mx = self.f2_mul, self.f2_add, self.f2_sub, self.f2_mul_xi
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0, t1, t2 = m(a0, b0), m(a1, b1), m(a2, b2)
        # Karatsuba-style (Toom): c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
        c0 = add(t0, mx(sub(sub(m(add(a1, a2), add(b1, b2)), t1), t2)))
        c1 = add(sub(sub(m(add(a0, a1), add(b0, b1)), t0), t1), mx(t2))
        c2 = add(sub(sub(m(add(a0, a2), add(b0, b2)), t0), t2), t1)
        return (c0, c1, c2)

    def f6_sqr(self, a: Fp6) -> Fp6:
        return self.f6_mul(a, a)

    def f6_mul_v(self, a: Fp6) -> Fp6:
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_inv(self, a: Fp6) -> Fp6:
        m, sub, mx = self.f2_mul, self.f2_sub, self.f2_mul_xi
        a0, a1, a2 = a
        c0 = sub(m(a0, a0), mx(m(a1, a2)))
        c1 = sub(mx(m(a2, a2)), m(a0, a1))
        c2 = sub(m(a1, a1), m(a0, a2))
        # norm = a0*c0 + xi*(a2*c1 + a1*c2)
        norm = self.f2_add(m(a0, c0), mx(self.f2_add(m(a2, c1), m(a1, c2))))
        ninv = self.f2_inv(norm)
        return (m(c0, ninv), m(c1, ninv), m(c2, ninv))

    def f6_is_zero(self, a: Fp6) -> bool:
        return all(self.f2_is_zero(c) for c in a)

    # ---- Fp12 ---------------------------------------------------------------
    F12_ZERO = property(lambda self: (((0, 0),) * 3, ((0, 0),) * 3))
    F12_ONE = property(lambda self: (((1, 0), (0, 0), (0, 0)), ((0, 0),) * 3))

    def f12(self, c0: Fp6, c1: Fp6) -> Fp12:
        return (c0, c1)

    def f12_add(self, a: Fp12, b: Fp12) -> Fp12:
        return (self.f6_add(a[0], b[0]), self.f6_add(a[1], b[1]))

    def f12_sub(self, a: Fp12, b: Fp12) -> Fp12:
        return (self.f6_sub(a[0], b[0]), self.f6_sub(a[1], b[1]))

    def f12_neg(self, a: Fp12) -> Fp12:
        return (self.f6_neg(a[0]), self.f6_neg(a[1]))

    def f12_mul(self, a: Fp12, b: Fp12) -> Fp12:
        a0, a1 = a
        b0, b1 = b
        t0 = self.f6_mul(a0, b0)
        t1 = self.f6_mul(a1, b1)
        c0 = self.f6_add(t0, self.f6_mul_v(t1))
        c1 = self.f6_sub(
            self.f6_sub(self.f6_mul(self.f6_add(a0, a1), self.f6_add(b0, b1)), t0), t1
        )
        return (c0, c1)

    def f12_sqr(self, a: Fp12) -> Fp12:
        return self.f12_mul(a, a)

    def f12_conj(self, a: Fp12) -> Fp12:
        """Conjugation = Frobenius^6 = inverse on the cyclotomic subgroup."""
        return (a[0], self.f6_neg(a[1]))

    def f12_inv(self, a: Fp12) -> Fp12:
        a0, a1 = a
        norm = self.f6_sub(self.f6_mul(a0, a0), self.f6_mul_v(self.f6_mul(a1, a1)))
        ninv = self.f6_inv(norm)
        return (self.f6_mul(a0, ninv), self.f6_neg(self.f6_mul(a1, ninv)))

    def f12_pow(self, a: Fp12, e: int) -> Fp12:
        if e < 0:
            return self.f12_pow(self.f12_inv(a), -e)
        res = self.F12_ONE
        base = a
        while e:
            if e & 1:
                res = self.f12_mul(res, base)
            base = self.f12_sqr(base)
            e >>= 1
        return res

    def f12_is_one(self, a: Fp12) -> bool:
        return a == self.F12_ONE

    # ---- Frobenius ----------------------------------------------------------
    def f6_frob(self, a: Fp6) -> Fp6:
        """(c0 + c1 v + c2 v^2)^p with coefficients in Fp2."""
        g = self.frob_v
        g2 = self.f2_sqr(g)
        return (
            self.f2_conj(a[0]),
            self.f2_mul(self.f2_conj(a[1]), g),
            self.f2_mul(self.f2_conj(a[2]), g2),
        )

    def f12_frob(self, a: Fp12, n: int = 1) -> Fp12:
        for _ in range(n % 12):
            a0 = self.f6_frob(a[0])
            a1 = self.f6_frob(a[1])
            # w^p = frob_w * w
            a1 = tuple(self.f2_mul(c, self.frob_w) for c in a1)
            a = (a0, a1)  # type: ignore[assignment]
        return a

    # ---- final-exponentiation helper -----------------------------------------
    def f12_final_exp(self, f: Fp12) -> Fp12:
        """The pairing final exponentiation, per-curve convention.

        Easy part f^((p^6-1)(p^2+1)) via conjugation/inverse/frobenius, then
        the hard part by Frobenius-decomposed multi-exponentiation of
        spec.hard_part_exp (= fexp_factor * (p^4-p^2+1)/r; see params.py).
        """
        # easy part
        t = self.f12_mul(self.f12_conj(f), self.f12_inv(f))  # f^(p^6-1)
        f = self.f12_mul(self.f12_frob(t, 2), t)  # ^(p^2+1)
        # hard part: decompose exponent in base p, share squarings
        digits = hard_part_digits(self.spec)
        bases = [f]
        for _ in range(len(digits) - 1):
            bases.append(self.f12_frob(bases[-1], 1))
        return self._multi_pow(bases, digits)

    def _multi_pow(self, bases, exps) -> Fp12:
        """Simultaneous multi-exponentiation (shared-square Straus)."""
        nbits = max(e.bit_length() for e in exps)
        # precompute products over subsets
        n = len(bases)
        table = [self.F12_ONE] * (1 << n)
        for i in range(n):
            bit = 1 << i
            for s in range(bit):
                table[s | bit] = self.f12_mul(table[s], bases[i])
        res = self.F12_ONE
        for i in range(nbits - 1, -1, -1):
            res = self.f12_sqr(res)
            idx = 0
            for j, e in enumerate(exps):
                if (e >> i) & 1:
                    idx |= 1 << j
            if idx:
                res = self.f12_mul(res, table[idx])
        return res


@lru_cache(maxsize=None)
def get_tower(spec: CurveSpec) -> Tower:
    return Tower(spec)
