"""Host pairing engine: exact, generic over CurveSpec (the port's own copy of
``mathlib_tpu/host/engine.py``).

``HostEngine`` is pure Python and slow (about 0.1 s per BLS12-381 final
exponentiation); it is the exact oracle, reached by name from the tests.
``host.native.get_engine`` hands out its C++ subclass.

Implements the full optimal-ate pairing for both curve families by embedding
G2 into E(Fp12) through the (un)twist isomorphism, so a single textbook
Miller loop covers the M-type (BLS12-381, FP256BN) and D-type (BLS12-377,
BN254) twists. It is the bit-exactness oracle for the device code, which re-implements
the same maths with limb arithmetic and sparse line evaluations.

Reference call-paths being reproduced:
  pairing:  driver/kilic/bls12-381.go:260-281, driver/gurvy/bn254.go:247-267
  final exp conventions: see curves/params.py (fexp_factor).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

from ..curves.params import CurveSpec, Family
from .curve import FieldOps, Point, WeierstrassCurve
from .fields import Fp12, Tower, get_tower


class HostEngine:
    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.tw: Tower = get_tower(spec)
        p = spec.p
        t = self.tw

        fp_ops = FieldOps(
            add=lambda a, b: (a + b) % p,
            sub=lambda a, b: (a - b) % p,
            mul=lambda a, b: a * b % p,
            neg=lambda a: (-a) % p,
            inv=t.fp_inv,
            is_zero=lambda a: a % p == 0,
            zero=0,
            one=1,
            from_int=lambda i: i % p,
        )
        f2_ops = FieldOps(
            add=t.f2_add,
            sub=t.f2_sub,
            mul=t.f2_mul,
            neg=t.f2_neg,
            inv=t.f2_inv,
            is_zero=t.f2_is_zero,
            zero=(0, 0),
            one=(1, 0),
            from_int=lambda i: (i % p, 0),
        )
        f12_ops = FieldOps(
            add=t.f12_add,
            sub=t.f12_sub,
            mul=t.f12_mul,
            neg=t.f12_neg,
            inv=t.f12_inv,
            is_zero=lambda a: a == t.F12_ZERO,
            zero=t.F12_ZERO,
            one=t.F12_ONE,
            from_int=lambda i: (((i % p, 0), (0, 0), (0, 0)), ((0, 0),) * 3),
        )
        self.fp_ops, self.f2_ops, self.f12_ops = fp_ops, f2_ops, f12_ops

        self.g1 = WeierstrassCurve(fp_ops, 0, spec.b % p)
        self.g2 = WeierstrassCurve(f2_ops, (0, 0), spec.b2)
        b12 = f12_ops.from_int(spec.b)
        self.e12 = WeierstrassCurve(f12_ops, f12_ops.zero, b12)

        # (un)twist scale factors: M-type (x,y) -> (x/w^2, y/w^3);
        # D-type (x,y) -> (x*w^2, y*w^3).  w = the Fp12 tower generator.
        w: Fp12 = (t.F6_ZERO, t.F6_ONE)
        w2 = t.f12_mul(w, w)
        w3 = t.f12_mul(w2, w)
        if spec.twist == "M":
            self._ux = t.f12_inv(w2)
            self._uy = t.f12_inv(w3)
        else:
            self._ux = w2
            self._uy = w3

    # ------------------------------------------------------------------ G2 →
    def embed_g2(self, Q: Point) -> Point:
        """Untwist an affine G2 point into E(Fp12)."""
        if Q is None:
            return None
        t = self.tw
        x, y = Q
        X = t.f12_mul(self._emb2(x), self._ux)
        Y = t.f12_mul(self._emb2(y), self._uy)
        return (X, Y)

    def _emb2(self, a) -> Fp12:
        """Fp2 scalar as an Fp12 element."""
        t = self.tw
        return ((a, (0, 0), (0, 0)), t.F6_ZERO)

    def _emb1(self, a: int) -> Fp12:
        return self.f12_ops.from_int(a)

    # -------------------------------------------------------------- pairing —
    def miller_loop(self, pairs: List[Tuple[Point, Point]]) -> Fp12:
        """Product of Miller-loop values f_{c,Q_i}(P_i); pairs are (P_g1, Q_g2).

        Matches the reference's batched MillerLoop seam (Pairing2 etc.,
        math.go:869-871). The result still requires final_exp.
        """
        t = self.tw
        f = t.F12_ONE
        for P, Q in pairs:
            f = t.f12_mul(f, self._miller_single(P, Q))
        return f

    def _miller_single(self, P: Point, Q: Point) -> Fp12:
        t, spec = self.tw, self.spec
        if P is None or Q is None:
            return t.F12_ONE
        Qe = self.embed_g2(Q)
        xP = self._emb1(P[0])
        yP = self._emb1(P[1])

        if spec.family == Family.BLS12:
            c = abs(spec.x)
        else:
            c = abs(6 * spec.x + 2)

        f = t.F12_ONE
        T = Qe
        for i in range(c.bit_length() - 2, -1, -1):
            f, T = self._step_double(f, T, xP, yP)
            if (c >> i) & 1:
                f, T = self._step_add(f, T, Qe, xP, yP)

        if spec.family == Family.BLS12:
            if spec.x < 0:
                f = t.f12_conj(f)
            return f

        # BN family: extra Frobenius lines (optimal ate)
        m = 6 * spec.x + 2
        if m < 0:
            f = t.f12_conj(f)
            T = self.e12.neg(T)
        pi = lambda R, n: None if R is None else (
            t.f12_frob(R[0], n),
            t.f12_frob(R[1], n),
        )
        Q1 = pi(Qe, 1)
        Q2 = self.e12.neg(pi(Qe, 2))
        f, T = self._step_add(f, T, Q1, xP, yP)
        f, T = self._step_add(f, T, Q2, xP, yP)
        return f

    def _step_double(self, f, T, xP, yP):
        t = self.tw
        F = self.f12_ops
        x1, y1 = T
        three = F.from_int(3)
        two = F.from_int(2)
        lam = F.mul(F.mul(three, F.mul(x1, x1)), F.inv(F.mul(two, y1)))
        l = F.sub(F.sub(yP, y1), F.mul(lam, F.sub(xP, x1)))
        f = t.f12_mul(t.f12_sqr(f), l)
        return f, self.e12.double(T)

    def _step_add(self, f, T, Q, xP, yP):
        t = self.tw
        F = self.f12_ops
        x1, y1 = T
        x2, y2 = Q
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        l = F.sub(F.sub(yP, y1), F.mul(lam, F.sub(xP, x1)))
        f = t.f12_mul(f, l)
        return f, self.e12.add(T, Q)

    def final_exp(self, f: Fp12) -> Fp12:
        return self.tw.f12_final_exp(f)

    def pairing(self, P: Point, Q: Point, reduce: bool = True) -> Fp12:
        f = self.miller_loop([(P, Q)])
        return self.final_exp(f) if reduce else f

    # ------------------------------------------------------------------- Gt —
    def gt_exp(self, a: Fp12, e: int) -> Fp12:
        return self.tw.f12_pow(a, e)

    def gt_mul(self, a: Fp12, b: Fp12) -> Fp12:
        return self.tw.f12_mul(a, b)

    def gt_inv(self, a: Fp12) -> Fp12:
        return self.tw.f12_inv(a)

    def gt_is_one(self, a: Fp12) -> bool:
        return self.tw.f12_is_one(a)

    @property
    def gen_g1(self) -> Point:
        return self.spec.g1_gen

    @property
    def gen_g2(self) -> Point:
        return self.spec.g2_gen

    @lru_cache(maxsize=1)
    def gen_gt(self) -> Fp12:
        return self.pairing(self.gen_g1, self.gen_g2)
