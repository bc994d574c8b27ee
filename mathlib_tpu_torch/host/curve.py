"""Generic short-Weierstrass group law over any field (host engine); the
port's own copy of ``mathlib_tpu/host/curve.py``.

Points are affine `(x, y)` tuples or `None` for the point at infinity; the
field is abstracted behind a small ops record so the same code serves
G1 (Fp), G2 (twist over Fp2) and the Fp12-embedded curve used by the host
Miller loop. Replaces the per-backend point code of the reference
(driver/kilic/bls12-381.go:20-106, driver/gurvy/bn254.go:23-112, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple


@dataclass(frozen=True)
class FieldOps:
    add: Callable
    sub: Callable
    mul: Callable
    neg: Callable
    inv: Callable
    is_zero: Callable
    zero: Any
    one: Any
    from_int: Callable


Point = Optional[Tuple[Any, Any]]


class WeierstrassCurve:
    """y^2 = x^3 + a*x + b over an abstract field (a=0 for all our curves,
    but kept general for the SSWU isogenous curves used in hash-to-curve)."""

    def __init__(self, F: FieldOps, a, b):
        self.F = F
        self.a = a
        self.b = b

    def is_on_curve(self, P: Point) -> bool:
        if P is None:
            return True
        x, y = P
        F = self.F
        rhs = F.add(F.add(F.mul(F.mul(x, x), x), F.mul(self.a, x)), self.b)
        return F.is_zero(F.sub(F.mul(y, y), rhs))

    def neg(self, P: Point) -> Point:
        if P is None:
            return None
        return (P[0], self.F.neg(P[1]))

    def add(self, P: Point, Q: Point) -> Point:
        if P is None:
            return Q
        if Q is None:
            return P
        F = self.F
        x1, y1 = P
        x2, y2 = Q
        if F.is_zero(F.sub(x1, x2)):
            if F.is_zero(F.add(y1, y2)):
                return None
            return self.double(P)
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, P: Point) -> Point:
        if P is None:
            return None
        F = self.F
        x1, y1 = P
        if F.is_zero(y1):
            return None
        three = F.from_int(3)
        two = F.from_int(2)
        num = F.add(F.mul(three, F.mul(x1, x1)), self.a)
        lam = F.mul(num, F.inv(F.mul(two, y1)))
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x1)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def sub(self, P: Point, Q: Point) -> Point:
        return self.add(P, self.neg(Q))

    def mul(self, P: Point, k: int) -> Point:
        if k < 0:
            return self.mul(self.neg(P), -k)
        R: Point = None
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.double(P)
            k >>= 1
        return R

    def mul_any(self, P: Point, k: int) -> Point:
        """Scalar mul valid for ANY curve point, subgroup member or not.

        Identical to ``mul`` here; the native engine overrides ``mul``
        with GLV/GLS endomorphism splits that are only correct on the
        r-torsion, and routes ``mul_any`` to its plain ladder — internal
        callers that handle pre-cofactor-clearing points (hash-to-curve)
        must use this entry point.
        """
        return self.mul(P, k)

    def mul2(self, P: Point, e: int, Q: Point, f: int) -> Point:
        """[e]P + [f]Q (Strauss-Shamir on host is unnecessary; exactness only)."""
        return self.add(self.mul(P, e), self.mul(Q, f))

    def msm(self, points, scalars) -> Point:
        R: Point = None
        for P, s in zip(points, scalars):
            R = self.add(R, self.mul(P, s))
        return R
