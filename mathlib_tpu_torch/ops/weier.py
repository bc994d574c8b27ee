"""Complete projective Weierstrass group law, generic over the field
(port of ``mathlib_tpu/ops/weier.py``).

Renes-Costello-Batina complete formulas for y^2 = x^3 + b (eprint 2015/1060,
Algorithms 7 and 9, a = 0): one straight-line program covers generic
addition, doubling and the point at infinity (0 : 1 : 0).

Values live in the relaxed domain [0, 2p), where x and x + p are both valid,
so the order of the adds, subs and small-multiple chains fixes which
representative comes out.  The sequence below is the reference's operation
for operation, and the CUDA kernels (``csrc/g1_kernels.cu``) follow the same
sequence, so all three agree limb for limb.  Each dependency level's
multiplications go out as ONE stacked ``mul_many`` call.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

Elem = Any  # field element batch: (..., L, B) tensor


class FieldAdapter:
    """Minimal field interface for the group law."""

    def add(self, a: Elem, b: Elem) -> Elem:
        raise NotImplementedError

    def sub(self, a: Elem, b: Elem) -> Elem:
        raise NotImplementedError

    def mul_many(self, xs: Sequence[Elem], ys: Sequence[Elem]) -> Tuple[Elem, ...]:
        """Element-wise products [x*y for x, y in zip(xs, ys)], batched."""
        raise NotImplementedError

    def add_many(self, xs: Sequence[Elem], ys: Sequence[Elem]) -> Tuple[Elem, ...]:
        raise NotImplementedError

    def sub_many(self, xs: Sequence[Elem], ys: Sequence[Elem]) -> Tuple[Elem, ...]:
        raise NotImplementedError

    def mul_b3(self, a: Elem) -> Elem:
        """Multiply by 3*b (the curve constant); small-int add chain."""
        raise NotImplementedError


def add_complete(F: FieldAdapter, P, Q):
    """RCB Algorithm 7 (a=0).  P, Q, result: (X, Y, Z) coordinate tuples."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    s = F.add_many([X1, X2, Y1, Y2, X1, X2], [Y1, Y2, Z1, Z2, Z1, Z2])
    xy1, xy2, yz1, yz2, xz1, xz2 = s
    t0, t1, t2, a3, a4, a5 = F.mul_many(
        [X1, Y1, Z1, xy1, yz1, xz1], [X2, Y2, Z2, xy2, yz2, xz2]
    )
    u = F.add_many([t0, t1, t0], [t1, t2, t2])
    t3, t4, ln = F.sub_many([a3, a4, a5], list(u))
    t0_3 = F.add(F.add(t0, t0), t0)
    t2b = F.mul_b3(t2)
    lnb = F.mul_b3(ln)
    z3t = F.add(t1, t2b)
    t1m = F.sub(t1, t2b)
    m = F.mul_many([t4, t3, lnb, t1m, t0_3, z3t], [lnb, t1m, t0_3, z3t, t3, t4])
    x3a, x3b, y3a, y3b, z3a, z3b = m
    X3 = F.sub(x3b, x3a)
    Y3 = F.add(y3b, y3a)
    Z3 = F.add(z3b, z3a)
    return X3, Y3, Z3


def double_complete(F: FieldAdapter, P):
    """RCB Algorithm 9 (a=0)."""
    X1, Y1, Z1 = P
    t0, t1, t2, xy = F.mul_many([Y1, Y1, Z1, X1], [Y1, Z1, Z1, Y1])
    z3t = F.add(t0, t0)
    z3t = F.add(z3t, z3t)
    z3t = F.add(z3t, z3t)  # 8*Y^2
    t2b = F.mul_b3(t2)
    y3t = F.add(t0, t2b)
    t2_3 = F.add(F.add(t2b, t2b), t2b)
    t0m = F.sub(t0, t2_3)
    x3a, Z3, y3m, x3m = F.mul_many([t2b, t1, t0m, t0m], [z3t, z3t, y3t, xy])
    X3 = F.add(x3m, x3m)
    Y3 = F.add(x3a, y3m)
    return X3, Y3, Z3
