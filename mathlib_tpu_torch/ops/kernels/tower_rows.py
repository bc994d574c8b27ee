"""Fp2/Fp6/Fp12 arithmetic and the Miller-loop steps, operation for operation
as ``mathlib_tpu/ops/kernels/pairing_pallas.py RowTower`` computes them: the
plain PyTorch version of the pairing kernels (``pairing_cuda.py``).

The values are the reference kernel's, relaxed limbs included: every add,
sub, small multiple and Montgomery product is the same function of the same
inputs.  Only the scheduling differs.  Elements are int64 tensors of 16-bit
limbs with the lane batch last, coefficients stacked in front:

    fp   (..., L, B)
    f2   (..., 2, L, B)          c0 + c1 u,   u^2 = -n
    f6   (..., 3, 2, L, B)       a0 + a1 v + a2 v^2,   v^3 = xi = xi0 + u
    f12  (..., 2, 3, 2, L, B)    b0 + b1 w,   w^2 = v

Independent Montgomery products of one algorithm level are queued on a
``MulBatch`` and run as one ``mont_mul`` call, as the reference stacks them
on sublanes; adds and subs run on whole stacked tensors.  Neither changes a
value: each is elementwise.  Lazy Fp2 reduction (``MATHLIB_LAZY_F2`` in the
reference) is default-off there and not ported.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from ..field import FpCtx
from . import fp_cuda

Tensor = torch.Tensor


def _stack(xs, dim: int) -> Tensor:
    shape = xs[0].shape
    if any(x.shape != shape for x in xs):
        xs = torch.broadcast_tensors(*xs)
    return torch.stack(xs, dim=dim)


def _c(a: Tensor, i: int, dim: int) -> Tensor:
    return a.select(dim, i)


class MulBatch:
    """Collect independent Montgomery products; run them as one call."""

    def __init__(self, fp: FpCtx):
        self.fp = fp
        self.pairs: List = []

    def push(self, a: Tensor, b: Tensor) -> int:
        self.pairs.append(torch.broadcast_tensors(a, b))
        return len(self.pairs) - 1

    def run(self) -> List[Tensor]:
        L, B = self.pairs[0][0].shape[-2:]
        counts = [math.prod(a.shape[:-2]) for a, _ in self.pairs]  # B = 0 too
        A = torch.cat([a.reshape(k, L, B) for k, (a, _) in zip(counts, self.pairs)])
        Bm = torch.cat([b.reshape(k, L, B) for k, (_, b) in zip(counts, self.pairs)])
        flat = self.fp._mont_mul64(A, Bm)
        out, lo = [], 0
        for k, (a, _) in zip(counts, self.pairs):
            out.append(flat[lo : lo + k].reshape(a.shape))
            lo += k
        self.pairs = []
        return out


class RowTower:
    """The reference's ``RowTower`` for one curve: beta = -n, xi = xi0 + u,
    sextic twist ``"M"`` or ``"D"``."""

    def __init__(self, fp: FpCtx, n: int, xi0: int, twist: str):
        self.fp = fp
        self.L = fp.L
        self.n = n
        self.xi0 = xi0
        self.twist = twist
        self.one = fp.one_mont  # (L, 1) int64

    # ---------------------------------------------------------- fp helpers --
    def add(self, a, b):  # the sums broadcast
        return self.fp._add64(a, b)

    def sub(self, a, b):
        return self.fp._sub64(a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def dbl(self, a):
        return self.add(a, a)

    def small(self, a, k: int):
        """a * k by the reference's add chain (``RowCtx.mul_small``)."""
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    # ---------------------------------------------------------------- fp2 ---
    def conj(self, a):
        return _stack([_c(a, 0, -3), self.neg(_c(a, 1, -3))], -3)

    def mul_xi(self, a):
        """a * (xi0 + u): (xi0*a0 - n*a1, xi0*a1 + a0)."""
        a0, a1 = _c(a, 0, -3), _c(a, 1, -3)
        na1 = a1 if self.n == 1 else self.small(a1, self.n)
        if self.xi0 == 0:
            return _stack([self.neg(na1), a0], -3)
        x = self.small(a, self.xi0)
        return _stack(
            [self.sub(_c(x, 0, -3), na1), self.add(_c(x, 1, -3), a0)], -3
        )

    def q_mul(self, mb: MulBatch, a, b) -> Callable:
        """Queue a Karatsuba f2 mul (3 products); returns resolver(outs)."""
        a0, a1 = _c(a, 0, -3), _c(a, 1, -3)
        b0, b1 = _c(b, 0, -3), _c(b, 1, -3)
        sa, sb = self.add(_stack([a0, b0], 0), _stack([a1, b1], 0))  # a0 + a1, b0 + b1
        i = mb.push(_stack([a0, a1, sa], -3), _stack([b0, b1, sb], -3))

        def res(o):
            t0, t1, t2 = (_c(o[i], k, -3) for k in range(3))
            nt1 = t1 if self.n == 1 else self.small(t1, self.n)
            return self.sub(_stack([t0, t2], -3), _stack([nt1, self.add(t0, t1)], -3))

        return res

    def q_sqr(self, mb: MulBatch, a) -> Callable:
        a0, a1 = _c(a, 0, -3), _c(a, 1, -3)
        if self.n == 1:
            i = mb.push(
                _stack([self.add(a0, a1), a0], -3), _stack([self.sub(a0, a1), a1], -3)
            )

            def res(o):
                s, m = _c(o[i], 0, -3), _c(o[i], 1, -3)
                return _stack([s, self.add(m, m)], -3)

            return res
        i = mb.push(_stack([a0, a1, a0], -3), _stack([a0, a1, a1], -3))

        def res(o):
            s0, s1, m = (_c(o[i], k, -3) for k in range(3))
            return _stack([self.sub(s0, self.small(s1, self.n)), self.add(m, m)], -3)

        return res

    def q_mul_fp(self, mb: MulBatch, a, r) -> Callable:
        """f2 x base-field element."""
        i = mb.push(a, r.unsqueeze(-3))
        return lambda o: o[i]

    # ---------------------------------------------------------------- fp6 ---
    def f6_mul_v(self, a):
        return _stack([self.mul_xi(_c(a, 2, -4)), _c(a, 0, -4), _c(a, 1, -4)], -4)

    def q_f6_mul(self, mb: MulBatch, a, b) -> Callable:
        """Karatsuba: 6 independent f2 muls."""
        a0, a1, a2 = (_c(a, k, -4) for k in range(3))
        b0, b1, b2 = (_c(b, k, -4) for k in range(3))
        sa, sb = self.add(  # a1 + a2, a0 + a1, a0 + a2 and the same of b, in one call
            _stack([_stack([a1, a0, a0], -4), _stack([b1, b0, b0], -4)], 0),
            _stack([_stack([a2, a1, a2], -4), _stack([b2, b1, b2], -4)], 0),
        )
        r = self.q_mul(
            mb,
            torch.cat(torch.broadcast_tensors(_stack([a0, a1, a2], -4), sa), -4),
            torch.cat(torch.broadcast_tensors(_stack([b0, b1, b2], -4), sb), -4),
        )

        def res(o):
            m = r(o)
            t0, t1, t2, m12, m01, m02 = (_c(m, k, -4) for k in range(6))
            d = self.sub(
                self.sub(_stack([m12, m01, m02], -4), _stack([t1, t0, t0], -4)),
                _stack([t2, t1, t2], -4),
            )
            x = self.mul_xi(_stack([_c(d, 0, -4), t2], -4))
            return self.add(
                _stack([t0, _c(d, 1, -4), _c(d, 2, -4)], -4),
                _stack([_c(x, 0, -4), _c(x, 1, -4), t1], -4),
            )

        return res

    def q_f6_mul01(self, mb: MulBatch, a, b0, b1) -> Callable:
        """a * (b0 + b1 v): 5 f2 muls."""
        a0, a1, a2 = (_c(a, k, -4) for k in range(3))
        r = self.q_mul(
            mb,
            _stack([a0, a1, a2, a2, self.add(a0, a1)], -4),
            _stack([b0, b1, b0, b1, self.add(b0, b1)], -4),
        )

        def res(o):
            m = r(o)
            a0b0, a1b1, a2b0, a2b1, x = (_c(m, k, -4) for k in range(5))
            c0 = self.add(a0b0, self.mul_xi(a2b1))
            c1 = self.sub(self.sub(x, a0b0), a1b1)
            c2 = self.add(a1b1, a2b0)
            return _stack([c0, c1, c2], -4)

        return res

    # --------------------------------------------------------------- fp12 ---
    def f12_conj(self, f):
        return _stack([_c(f, 0, -5), self.neg(_c(f, 1, -5))], -5)

    def f12_sqr(self, f):
        """Complex squaring over Fp6 (2 f6 muls, one batch)."""
        a0, a1 = _c(f, 0, -5), _c(f, 1, -5)
        mb = MulBatch(self.fp)
        r = self.q_f6_mul(
            mb,
            _stack([a0, self.add(a0, a1)], -5),
            _stack([a1, self.add(a0, self.f6_mul_v(a1))], -5),
        )
        m = r(mb.run())
        t, m1 = _c(m, 0, -5), _c(m, 1, -5)
        c0 = self.sub(self.sub(m1, t), self.f6_mul_v(t))
        return _stack([c0, self.add(t, t)], -5)

    def f12_mul(self, f, g):
        """Karatsuba over Fp6 (3 f6 muls, one batch)."""
        a0, a1 = _c(f, 0, -5), _c(f, 1, -5)
        b0, b1 = _c(g, 0, -5), _c(g, 1, -5)
        mb = MulBatch(self.fp)
        r = self.q_f6_mul(
            mb,
            _stack([a0, a1, self.add(a0, a1)], -5),
            _stack([b0, b1, self.add(b0, b1)], -5),
        )
        m = r(mb.run())
        t0, t1, ts = (_c(m, k, -5) for k in range(3))
        c0 = self.add(t0, self.f6_mul_v(t1))
        c1 = self.sub(self.sub(ts, t0), t1)
        return _stack([c0, c1], -5)

    def f12_sparse_mul(self, f, A, DmB, negC):
        """f * line, the line placed as ops/pairing.py _line_f12 places it:
        M-twist: l0 = A v^2, l1 = (D-B) + (-C) v;
        D-twist: l0 = A,     l1 = (-C) + (D-B) v.  One batch."""
        b0, b1 = (DmB, negC) if self.twist == "M" else (negC, DmB)
        a0, a1 = _c(f, 0, -5), _c(f, 1, -5)
        mb = MulBatch(self.fp)
        r0 = self.q_mul(mb, a0, A.unsqueeze(-4))  # a0[j] * A, j = 0..2
        r1 = self.q_f6_mul01(mb, a1, b0, b1)
        if self.twist == "M":
            rs = self.q_f6_mul(mb, self.add(a0, a1), _stack([b0, b1, A], -4))
        else:
            rs = self.q_f6_mul01(mb, self.add(a0, a1), self.add(b0, A), b1)
        o = mb.run()
        p = r0(o)
        if self.twist == "M":
            # a0 * (A v^2) = (xi*(a1 A), xi*(a2 A), a0 A)
            x = self.mul_xi(_stack([_c(p, 1, -4), _c(p, 2, -4)], -4))
            a0l0 = _stack([_c(x, 0, -4), _c(x, 1, -4), _c(p, 0, -4)], -4)
        else:
            a0l0 = p
        a1l1, cross = r1(o), rs(o)
        c0 = self.add(a0l0, self.f6_mul_v(a1l1))
        c1 = self.sub(self.sub(cross, a0l0), a1l1)
        return _stack([c0, c1], -5)

    # -------------------------------------------- inversion / frobenius ---
    def fp_pow(self, a, bits):
        """a**e over fp, e's MSB-first bits (``RowTower.fp_pow``): the plain
        version of the ``fp_pow`` kernel."""
        return fp_cuda.fp_pow_plain(self.fp, a, bits).to(torch.int64)

    def f2_inv(self, a, inv_bits):
        """1/a via the norm: (a0 - a1 u) / (a0^2 + n a1^2); the base-field
        inverse by ``fp_pow`` over inv_bits (p - 2, MSB-first)."""
        mb = MulBatch(self.fp)
        i = mb.push(a, a)
        sq = mb.run()[i]
        s1 = _c(sq, 1, -3)
        norm = self.add(_c(sq, 0, -3), s1 if self.n == 1 else self.small(s1, self.n))
        ninv = self.fp_pow(norm, inv_bits)
        i = mb.push(a, ninv.unsqueeze(-3))
        m = mb.run()[i]
        return _stack([_c(m, 0, -3), self.neg(_c(m, 1, -3))], -3)

    def f6_inv(self, a, inv_bits):
        a0, a1, a2 = (_c(a, k, -4) for k in range(3))
        mb = MulBatch(self.fp)
        r00, r12, r22 = self.q_sqr(mb, a0), self.q_mul(mb, a1, a2), self.q_sqr(mb, a2)
        r01, r11, r02 = self.q_mul(mb, a0, a1), self.q_sqr(mb, a1), self.q_mul(mb, a0, a2)
        o = mb.run()
        c = _stack([
            self.sub(r00(o), self.mul_xi(r12(o))),
            self.sub(self.mul_xi(r22(o)), r01(o)),
            self.sub(r11(o), r02(o)),
        ], -4)
        r = self.q_mul(mb, _stack([a0, a2, a1], -4), c)  # a0 c0, a2 c1, a1 c2
        m = r(mb.run())
        norm = self.add(_c(m, 0, -4), self.mul_xi(self.add(_c(m, 1, -4), _c(m, 2, -4))))
        ninv = self.f2_inv(norm, inv_bits)
        r = self.q_mul(mb, c, ninv.unsqueeze(-4))
        return r(mb.run())

    def f6_sqr(self, a):
        mb = MulBatch(self.fp)
        r = self.q_f6_mul(mb, a, a)
        return r(mb.run())

    def f6_neg(self, a):
        return self.neg(a)

    def f12_inv(self, f, inv_bits):
        """1/f = (a0 - a1 w) / (a0^2 - v a1^2)."""
        s = self.f6_sqr(f)  # a0^2, a1^2 in one batch
        n6 = self.sub(_c(s, 0, -5), self.f6_mul_v(_c(s, 1, -5)))
        ninv = self.f6_inv(n6, inv_bits)
        mb = MulBatch(self.fp)
        r = self.q_f6_mul(mb, f, ninv.unsqueeze(-5))
        m = r(mb.run())
        return _stack([_c(m, 0, -5), self.f6_neg(_c(m, 1, -5))], -5)

    def f12_frob(self, f, gam, n: int):
        """f^(p^n): conjugate every coefficient when n is odd, then scale
        coefficient (h, j) by gam[h, j] ((2, 3, 2, L, 1) Montgomery limbs of
        the Frobenius constants gamma_n, laid out as an f12)."""
        if n % 2:
            f = _stack([_c(f, 0, -3), self.neg(_c(f, 1, -3))], -3)
        mb = MulBatch(self.fp)
        r = self.q_mul(mb, f, gam)
        return r(mb.run())

    def f12_cyclo_sqr(self, f):
        """Granger-Scott squaring in the cyclotomic subgroup (unitary f only):
        Fp4 pairs (x, y) = (a0, b1), (b0, a2), (a1, b2), each squared as
        t0 = x^2 + xi y^2, t1 = (x + y)^2 - x^2 - y^2; 9 f2 squarings in one
        batch; then z' = 2(t - z) + t into a0, a1, a2 and z' = 2(t + z) + t
        into b0 (from xi t1 of the third pair), b1, b2."""
        a, b = _c(f, 0, -5), _c(f, 1, -5)
        X = _stack([_c(a, 0, -4), _c(b, 0, -4), _c(a, 1, -4)], -4)
        Y = _stack([_c(b, 1, -4), _c(a, 2, -4), _c(b, 2, -4)], -4)
        mb = MulBatch(self.fp)
        r = self.q_sqr(mb, torch.stack([X, Y, self.add(X, Y)]))  # the 9 squarings at once
        x2, y2, s2 = r(mb.run())
        t0 = self.add(x2, self.mul_xi(y2))  # t00, t10, t20
        t1 = self.sub(self.sub(s2, x2), y2)  # t01, t11, t21
        c0 = self.add(self.dbl(self.sub(t0, a)), t0)  # z0, z4, z3
        tp = _stack([self.mul_xi(_c(t1, 2, -4)), _c(t1, 0, -4), _c(t1, 1, -4)], -4)
        c1 = self.add(self.dbl(self.add(tp, b)), tp)  # z2, z1, z5
        return _stack([c0, c1], -5)

    # ------------------------------------------------------- miller steps ---
    def dbl_step(self, T, xP, yP):
        """Tangent line at T evaluated at P + incomplete projective double
        (``RowTower.dbl_step``); T is (..., 3, 2, L, B).  Returns
        ((A, D-B, -C), 2T)."""
        X, Y, Z = (_c(T, k, -4) for k in range(3))
        mb = MulBatch(self.fp)
        rS = self.q_mul(mb, Y, Z)
        rX2 = self.q_sqr(mb, X)
        o = mb.run()
        S, X2 = rS(o), rX2(o)
        W = self.small(X2, 3)

        mb = MulBatch(self.fp)
        rYS = self.q_mul(mb, Y, S)
        rSZ = self.q_mul(mb, S, Z)
        rS2 = self.q_sqr(mb, S)
        rX3 = self.q_mul(mb, X2, X)
        rX2Z = self.q_mul(mb, X2, Z)
        rW2 = self.q_sqr(mb, W)
        o = mb.run()
        YS, SZ, S2, X3t, X2Z, W2 = rYS(o), rSZ(o), rS2(o), rX3(o), rX2Z(o), rW2(o)

        mb = MulBatch(self.fp)
        rBd = self.q_mul(mb, X, YS)
        rYS2 = self.q_sqr(mb, YS)
        rSS2 = self.q_mul(mb, S, S2)
        rA = self.q_mul_fp(mb, self.dbl(SZ), yP)
        rC = self.q_mul_fp(mb, self.small(X2Z, 3), xP)
        o = mb.run()
        Bd, YS2, SS2, A, C = rBd(o), rYS2(o), rSS2(o), rA(o), rC(o)
        H = self.sub(W2, self.small(Bd, 8))

        mb = MulBatch(self.fp)
        rHS = self.q_mul(mb, H, S)
        rWt = self.q_mul(mb, W, self.sub(self.small(Bd, 4), H))
        o = mb.run()
        HS, Wt = rHS(o), rWt(o)

        Xn = self.dbl(HS)
        Yn = self.sub(Wt, self.small(YS2, 8))
        Zn = self.small(SS2, 8)
        DmB = self.sub(self.small(X3t, 3), self.dbl(YS))
        return (A, DmB, self.neg(C)), _stack([Xn, Yn, Zn], -4)

    def add_step(self, T, Qx, Qy, xP, yP):
        """Chord line through T and affine Q evaluated at P + incomplete
        mixed addition (``RowTower.add_step``)."""
        X, Y, Z = (_c(T, k, -4) for k in range(3))
        mb = MulBatch(self.fp)
        ry2Z = self.q_mul(mb, Qy, Z)
        rx2Z = self.q_mul(mb, Qx, Z)
        o = mb.run()
        th = self.sub(Y, ry2Z(o))
        lam = self.sub(X, rx2Z(o))

        mb = MulBatch(self.fp)
        rl2 = self.q_sqr(mb, lam)
        rth2 = self.q_sqr(mb, th)
        rtx = self.q_mul(mb, th, Qx)
        rly = self.q_mul(mb, lam, Qy)
        rA = self.q_mul_fp(mb, lam, yP)
        rC = self.q_mul_fp(mb, th, xP)
        o = mb.run()
        l2, th2 = rl2(o), rth2(o)
        DmB = self.sub(rtx(o), rly(o))
        A, C = rA(o), rC(o)

        mb = MulBatch(self.fp)
        rl3 = self.q_mul(mb, l2, lam)
        rG = self.q_mul(mb, X, l2)
        rZt = self.q_mul(mb, Z, th2)
        o = mb.run()
        l3, G, Zt = rl3(o), rG(o), rZt(o)
        H = self.sub(self.add(l3, Zt), self.dbl(G))

        mb = MulBatch(self.fp)
        rXn = self.q_mul(mb, lam, H)
        rYt = self.q_mul(mb, th, self.sub(G, H))
        rYl = self.q_mul(mb, Y, l3)
        rZn = self.q_mul(mb, Z, l3)
        o = mb.run()
        Yn = self.sub(rYt(o), rYl(o))
        return (A, DmB, self.neg(C)), _stack([rXn(o), Yn, rZn(o)], -4)

    # --------------------------------------------------------- constants ----
    def f12_one_like(self, lanes: int, device) -> Tensor:
        """The f12 one broadcast to (2, 3, 2, L, lanes)."""
        f = torch.zeros((2, 3, 2, self.L, lanes), dtype=torch.int64, device=device)
        f[0, 0, 0] = self.one.to(device)
        return f


# Base-field Montgomery products per routine, as the code above queues them
# (q_mul 3, q_sqr 2 when n == 1 else 3, q_mul_fp 2; the inverses without
# their fp_pow chain).  The kernels' operation counts in chip_smoke.py rest
# on these; tests/test_torch_pairing.py and tests/test_torch_final_exp.py
# count the products a run queues and hold them to these numbers.
def mults_per_step(n: int, twist: str) -> dict:
    sq = 2 if n == 1 else 3
    f6_inv = 3 * sq + 3 * 3 + 3 * 3 + 4 + 3 * 3  # c, norm, f2_inv, c / norm
    return {
        "f12_sqr": 36,
        "f12_mul": 54,
        "f12_sparse_mul": 3 * (14 if twist == "M" else 13),
        "dbl_step": 9 * 3 + 4 * sq + 2 * 2,
        "add_step": 11 * 3 + 2 * sq + 2 * 2,
        "f12_cyclo_sqr": 9 * sq,
        "f12_frob": 6 * 3,
        "f2_inv": 4,
        "f6_inv": f6_inv,
        "f12_inv": 2 * 18 + f6_inv + 2 * 18,
    }


def pow_mults(bits) -> int:
    """Products of ``fp_pow`` (or the f12 muls of a pow chain): one square
    per bit, one multiply per one bit."""
    return len(bits) + sum(1 for b in bits if b)


def f12_pow_mults(n: int, twist: str, bits, cyclo: bool) -> int:
    c = mults_per_step(n, twist)
    sq = c["f12_cyclo_sqr"] if cyclo else c["f12_sqr"]
    return len(bits) * sq + (pow_mults(bits) - len(bits)) * c["f12_mul"]


def final_exp_mults(n: int, twist: str, inv_bits, x_bits) -> int:
    """Products of one lane of the final exponentiation (``final_exp``):
    f12_inv with its fp_pow chain, 9 f12 muls, 1 f12 square, 3 Frobenius
    maps and 5 cyclotomic x-chains."""
    c = mults_per_step(n, twist)
    return (c["f12_inv"] + pow_mults(inv_bits) + 9 * c["f12_mul"] + c["f12_sqr"]
            + 3 * c["f12_frob"] + 5 * f12_pow_mults(n, twist, x_bits, True))


def final_exp_bn_mults(n: int, twist: str, inv_bits, digit_bits) -> int:
    """Products of one lane of BN's final exponentiation (``final_exp_bn``):
    the easy part (f12_inv with its fp_pow chain, 2 f12 muls, 1 Frobenius
    map), a cyclotomic chain a digit from f1 over the bits after its
    leading one, and a Frobenius map and an f12 mul for each digit after the
    first."""
    c = mults_per_step(n, twist)
    return (c["f12_inv"] + pow_mults(inv_bits) + 2 * c["f12_mul"] + c["f12_frob"]
            + sum(f12_pow_mults(n, twist, b[1:], True) for b in digit_bits)
            + (len(digit_bits) - 1) * (c["f12_frob"] + c["f12_mul"]))
