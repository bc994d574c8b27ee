"""Batched tower-field arithmetic, Fp2/Fp6/Fp12 (port of ``mathlib_tpu/ops/tower.py``).

Layout (lane batch B last, limbs before it), as in the reference:

    Fp2:  (..., 2, L, B)          c0 + c1*u,  u^2 = beta
    Fp6:  (..., 3, 2, L, B)       a0 + a1*v + a2*v^2,  v^3 = xi
    Fp12: (..., 2, 3, 2, L, B)    b0 + b1*w,  w^2 = v

This is PyTorch on ``FpCtx``, for the CPU and for glue; it computes what
the reference's ``TowerCtx`` computes.  Its Montgomery products go to the
``mont_mul`` kernel on a card (``_mul``), as the reference's reach its Pallas
product on a TPU; adds and subs are plain tensor ops, as there.  The pairing kernels do not use
it: they follow the reference's in-kernel tower (``kernels/tower_rows.py``),
whose relaxed limbs differ.  The host tower (``host/fields.py``) is the
exactness oracle.

``f12_final_exp`` is one ``final_exp`` kernel launch on both families:
BLS12 curves' factor-3 chain, and on BN curves the easy part, one cyclotomic
chain per base-p digit of the hard exponent and their Frobenius products,
the whole of what the reference runs on a TPU as XLA ops around its
``fp_pow`` kernel and one ``f12_pow`` kernel a digit.

The Gt helpers: ``f12_zero``, ``f12_add``, ``f12_sub``, ``f12_neg`` and
``f12_select`` are the reference's one-liners; ``f12_pow_bits`` (a shared,
static exponent) is one ``f12_pow`` kernel launch with general squaring,
where the reference runs an XLA scan; ``f12_pow_scalars`` (per-lane
scalars) runs the reference's scan on these tower ops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec, Family, hard_part_digits
from ..host.fields import get_tower as get_host_tower
from .field import LIMB_BITS, FpCtx
from .kernels import fexp_prog, fp_cuda, pairing_cuda
from .kernels.tower_rows import RowTower

Tensor = torch.Tensor


def _stack(xs, dim: int) -> Tensor:
    return torch.stack(torch.broadcast_tensors(*xs), dim=dim)


class TowerCtx:
    def __init__(self, spec: CurveSpec, device=None):
        self.spec = spec
        self.device = _device(device)
        self.fp = FpCtx(spec.p, self.device, spec.name)
        self.host = get_host_tower(spec)
        self.beta = spec.beta  # int mod p (a small negative residue)
        x0, x1 = spec.xi
        if x1 != 1:
            raise ValueError("the tower assumes xi = xi0 + u")
        self.xi0 = x0
        # Frobenius constants gamma_n[k, j] for the coefficient of v^j w^k,
        # n in {1, 2, 3}: (v^j w^k)^(p^n) = gamma * v^j w^k, from the host
        # tower, as (2, 3, 2, L, 1) Montgomery limbs laid out as an f12
        t = self.host
        self.frob_limbs = {}
        for n in (1, 2, 3):
            gam = np.empty((2, 3, 2, 1), dtype=object)
            for k in range(2):
                for j in range(3):
                    c6 = [[(0, 0)] * 3 for _ in range(2)]
                    c6[k][j] = (1, 0)
                    gam[k, j, :, 0] = t.f12_frob((tuple(c6[0]), tuple(c6[1])), n)[k][j]
            self.frob_limbs[n] = self.fp.encode(gam)
        beta_neg = (spec.p - spec.beta) % spec.p
        if not 0 < beta_neg < 256 or not 0 <= x0 < 256:
            raise ValueError("the in-kernel tower takes beta = -n and xi = xi0 + u, n and xi0 small")
        # what the tower kernels need of this curve (PairingCtx's MillerCfg
        # holds it): BLS12's x, or BN's base-p digits of the hard exponent
        bls = spec.family == Family.BLS12
        self.kcfg = pairing_cuda.TowerCfg(
            RowTower(self.fp, beta_neg, x0, spec.twist),
            gammas=torch.stack([self.frob_limbs[n] for n in (1, 2, 3)]),
            x=spec.x if bls else None,
            digits=None if bls else hard_part_digits(spec),
        )

    # ---------------------------------------------------------------- Fp2 ---
    def f2_encode(self, a: Tuple[int, int]) -> Tensor:
        """Host pair -> (2, L, 1) Montgomery limbs."""
        return self.fp.encode(np.array([[a[0]], [a[1]]], dtype=object))

    @property
    def f2_one(self) -> Tensor:
        return self.f2_encode((1, 0))

    @property
    def f2_zero(self) -> Tensor:
        return self.f2_encode((0, 0))

    def _c(self, a: Tensor, i: int) -> Tensor:
        return a[..., i, :, :]

    def f2_add(self, a, b):
        return self.fp.add(*torch.broadcast_tensors(a, b))

    def f2_sub(self, a, b):
        return self.fp.sub(*torch.broadcast_tensors(a, b))

    def f2_neg(self, a):
        return self.fp.neg(a)

    def f2_conj(self, a):
        return _stack([self._c(a, 0), self.fp.neg(self._c(a, 1))], -3)

    def _mul(self, a, b):
        """Montgomery products of broadcast limb tensors: the ``mont_mul``
        kernel on a card, its plain version on the CPU."""
        return fp_cuda.mont_mul(self.fp, *torch.broadcast_tensors(a, b))

    def f2_mul(self, a, b):
        """Karatsuba: 3 base muls, stacked into one call."""
        fp = self.fp
        a0, a1 = self._c(a, 0), self._c(a, 1)
        b0, b1 = self._c(b, 0), self._c(b, 1)
        lhs = _stack([a0, a1, fp.add(a0, a1)], -3)
        rhs = _stack([b0, b1, fp.add(b0, b1)], -3)
        m = self._mul(lhs, rhs)
        t0, t1, t2 = self._c(m, 0), self._c(m, 1), self._c(m, 2)
        c0 = fp.add(t0, fp.mul_int(t1, self.beta))
        c1 = fp.sub(t2, fp.add(t0, t1))
        return _stack([c0, c1], -3)

    def f2_sqr(self, a):
        return self.f2_mul(a, a)

    def f2_mul_fp(self, a, s):
        """a * s with s a base-field element (..., L, B)."""
        return self._mul(a, s.unsqueeze(-3))

    def f2_mul_xi(self, a):
        """a * (xi0 + u):  (xi0*a0 + beta*a1, xi0*a1 + a0)."""
        fp = self.fp
        a0, a1 = self._c(a, 0), self._c(a, 1)
        c0 = fp.add(fp.mul_int(a0, self.xi0), fp.mul_int(a1, self.beta))
        c1 = fp.add(fp.mul_int(a1, self.xi0), a0)
        return _stack([c0, c1], -3)

    def f2_inv(self, a):
        """1/a via the norm: (a0 - a1 u) / (a0^2 - beta a1^2); the base-field
        inverse is ``FpCtx.inv`` (the ``fp_pow`` kernel on a card)."""
        fp = self.fp
        sq = self._mul(a, a)
        norm = fp.sub(self._c(sq, 0), fp.mul_int(self._c(sq, 1), self.beta))
        m = self._mul(a, fp.inv(norm).unsqueeze(-3))
        return _stack([self._c(m, 0), fp.neg(self._c(m, 1))], -3)

    def f2_is_zero(self, a) -> Tensor:
        """(..., 2, L, B) -> (..., B) bool: a = 0 for relaxed [0, 2p) values."""
        return self.fp.is_zero(self._c(a, 0)) & self.fp.is_zero(self._c(a, 1))

    def f2_eq(self, a, b) -> Tensor:
        return self.f2_is_zero(self.f2_sub(a, b))

    def f2_select(self, mask, a, b):
        """mask (..., B) ? a : b over (..., 2, L, B) elements."""
        return torch.where(mask[..., None, None, :], a, b)

    def f2_mul_const(self, a, c: Tuple[int, int]):
        """a * (c0 + c1 u) for a host constant."""
        return self.f2_mul(a, self.f2_encode(c))

    # ---------------------------------------------------------------- Fp6 ---
    def _v(self, a: Tensor, i: int) -> Tensor:
        return a[..., i, :, :, :]

    def f6_add(self, a, b):
        return self.fp.add(*torch.broadcast_tensors(a, b))

    def f6_sub(self, a, b):
        return self.fp.sub(*torch.broadcast_tensors(a, b))

    def f6_neg(self, a):
        return self.fp.neg(a)

    def f6_mul(self, a, b):
        """Toom/Karatsuba: 6 Fp2 muls, stacked into one f2_mul call."""
        f2a, f2s = self.f2_add, self.f2_sub
        a0, a1, a2 = (self._v(a, i) for i in range(3))
        b0, b1, b2 = (self._v(b, i) for i in range(3))
        lhs = _stack([a0, a1, a2, f2a(a1, a2), f2a(a0, a1), f2a(a0, a2)], -4)
        rhs = _stack([b0, b1, b2, f2a(b1, b2), f2a(b0, b1), f2a(b0, b2)], -4)
        m = self.f2_mul(lhs, rhs)
        t0, t1, t2, m12, m01, m02 = (self._v(m, i) for i in range(6))
        c0 = f2a(t0, self.f2_mul_xi(f2s(f2s(m12, t1), t2)))
        c1 = f2a(f2s(f2s(m01, t0), t1), self.f2_mul_xi(t2))
        c2 = f2a(f2s(f2s(m02, t0), t2), t1)
        return _stack([c0, c1, c2], -4)

    def f6_sqr(self, a):
        return self.f6_mul(a, a)

    def f6_mul_v(self, a):
        """a * v: (xi*a2, a0, a1)."""
        return _stack([self.f2_mul_xi(self._v(a, 2)), self._v(a, 0), self._v(a, 1)], -4)

    def f6_inv(self, a):
        """The reference's adjugate formula, its six and three Fp2 products
        each stacked into one ``f2_mul`` call."""
        f2a, f2s, mx = self.f2_add, self.f2_sub, self.f2_mul_xi
        a0, a1, a2 = (self._v(a, i) for i in range(3))
        m = self.f2_mul(_stack([a0, a1, a2, a0, a1, a0], -4), _stack([a0, a2, a2, a1, a1, a2], -4))
        a00, a12, a22, a01, a11, a02 = (self._v(m, i) for i in range(6))
        c = _stack([f2s(a00, mx(a12)), f2s(mx(a22), a01), f2s(a11, a02)], -4)
        n = self.f2_mul(_stack([a0, a2, a1], -4), c)  # a0 c0, a2 c1, a1 c2
        norm = f2a(self._v(n, 0), mx(f2a(self._v(n, 1), self._v(n, 2))))
        return self.f2_mul(c, self.f2_inv(norm).unsqueeze(-4))

    # --------------------------------------------------------------- Fp12 ---
    def f12_encode(self, a) -> Tensor:
        """Host Fp12 tuple -> (2, 3, 2, L, 1) Montgomery limbs."""
        coeffs = [[c0, c1] for f6 in a for (c0, c1) in f6]
        return self.fp.encode(np.array(coeffs, dtype=object).reshape(2, 3, 2, 1))

    def f12_decode(self, arr) -> list:
        """(2, 3, 2, L, B) -> list of B host Fp12 tuples (canonical ints)."""
        a = np.asarray(arr.detach().cpu() if isinstance(arr, Tensor) else arr)
        a = a.astype(np.int64) & 0xFFFFFFFF
        if (a >> LIMB_BITS).any():
            raise ValueError("f12_decode wants 16-bit limbs")
        L, B = a.shape[-2:]
        p = self.fp.p
        rinv = pow(self.fp.R, -1, p)
        # (B, 2, 3, 2, L) row-major -> one 2L-byte little-endian string each
        buf = np.moveaxis(a, -1, 0).astype("<u2").tobytes()
        step = 2 * L
        vals = [
            int.from_bytes(buf[k * step : (k + 1) * step], "little") * rinv % p
            for k in range(B * 12)
        ]
        return [
            tuple(
                tuple((vals[12 * i + (h * 3 + j) * 2], vals[12 * i + (h * 3 + j) * 2 + 1])
                      for j in range(3))
                for h in range(2)
            )
            for i in range(B)
        ]

    @property
    def f12_one(self) -> Tensor:
        return self.f12_encode(self.host.F12_ONE)

    @property
    def f12_zero(self) -> Tensor:
        return self.f12_encode(self.host.F12_ZERO)

    def _h(self, a, i):
        return a[..., i, :, :, :, :]

    def f12_add(self, a, b):
        return self.fp.add(*torch.broadcast_tensors(a, b))

    def f12_sub(self, a, b):
        return self.fp.sub(*torch.broadcast_tensors(a, b))

    def f12_neg(self, a):
        return self.fp.neg(a)

    def f12_select(self, mask, a, b):
        """mask (..., B) ? a : b over (..., 2, 3, 2, L, B) elements."""
        return torch.where(mask[..., None, None, None, None, :], a, b)

    def f12_conj(self, a):
        return _stack([self._h(a, 0), self.f6_neg(self._h(a, 1))], -5)

    def f12_inv(self, a):
        """1/a = (a0 - a1 w) / (a0^2 - v a1^2)."""
        a0, a1 = self._h(a, 0), self._h(a, 1)
        sq = self.f6_sqr(_stack([a0, a1], -5))
        norm = self.f6_sub(self._h(sq, 0), self.f6_mul_v(self._h(sq, 1)))
        ninv = self.f6_inv(norm)
        return self.f6_mul(_stack([a0, self.f6_neg(a1)], -5), ninv.unsqueeze(-5))

    def f12_frob(self, a, n: int = 1):
        """a^(p^n) for n in {1, 2, 3}: conjugate every coefficient (n odd),
        then scale coefficient (k, j) by gamma[n][j, k], one stacked f2_mul."""
        if n not in (1, 2, 3):
            raise ValueError(f"f12_frob takes n in (1, 2, 3), got {n}")
        if n % 2:
            a = self.f2_conj(a)
        return self.f2_mul(a, self.frob_limbs[n])

    def f12_mul(self, a, b):
        """Karatsuba over Fp6: 3 f6 muls, stacked into one f6_mul call."""
        a0, a1 = self._h(a, 0), self._h(a, 1)
        b0, b1 = self._h(b, 0), self._h(b, 1)
        lhs = _stack([a0, a1, self.f6_add(a0, a1)], -5)
        rhs = _stack([b0, b1, self.f6_add(b0, b1)], -5)
        m = self.f6_mul(lhs, rhs)
        t0, t1, ts = (m[..., i, :, :, :, :] for i in range(3))
        c0 = self.f6_add(t0, self.f6_mul_v(t1))
        c1 = self.f6_sub(ts, self.f6_add(t0, t1))
        return _stack([c0, c1], -5)

    def f12_sqr(self, a):
        """Complex squaring over Fp6: 2 f6 muls in one stacked call."""
        a0, a1 = self._h(a, 0), self._h(a, 1)
        lhs = _stack([a0, self.f6_add(a0, a1)], -5)
        rhs = _stack([a1, self.f6_add(a0, self.f6_mul_v(a1))], -5)
        m = self.f6_mul(lhs, rhs)
        t, m1 = m[..., 0, :, :, :, :], m[..., 1, :, :, :, :]
        c0 = self.f6_sub(self.f6_sub(m1, t), self.f6_mul_v(t))
        return _stack([c0, self.f6_add(t, t)], -5)

    def f12_is_one(self, a) -> Tensor:
        """(..., 2, 3, 2, L, B) -> (..., B) bool: a == 1 in Fp12."""
        diff = self.fp.sub(*torch.broadcast_tensors(a, self.f12_one))
        zero = (diff == 0).all(dim=-2) | (diff == self.fp.p_limbs.to(torch.int32)).all(dim=-2)
        return zero.all(dim=-2).all(dim=-2).all(dim=-2)

    # ----------------------------------------------------------------- Gt --
    def f12_pow_bits(self, a, bits):
        """a^e for one shared, static exponent e, its bits little-endian (the
        reference's order): one ``f12_pow`` kernel launch with general
        squaring, its plain version on the CPU.  Leading dimensions before
        (2, 3, 2, L, B) ride along as lanes."""
        msb = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8)[::-1])
        shape, k = a.shape, math.prod(a.shape[:-5])
        cols = shape[-5:-1] + (k, shape[-1])  # explicit sizes: B = 0 too
        lanes = a.reshape((k,) + shape[-5:]).movedim(0, -2).reshape(shape[-5:-1] + (k * shape[-1],))
        out = pairing_cuda.f12_pow(self.kcfg, lanes.contiguous(), msb, cyclo=False)
        return out.reshape(cols).movedim(-2, 0).reshape(shape)

    def f12_pow_scalars(self, a, scalars, nbits: Optional[int] = None):
        """a^k with per-lane scalars (..., S, B) of plain 16-bit limbs (the
        Gt.Exp surface): the reference's fixed trip count of ``nbits``
        (default: r's bit length) squarings, each followed by a multiply
        kept where the lane's bit is set, on this context's tower ops."""
        nbits = nbits or self.spec.r.bit_length()
        acc = torch.broadcast_to(self.f12_one, a.shape)
        for idx in range(nbits - 1, -1, -1):
            word = scalars.select(-2, idx // LIMB_BITS)
            bit = ((word >> (idx % LIMB_BITS)) & 1).bool()
            acc = self.f12_sqr(acc)
            acc = self.f12_select(bit, self.f12_mul(acc, a), acc)
        return acc

    def _f12_exp_pos(self, a, e: int):
        """a^e for a static positive int, unrolled square-and-multiply (no
        masked multiplies; e = 0 gives a, as the reference's does)."""
        acc = a
        for bit in bin(e)[3:]:
            acc = self.f12_sqr(acc)
            if bit == "1":
                acc = self.f12_mul(acc, a)
        return acc

    # ------------------------------------------------------------ final exp --
    def f12_final_exp(self, f):
        """The pairing final exponentiation of each lane of f (2, 3, 2, L, B),
        equal to the host engine's (``host/fields.py f12_final_exp``).

        One ``final_exp`` kernel launch on both families, the easy part
        f^((p^6 - 1)(p^2 + 1)) with the in-kernel Fp12 inverse first.  BLS12
        curves with the factor-3 convention: the hard part as five cyclotomic
        x-chains, by 3 (p^4 - p^2 + 1)/r = (x-1)^2 (x + p) (x^2 + p^2 - 1) + 3.
        BN curves: the hard part as prod_i frob^i(f^(d_i)) over the base-p
        digits d_i, one cyclotomic chain per digit (f is unitary after the
        easy part)."""
        spec, kcfg = self.spec, self.kcfg
        if spec.family == Family.BLS12 and spec.fexp_factor != 3:
            raise NotImplementedError(f"{spec.name}: only the factor-3 BLS12 final exp is ported")
        if spec.family != Family.BLS12 and len(kcfg.digits) > fexp_prog.BN_DIGITS:
            raise NotImplementedError(
                f"{spec.name}: the hard part has {len(kcfg.digits)} base-p digits; the "
                "reference's table multi-exponentiation for more than 4 is not ported")
        return pairing_cuda.final_exp(kcfg, f.contiguous())
