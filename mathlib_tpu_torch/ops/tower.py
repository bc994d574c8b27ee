"""Batched tower-field arithmetic, Fp2/Fp6/Fp12 (port of ``mathlib_tpu/ops/tower.py``,
the part the pairing-product check needs).

Layout (lane batch B last, limbs before it), as in the reference:

    Fp2:  (..., 2, L, B)          c0 + c1*u,  u^2 = beta
    Fp6:  (..., 3, 2, L, B)       a0 + a1*v + a2*v^2,  v^3 = xi
    Fp12: (..., 2, 3, 2, L, B)    b0 + b1*w,  w^2 = v

This is plain PyTorch on ``FpCtx``, for the CPU and for glue; it computes
what the reference's ``TowerCtx`` computes, limb for limb.  The pairing
kernels do not use it: they follow the reference's in-kernel tower
(``kernels/tower_rows.py``), whose relaxed limbs differ.  The host tower
(``host/fields.py``) is the exactness oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec
from ..host.fields import get_tower as get_host_tower
from .field import LIMB_BITS, FpCtx

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

    # ---------------------------------------------------------------- Fp2 ---
    def f2_encode(self, a: Tuple[int, int]) -> Tensor:
        """Host pair -> (2, L, 1) Montgomery limbs."""
        return self.fp.encode(np.array([[a[0]], [a[1]]], dtype=object))

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

    def f2_mul(self, a, b):
        """Karatsuba: 3 base muls, stacked into one call."""
        fp = self.fp
        a0, a1 = self._c(a, 0), self._c(a, 1)
        b0, b1 = self._c(b, 0), self._c(b, 1)
        lhs = _stack([a0, a1, fp.add(a0, a1)], -3)
        rhs = _stack([b0, b1, fp.add(b0, b1)], -3)
        m = fp.mont_mul(*torch.broadcast_tensors(lhs, rhs))
        t0, t1, t2 = self._c(m, 0), self._c(m, 1), self._c(m, 2)
        c0 = fp.add(t0, fp.mul_int(t1, self.beta))
        c1 = fp.sub(t2, fp.add(t0, t1))
        return _stack([c0, c1], -3)

    def f2_sqr(self, a):
        return self.f2_mul(a, a)

    def f2_mul_xi(self, a):
        """a * (xi0 + u):  (xi0*a0 + beta*a1, xi0*a1 + a0)."""
        fp = self.fp
        a0, a1 = self._c(a, 0), self._c(a, 1)
        c0 = fp.add(fp.mul_int(a0, self.xi0), fp.mul_int(a1, self.beta))
        c1 = fp.add(fp.mul_int(a1, self.xi0), a0)
        return _stack([c0, c1], -3)

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

    def _h(self, a, i):
        return a[..., i, :, :, :, :]

    def f12_conj(self, a):
        return _stack([self._h(a, 0), self.f6_neg(self._h(a, 1))], -5)

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
