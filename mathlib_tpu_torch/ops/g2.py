"""Batched G2 group law on the sextic twist E'(Fp2) (port of ``mathlib_tpu/ops/g2.py``).

The complete RCB formulas of ``ops/weier.py`` over Fp2: a point batch is
``(..., 3, 2, L, B)``, stacking the (X, Y, Z) Fp2 coordinates in Montgomery
form; an affine point encodes with Z = 1 and infinity as (0 : 1 : 0), as in
the reference.

The split between kernels and ``weier`` is the reference's: curves with
beta = -1 and a small twist constant b3 = 3 b2 (BLS12-381, b3 = (12, 12);
FP256BN) send ``add``, ``double``, ``add_select``, ``dbl_add_select``,
``scalar_mul`` and the hash's static ladders to the kernel wrappers of
``kernels/g2_cuda.py`` (the CUDA kernels on a card, their plain versions on
the CPU; FP256BN's at nine words, its contexts holding L = 18 on a card).  The other curves
(BN254: b3 is not small; BLS12-377: beta = -5) run ``weier`` over
``Fp2Adapter``, whose products are ``TowerCtx.f2_mul`` (the ``mont_mul``
kernel on a card), and their ``scalar_mul`` is the reference's scan of
``dbl_add_select``.  The two routes give different relaxed limbs of the same
points.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec, Fp2Int
from ..host.fields import get_tower
from . import weier
from .field import FpCtx, ints_to_limbs, limb_tensor
from .kernels import g2_cuda
from .tower import TowerCtx

Tensor = torch.Tensor


def _stack(xs, dim: int) -> Tensor:
    return torch.stack(torch.broadcast_tensors(*xs), dim=dim)


class Fp2Adapter(weier.FieldAdapter):
    """weier.FieldAdapter over the port's ``TowerCtx`` Fp2 (stack axis -4)."""

    def __init__(self, tw: TowerCtx, b2: Fp2Int):
        self.tw = tw
        p = tw.spec.p
        self.b3 = ((3 * b2[0]) % p, (3 * b2[1]) % p)
        self._b3 = tw.f2_encode(self.b3)

    def add(self, a, b):
        return self.tw.f2_add(a, b)

    def sub(self, a, b):
        return self.tw.f2_sub(a, b)

    def mul_many(self, xs, ys):
        return tuple(self.tw.f2_mul(_stack(xs, -4), _stack(ys, -4)).unbind(-4))

    def add_many(self, xs, ys):
        return tuple(self.tw.f2_add(_stack(xs, -4), _stack(ys, -4)).unbind(-4))

    def sub_many(self, xs, ys):
        return tuple(self.tw.f2_sub(_stack(xs, -4), _stack(ys, -4)).unbind(-4))

    def mul_b3(self, a):
        return self.tw.f2_mul(a, self._b3)


class G2Ctx:
    """G2 over one curve, with its constant tensors on ``device``; its base
    field is its tower's (``base_limbs``, or ``L`` where given)."""

    def __init__(self, spec: CurveSpec, device=None, L: Optional[int] = None):
        self.spec = spec
        self.device = _device(device)
        self.tw = TowerCtx(spec, self.device, L)
        self.fp: FpCtx = self.tw.fp
        self.fr = FpCtx(spec.r, self.device, spec.name + "_fr")
        self.host = get_tower(spec)
        self.F = Fp2Adapter(self.tw, spec.b2)
        # the kernels' gate (the reference's _pallas_b3): beta = -1 and a
        # small twist constant; other curves run weier over Fp2Adapter
        b3 = self.F.b3
        small = spec.beta == spec.p - 1 and all(0 <= c < 256 for c in b3) and any(b3)
        self.rows: Optional[g2_cuda.Row2Adapter] = (
            g2_cuda.Row2Adapter(self.fp, b3) if small else None)
        self.gen = self.encode_point(spec.g2_gen)  # (3, 2, L, 1)
        self.inf = self.encode_point(None)
        self.nbits = spec.r.bit_length()

    # ------------------------------------------------------------ host <-> --
    def encode_point(self, P) -> Tensor:
        """Affine host ((x0, x1), (y0, y1)) or None -> (3, 2, L, 1)."""
        return self.encode_points([P])

    def encode_points(self, pts) -> Tensor:
        """List of N affine host points ((x0, x1), (y0, y1)) or None ->
        (3, 2, L, N) projective."""
        coords = [
            ((0, 0), (1, 0), (0, 0)) if P is None else (P[0], P[1], (1, 0)) for P in pts
        ]
        arr = np.array(coords, dtype=object).reshape(len(pts), 3, 2)
        return self.fp.encode(np.moveaxis(arr, 0, -1))

    def decode_points(self, arr) -> list:
        """(..., 3, 2, L, B) -> flat list of affine host points (None for
        infinity), lane-major."""
        d = self.fp.decode(arr)  # (..., 3, 2, B) ints
        d = d.reshape((-1,) + d.shape[-3:])
        t = self.host
        out = []
        for blk in d:
            for i in range(blk.shape[-1]):
                X, Y, Z = ((int(blk[c, 0, i]), int(blk[c, 1, i])) for c in range(3))
                if Z == (0, 0):
                    out.append(None)
                else:
                    zi = t.f2_inv(Z)
                    out.append((t.f2_mul(X, zi), t.f2_mul(Y, zi)))
        return out

    def decode_point(self, arr):
        """(3, 2, L) / (3, 2, L, 1) projective -> affine host point or None."""
        if arr.ndim == 3:
            arr = arr[..., None]
        return self.decode_points(arr)[0]

    def encode_scalars(self, scalars) -> Tensor:
        """Host ints shape S -> S[:-1] + (SL, S[-1]) plain 16-bit limbs mod r."""
        xs = np.asarray(scalars, dtype=object)
        if xs.ndim < 1:
            raise ValueError("encode_scalars wants a non-empty array")
        r = self.spec.r
        limbs = ints_to_limbs([int(k) % r for k in xs.reshape(-1)], self.fr.L)
        return limb_tensor(limbs, xs.shape, self.device)

    # ------------------------------------------------------------ group law -
    def is_inf(self, P: Tensor) -> Tensor:
        return self.tw.f2_is_zero(P[..., 2, :, :, :])

    def eq(self, P: Tensor, Q: Tensor) -> Tensor:
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        a, b, c, d = self.F.mul_many(
            [P[..., 0, :, :, :], Q[..., 0, :, :, :], P[..., 1, :, :, :], Q[..., 1, :, :, :]],
            [Q[..., 2, :, :, :], P[..., 2, :, :, :], Q[..., 2, :, :, :], P[..., 2, :, :, :]],
        )
        return self.tw.f2_eq(a, b) & self.tw.f2_eq(c, d)

    def select(self, mask: Tensor, P: Tensor, Q: Tensor) -> Tensor:
        """mask (..., B) ? P : Q over (..., 3, 2, L, B) point batches."""
        return torch.where(mask[..., None, None, None, :], P, Q)

    def neg(self, P: Tensor) -> Tensor:
        """-P for projective (..., 3, 2, L, B) points: Y negated."""
        out = P.clone()
        out[..., 1, :, :, :] = self.tw.f2_neg(P[..., 1, :, :, :])
        return out

    def _unstack(self, P: Tensor):
        return P[..., 0, :, :, :], P[..., 1, :, :, :], P[..., 2, :, :, :]

    def double(self, P: Tensor) -> Tensor:
        if self.rows is not None:
            return g2_cuda.double(self.rows, P)
        return torch.stack(weier.double_complete(self.F, self._unstack(P)), dim=-4)

    def add(self, P: Tensor, Q: Tensor) -> Tensor:
        if self.rows is not None:
            return g2_cuda.add(self.rows, P, Q)
        return torch.stack(weier.add_complete(self.F, self._unstack(P), self._unstack(Q)), dim=-4)

    def add_select(self, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
        """select(sel, P + Q, Q): one kernel on the gated curves (the add's
        half of the G2 ladder's step, the select at its store)."""
        if self.rows is not None:
            return g2_cuda.addsel(self.rows, P, Q, sel)
        return self.select(sel, self.add(P, Q), Q)

    def dbl_add_select(self, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
        """select(sel, 2P + Q, 2P) -- the scalar-mul inner step, one kernel on
        the gated curves."""
        if self.rows is not None:
            return g2_cuda.dblsel(self.rows, P, Q, sel)
        acc = self.double(P)
        return self.select(sel, self.add(acc, Q), acc)

    def sub(self, P: Tensor, Q: Tensor) -> Tensor:
        return self.add(P, self.neg(Q))

    # ---------------------------------------------------------- scalar mul --
    def scalar_mul(self, P: Tensor, scalars: Tensor) -> Tensor:
        """[k]P, batched, over r.bit_length() bits: the whole ladder in one
        kernel launch on the gated curves, else the reference's scan of
        ``dbl_add_select`` from infinity."""
        nbits = self.nbits
        if self.rows is not None:
            return g2_cuda.smul(self.rows, P, scalars, nbits)
        lanes = torch.broadcast_shapes(P.shape[-1:], scalars.shape[-1:])
        lead = torch.broadcast_shapes(P.shape[:-4], scalars.shape[:-2])
        acc = self.inf.expand(lead + P.shape[-4:-1] + lanes)
        for i in range(nbits - 1, -1, -1):
            acc = self.dbl_add_select(acc, P, g2_cuda.scalar_bit(scalars, i))
        return acc

    def to_affine(self, P: Tensor) -> Tuple[Tensor, Tensor]:
        """Batched projective -> affine (x, y); infinity maps to (0, 0).  One
        Fp2 inverse of Z a lane (``TowerCtx.f2_inv``: one ``fp_pow`` chain on
        a card), then two products."""
        t = self.tw
        zi = t.f2_inv(P[..., 2, :, :, :])
        x, y = self.F.mul_many([P[..., 0, :, :, :], P[..., 1, :, :, :]], [zi, zi])
        fin = ~self.is_inf(P)
        zero = torch.zeros_like(x)
        return t.f2_select(fin, x, zero), t.f2_select(fin, y, zero)

    def sum_reduce(self, P: Tensor) -> Tensor:
        """Tree-reduce a point batch along the lane axis -> (..., 3, 2, L, 1)."""
        n = P.shape[-1]
        while n > 1:
            half = n // 2
            combined = self.add(P[..., 0 : 2 * half : 2], P[..., 1 : 2 * half : 2])
            if n % 2:
                combined = torch.cat([combined, P[..., 2 * half :]], dim=-1)
            P = combined
            n = P.shape[-1]
        return P


@lru_cache(maxsize=None)
def get_g2_ctx(spec: CurveSpec, device=None) -> G2Ctx:
    """One G2Ctx per curve and device (the card unless ``device="cpu"``)."""
    return G2Ctx(spec, _device(device))
