"""Batched G1 group law in homogeneous projective coordinates
(port of ``mathlib_tpu/ops/g1.py``).

A point batch is a ``(..., 3, L, B)`` int32 tensor stacking (X, Y, Z) limb
planes (Montgomery, relaxed form) with the batch B last.  Infinity is
(0 : 1 : 0).  ``add``, ``double``, ``add_select`` and ``scalar_mul`` go
through the kernel wrappers of ``kernels/g1_cuda.py``: the CUDA kernels for
CUDA tensors, their plain PyTorch versions for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec
from . import weier
from .field import FpCtx, ints_to_limbs, limb_tensor
from .kernels import g1_cuda

Tensor = torch.Tensor


class FpAdapter(weier.FieldAdapter):
    """weier.FieldAdapter over a base-field FpCtx (stack axis -3)."""

    def __init__(self, fp: FpCtx, b: int):
        self.fp = fp
        self.b3 = (3 * b) % fp.p

    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    @staticmethod
    def _zip(xs, ys):
        a = torch.stack(torch.broadcast_tensors(*xs), dim=-3)
        b = torch.stack(torch.broadcast_tensors(*ys), dim=-3)
        return torch.broadcast_tensors(a, b)

    def mul_many(self, xs, ys):
        return tuple(self.fp.mont_mul(*self._zip(xs, ys)).unbind(-3))

    def add_many(self, xs, ys):
        return tuple(self.fp.add(*self._zip(xs, ys)).unbind(-3))

    def sub_many(self, xs, ys):
        return tuple(self.fp.sub(*self._zip(xs, ys)).unbind(-3))

    def mul_b3(self, a):
        return self.fp.mul_int(a, self.b3)


class G1Ctx:
    """G1 over one curve, with its constant tensors on ``device``."""

    def __init__(self, spec: CurveSpec, device=None):
        self.spec = spec
        self.device = _device(device)
        self.fp = FpCtx(spec.p, self.device, spec.name)
        self.fr = FpCtx(spec.r, self.device, spec.name + "_fr")
        self.F = FpAdapter(self.fp, spec.b)
        self.gen = self.encode_point(spec.g1_gen)  # (3, L, 1)
        self.inf = self.encode_point(None)
        self.nbits = spec.r.bit_length()

    # ------------------------------------------------------------ host <-> --
    def encode_point(self, P: Optional[Tuple[int, int]]) -> Tensor:
        """Affine host point (or None for infinity) -> (3, L, 1) projective."""
        return self.encode_points([P])

    def encode_points(self, pts) -> Tensor:
        """List of N host points -> (3, L, N)."""
        coords = [(0, 1, 0) if P is None else (P[0], P[1], 1) for P in pts]
        return self.fp.encode(np.array(coords, dtype=object).T)

    def decode_point(self, arr) -> Optional[Tuple[int, int]]:
        """(3, L) / (3, L, 1) projective -> affine host point or None."""
        if arr.ndim == 2:
            arr = arr[..., None]
        return self.decode_points(arr)[0]

    def decode_points(self, arr) -> list:
        """(..., 3, L, B) -> flat list of host points (lane-major)."""
        p = self.spec.p
        coords = self.fp.decode(arr)  # (..., 3, B) object
        out = []
        for blk in coords.reshape(-1, 3, coords.shape[-1]):
            for X, Y, Z in zip(*blk):
                if Z == 0:
                    out.append(None)
                elif Z == 1:
                    out.append((X, Y))
                else:
                    zi = pow(Z, p - 2, p)
                    out.append((X * zi % p, Y * zi % p))
        return out

    def encode_scalars(self, scalars) -> Tensor:
        """Host ints shape S -> S[:-1] + (SL, S[-1]) plain 16-bit limbs mod r."""
        xs = np.asarray(scalars, dtype=object)
        if xs.ndim < 1:
            raise ValueError("encode_scalars wants a non-empty array")
        r = self.spec.r
        limbs = ints_to_limbs([int(k) % r for k in xs.reshape(-1)], self.fr.L)
        return limb_tensor(limbs, xs.shape, self.device)

    # ------------------------------------------------------------ predicates
    def is_inf(self, P: Tensor) -> Tensor:
        return self.fp.is_zero(P[..., 2, :, :])

    def select(self, mask: Tensor, P: Tensor, Q: Tensor) -> Tensor:
        """mask (..., B) ? P : Q."""
        return torch.where(mask[..., None, None, :], P, Q)

    # ------------------------------------------------------------- group law
    def neg(self, P: Tensor) -> Tensor:
        out = P.clone()
        out[..., 1, :, :] = self.fp.neg(P[..., 1, :, :])
        return out

    def double(self, P: Tensor) -> Tensor:
        return g1_cuda.double(self.F, P)

    def add(self, P: Tensor, Q: Tensor) -> Tensor:
        return g1_cuda.add(self.F, P, Q)

    def add_select(self, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
        """select(sel, P + Q, Q) -- the segmented-scan combiner, one kernel."""
        return g1_cuda.addsel(self.F, P, Q, sel)

    def dbl_add_select(self, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
        """select(sel, 2P + Q, 2P) -- one scalar-mul step (two kernels)."""
        acc = self.double(P)
        return self.select(sel, self.add(acc, Q), acc)

    def scalar_mul(self, P: Tensor, scalars: Tensor) -> Tensor:
        """[k]P, batched; fixed trip count r.bit_length(), whole ladder in one
        kernel launch on a card."""
        return g1_cuda.smul(self.F, P, scalars, self.nbits)

    def sum_reduce(self, P: Tensor) -> Tensor:
        """Tree-reduce a point batch along the lane axis -> (..., 3, L, 1)."""
        n = P.shape[-1]
        while n > 1:
            half = n // 2
            combined = self.add(P[..., 0 : 2 * half : 2], P[..., 1 : 2 * half : 2])
            if n % 2:
                combined = torch.cat([combined, P[..., 2 * half :]], dim=-1)
            P = combined
            n = P.shape[-1]
        return P
