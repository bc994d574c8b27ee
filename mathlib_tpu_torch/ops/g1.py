"""Batched G1 group law in homogeneous projective coordinates
(port of ``mathlib_tpu/ops/g1.py``).

A point batch is a ``(..., 3, L, B)`` int32 tensor stacking (X, Y, Z) limb
planes (Montgomery, relaxed form) with the batch B last.  Infinity is
(0 : 1 : 0).  ``add``, ``double``, ``add_select``, ``dbl_add_select``,
``add_select_neg``, ``madd_select(_neg)`` and ``scalar_mul`` go through the
kernel wrappers of ``kernels/g1_cuda.py``; the products of ``eq`` and
``to_affine`` go through ``FpCtx.mont_mul`` and its inverse through
``FpCtx.batch_inv``: the CUDA kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors.  Affine points are ``(..., 2, L, B)`` with
infinity as (0, 0).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec
from . import weier
from .field import FpCtx, base_limbs, ints_to_limbs, limb_tensor
from .kernels import g1_cuda

Tensor = torch.Tensor


class FpAdapter(weier.FieldAdapter):
    """weier.FieldAdapter over a base-field FpCtx (stack axis -3).  Its
    products go to ``FpCtx.mont_mul`` (the ``mont_mul`` kernel on a card);
    ``plain`` is its twin on ``FpCtx.mont_mul_plain``, which the plain
    versions of the G1 kernels use on every device."""

    def __init__(self, fp: FpCtx, b: int, plain: bool = False):
        self.fp = fp
        self.b3 = (3 * b) % fp.p
        self._mul = fp.mont_mul_plain if plain else fp.mont_mul
        self.plain = self if plain else FpAdapter(fp, b, plain=True)

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
        return tuple(self._mul(*self._zip(xs, ys)).unbind(-3))

    def add_many(self, xs, ys):
        return tuple(self.fp.add(*self._zip(xs, ys)).unbind(-3))

    def sub_many(self, xs, ys):
        return tuple(self.fp.sub(*self._zip(xs, ys)).unbind(-3))

    def mul_b3(self, a):
        return self.fp.mul_int(a, self.b3)


class G1Ctx:
    """G1 over one curve, with its constant tensors on ``device``; its base
    field at ``base_limbs`` (L = 18 for FP256BN on a card, or ``L`` where
    given)."""

    def __init__(self, spec: CurveSpec, device=None, L: Optional[int] = None):
        self.spec = spec
        self.device = _device(device)
        self.fp = FpCtx(spec.p, self.device, spec.name, L=base_limbs(spec.p, self.device, L))
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

    def encode_points_affine(self, pts) -> Tensor:
        """List of N host affine points -> (2, L, N) affine rows, in one
        Montgomery encode and one limb pass.  Infinity encodes as (0, 0); MSM
        callers must zero its scalars (the affine scan has no absorbing
        representation)."""
        coords = [(0, 0) if P is None else (P[0], P[1]) for P in pts]
        return self.fp.encode(np.array(coords, dtype=object).reshape(len(coords), 2).T)

    def decode_points_affine(self, xy) -> list:
        """Affine rows (..., 2, L, B) -> flat list of host points; (0, 0)
        decodes to infinity (not a curve point for b != 0)."""
        coords = self.fp.decode(xy)  # (..., 2, B) object
        return [
            None if X == 0 and Y == 0 else (X, Y)
            for blk in coords.reshape(-1, 2, coords.shape[-1])
            for X, Y in zip(*blk)
        ]

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

    def eq(self, P: Tensor, Q: Tensor) -> Tensor:
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        a, b, c, d = self.F.mul_many(
            [P[..., 0, :, :], Q[..., 0, :, :], P[..., 1, :, :], Q[..., 1, :, :]],
            [Q[..., 2, :, :], P[..., 2, :, :], Q[..., 2, :, :], P[..., 2, :, :]],
        )
        return self.fp.eq(a, b) & self.fp.eq(c, d)

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

    def add_select(self, P: Tensor, Q: Tensor, sel: Tensor,
                   out: Optional[Tensor] = None) -> Tensor:
        """select(sel, P + Q, Q) -- the segmented-scan combiner, one kernel;
        written into ``out`` if given, as ``g1_cuda.addsel`` takes it."""
        return g1_cuda.addsel(self.F, P, Q, sel, out)

    def dbl_add_select(self, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
        """select(sel, 2P + Q, 2P) -- one scalar-mul step, one kernel."""
        return g1_cuda.dbladd(self.F, P, Q, sel)

    def add_select_neg(self, P: Tensor, Q: Tensor, sel: Tensor, neg: Tensor,
                       out: Optional[Tensor] = None) -> Tensor:
        """select(sel, P + Q', Q') with Q' = (neg ? -Q : Q) -- the signed-digit
        MSM combiner, the negation inside the kernel; written into ``out``
        if given."""
        return g1_cuda.addselneg(self.F, P, Q, sel, neg, out)

    def _lift(self, Q: Tensor) -> Tensor:
        """Affine (..., 2, L, B) -> projective with Z = 1."""
        return g1_cuda.lift(self.F, Q)

    def madd_select(self, P: Tensor, Q: Tensor, sel: Tensor,
                    out: Optional[Tensor] = None) -> Tensor:
        """select(sel, P + lift(Q), lift(Q)) with Q AFFINE (..., 2, L, B): the
        mixed-add MSM combiner (11 field muls, 2L-word rows), written into
        ``out`` if given.  Q must not be infinity on a selected lane."""
        return g1_cuda.maddsel(self.F, P, Q, sel, out)

    def madd_select_neg(self, P: Tensor, Q: Tensor, sel: Tensor, neg: Tensor,
                        out: Optional[Tensor] = None) -> Tensor:
        """The mixed-add combiner with the negation of the signed digits,
        written into ``out`` if given."""
        return g1_cuda.maddselneg(self.F, P, Q, sel, neg, out)

    def sub(self, P: Tensor, Q: Tensor) -> Tensor:
        return self.add(P, self.neg(Q))

    def scalar_mul(self, P: Tensor, scalars: Tensor) -> Tensor:
        """[k]P, batched; fixed trip count r.bit_length(), whole ladder in one
        kernel launch on a card."""
        return g1_cuda.smul(self.F, P, scalars, self.nbits)

    def mul2(self, P: Tensor, e: Tensor, Q: Tensor, f: Tensor) -> Tensor:
        """[e]P + [f]Q by shared doublings (Strauss-Shamir), r.bit_length()
        steps, each one ``dbl_add_select`` of P, Q or P + Q where a bit is
        set (the reference's double, add and select, in one kernel)."""
        PQ = self.add(P, Q)
        lanes = torch.broadcast_shapes(PQ.shape[-1:], e.shape[-1:], f.shape[-1:])
        lead = torch.broadcast_shapes(PQ.shape[:-3], e.shape[:-2], f.shape[:-2])
        shape = lead + PQ.shape[-3:-1] + lanes
        acc = self.inf.expand(shape)
        P, Q, PQ = (x.expand(shape) for x in (P, Q, PQ))
        for i in range(self.nbits - 1, -1, -1):
            be, bf = g1_cuda.scalar_bit(e, i), g1_cuda.scalar_bit(f, i)
            addend = self.select(be & bf, PQ, self.select(be, P, Q))
            acc = self.dbl_add_select(acc, addend, be | bf)
        return acc

    # ------------------------------------------------------------- affine ---
    def to_affine(self, P: Tensor) -> Tuple[Tensor, Tensor]:
        """Batched projective -> affine (x, y); infinity maps to (0, 0).  One
        batch inversion of Z (product tree, one ``fp_pow`` chain), then two
        products per point, on the ``mont_mul`` kernel on a card."""
        zi = self.fp.batch_inv(P[..., 2, :, :])
        x, y = self.F.mul_many([P[..., 0, :, :], P[..., 1, :, :]], [zi, zi])
        fin = ~self.is_inf(P)
        return self.fp.select(fin, x, torch.zeros_like(x)), self.fp.select(fin, y, torch.zeros_like(y))

    def to_affine_rows(self, P: Tensor) -> Tensor:
        """Projective (..., 3, L, B) -> affine (..., 2, L, B); inf -> (0, 0)."""
        return torch.stack(self.to_affine(P), dim=-3)

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

    def sum_reduce_axis(self, P: Tensor, axis: int) -> Tensor:
        """Tree-reduce along a leading batch axis (e.g. a device gather dim)."""
        P = P.movedim(axis, 0)
        n = P.shape[0]
        while n > 1:
            half = n // 2
            combined = self.add(P[: 2 * half : 2], P[1 : 2 * half : 2])
            if n % 2:
                combined = torch.cat([combined, P[2 * half :]], dim=0)
            P = combined
            n = P.shape[0]
        return P[0]


@lru_cache(maxsize=None)
def get_g1_ctx(spec: CurveSpec, device=None) -> G1Ctx:
    """One G1Ctx per curve and device (the card unless ``device="cpu"``)."""
    return G1Ctx(spec, _device(device))
