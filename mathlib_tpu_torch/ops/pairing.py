"""Optimal-ate pairing products on the device (port of ``mathlib_tpu/ops/pairing.py``,
the part the pairing-product check needs).

``product_miller`` and ``products_miller`` run every lane's Miller loop and
multiply the lanes together, in one or in aligned power-of-two segments, as
the reference's fused Pallas product kernels do; callers finish each
unreduced product with one final exponentiation on the host C++ engine
(``batch.BatchEngine``).  The kernels are ``kernels/pairing_cuda.py``.

Line convention and Miller loop shape are the reference's (its module
docstring derives them): the loop runs over the bits of |x| (BLS12) or
|6x + 2| (BN), conjugates when that parameter is negative, and BN curves
finish with the chord lines through Q1 = pi(Q) and Q2 = -pi^2(Q), whose
twist-coordinate Frobenius constants come from the port's host tower.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec, Family
from ..host.fields import get_tower
from .kernels import pairing_cuda
from .kernels.tower_rows import RowTower
from .tower import TowerCtx

Tensor = torch.Tensor

_LATER = "not ported yet: ROADMAP.md §1 item 13 (the rest of the pairing)"


def _fp2_scalar(e12) -> Tuple[int, int]:
    """A host Fp12 element that lies in Fp2, as its Fp2 coefficient."""
    for k in range(2):
        for j in range(3):
            if (k, j) != (0, 0) and e12[k][j] != (0, 0):
                raise ValueError("constant is not Fp2-valued")
    return e12[0][0]


class PairingCtx:
    def __init__(self, spec: CurveSpec, device=None):
        self.spec = spec
        self.device = _device(device)
        self.tw = TowerCtx(spec, self.device)
        if spec.family == Family.BLS12:
            if spec.fexp_factor != 3:
                raise ValueError("the fused product takes BLS12 curves with the factor-3 final exp")
            c = abs(spec.x)
            self.conj_end = spec.x < 0
            self.bn_tail = False
        else:
            m = 6 * spec.x + 2
            c = abs(m)
            self.conj_end = m < 0
            self.bn_tail = True
        # loop bits, MSB-first, skipping the leading 1
        self.loop_bits = np.array(
            [(c >> i) & 1 for i in range(c.bit_length() - 2, -1, -1)], dtype=np.uint32
        )
        tail = None
        if self.bn_tail:
            # Frobenius constants on twist coordinates: (un)twist factors
            # ux, uy (M-twist 1/w^2, 1/w^3; D-twist w^2, w^3) as in the host
            # engine, then pi^n(ux)/ux and pi^n(uy)/uy
            t = get_tower(spec)
            w = (t.F6_ZERO, t.F6_ONE)
            w2 = t.f12_mul(w, w)
            w3 = t.f12_mul(w2, w)
            ux, uy = (t.f12_inv(w2), t.f12_inv(w3)) if spec.twist == "M" else (w2, w3)
            iux, iuy = t.f12_inv(ux), t.f12_inv(uy)
            self.cx1 = _fp2_scalar(t.f12_mul(t.f12_frob(ux, 1), iux))
            self.cy1 = _fp2_scalar(t.f12_mul(t.f12_frob(uy, 1), iuy))
            self.cx2 = _fp2_scalar(t.f12_mul(t.f12_frob(ux, 2), iux))
            self.cy2 = _fp2_scalar(t.f12_mul(t.f12_frob(uy, 2), iuy))
            tail = (self.cx1, self.cy1, self.cx2, self.cy2)
        beta_neg = (spec.p - spec.beta) % spec.p
        if not 0 < beta_neg < 256 or spec.xi[1] != 1 or not 0 <= spec.xi[0] < 256:
            raise ValueError("the in-kernel tower takes beta = -n and xi = xi0 + u, n and xi0 small")
        self.cfg = pairing_cuda.MillerCfg(
            RowTower(self.tw.fp, beta_neg, spec.xi[0], spec.twist),
            self.loop_bits.astype(np.uint8), self.conj_end, tail,
        )

    # ------------------------------------------------------------ products --
    def product_miller(self, xP, yP, Qx, Qy, n=None) -> Tensor:
        """The UNREDUCED product of every lane's Miller value -> (2, 3, 2, L, 1).

        xP, yP: (L, B) and Qx, Qy: (2, L, B), affine, Montgomery form.  Lanes
        >= ``n`` (default B) count as one.  The product runs as a tree over
        the next power of two, the lanes past B padded with ones."""
        B = xP.shape[-1]
        f = pairing_cuda.miller_lanes(self.cfg, xP, yP, Qx, Qy, B if n is None else n)
        width = 1 << max(0, B - 1).bit_length()
        if width != B:
            pad = self.cfg.tower.f12_one_like(width - B, f.device).to(torch.int32)
            f = torch.cat([f, pad], dim=-1)
        return pairing_cuda.f12_seg_product(self.cfg, f, width)

    def products_miller(self, xP, yP, Qx, Qy, seg: int, n=None) -> Tensor:
        """B/seg UNREDUCED segment products -> (2, 3, 2, L, B/seg): group k is
        the product over lanes [k*seg, (k+1)*seg); ``seg`` a power of two
        dividing B.  Lanes >= ``n`` count as one."""
        B = xP.shape[-1]
        f = pairing_cuda.miller_lanes(self.cfg, xP, yP, Qx, Qy, B if n is None else n)
        return pairing_cuda.f12_seg_product(self.cfg, f, seg)

    # ------------------------------------------------------------- later ----
    def miller_loop(self, xP, yP, Qx, Qy):
        raise NotImplementedError(_LATER)

    def final_exp(self, f):
        raise NotImplementedError(_LATER)

    def pairing(self, xP, yP, Qx, Qy, reduce: bool = True):
        raise NotImplementedError(_LATER)
