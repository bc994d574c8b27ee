"""Optimal-ate pairings and pairing products on the device (port of
``mathlib_tpu/ops/pairing.py``).

``miller_loop`` follows the reference's TPU dispatch (``_miller_loop_pallas``):
one ``miller_ft`` kernel launch gives every lane's (f, T); the conjugation
when the loop parameter is negative and, on BN curves, the two Frobenius
chord steps (two ``add_step`` launches) follow.  ``final_exp`` is
``TowerCtx.f12_final_exp``; ``pairing`` is both.

``product_miller`` and ``products_miller`` run every lane's Miller loop and
multiply the lanes together, in one or in aligned power-of-two segments, as
the reference's fused Pallas product kernels do; ``batch.BatchEngine``
finishes each unreduced product with one final exponentiation on the host C++
engine by default, or on the card (``product_check``: the reference's
``split`` strategy, or its one-launch ``check`` kernel).  The kernels are
``kernels/pairing_cuda.py``.

Line convention and Miller loop shape are the reference's (its module
docstring derives them): the loop runs over the bits of |x| (BLS12) or
|6x + 2| (BN), conjugates when that parameter is negative, and BN curves
finish with the chord lines through Q1 = pi(Q) and Q2 = -pi^2(Q), whose
twist-coordinate Frobenius constants come from the port's host tower.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec, Family
from ..host.fields import get_tower
from .g2 import G2Ctx
from .kernels import pairing_cuda
from .tower import TowerCtx

Tensor = torch.Tensor


def _fp2_scalar(e12) -> Tuple[int, int]:
    """A host Fp12 element that lies in Fp2, as its Fp2 coefficient."""
    for k in range(2):
        for j in range(3):
            if (k, j) != (0, 0) and e12[k][j] != (0, 0):
                raise ValueError("constant is not Fp2-valued")
    return e12[0][0]


class PairingCtx:
    def __init__(self, spec: CurveSpec, device=None, L: Optional[int] = None):
        """The pairing over ``spec`` on ``device``, its base field at
        ``base_limbs`` (L = 18 for FP256BN on a card, or ``L`` where
        given)."""
        self.spec = spec
        self.device = _device(device)
        self.tw = TowerCtx(spec, self.device, L)
        self.g2c = G2Ctx(spec, self.device, L)
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
        self.cfg = pairing_cuda.MillerCfg(
            self.tw.kcfg, self.loop_bits.astype(np.uint8), self.conj_end, tail,
        )

    # ------------------------------------------------------------ products --
    def product_miller(self, xP, yP, Qx, Qy, n=None) -> Tensor:
        """The UNREDUCED product of every lane's Miller value -> (2, 3, 2, L, 1).

        xP, yP: (L, B) and Qx, Qy: (2, L, B), affine, Montgomery form.  Lanes
        >= ``n`` (default B) count as one.  The product runs as a tree over
        the next power of two, the lanes past B padded with ones."""
        B = xP.shape[-1]
        f = pairing_cuda.miller_lanes(self.cfg, xP, yP, Qx, Qy, B if n is None else n)
        width = pairing_cuda.tree_width(B)
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

    # ------------------------------------------------------------ pairing ---
    def miller_loop(self, xP, yP, Qx, Qy) -> Tensor:
        """Per-lane Miller values (2, 3, 2, L, B) of affine G1 (xP, yP: (L, B))
        and G2 (Qx, Qy: (2, L, B)) points in Montgomery form; final_exp makes
        them pairings.  The steps of the reference's ``_miller_loop_pallas``."""
        t = self.tw
        f, T = pairing_cuda.miller_ft(self.cfg, xP, yP, Qx, Qy)
        if self.conj_end:
            f = t.f12_conj(f)
            T = self.g2c.neg(T)
        if self.bn_tail:
            Q1x = t.f2_mul_const(t.f2_conj(Qx), self.cx1)
            Q1y = t.f2_mul_const(t.f2_conj(Qy), self.cy1)
            Q2x = t.f2_mul_const(Qx, self.cx2)
            Q2y = t.f2_neg(t.f2_mul_const(Qy, self.cy2))
            f, T = pairing_cuda.add_step(self.cfg, f, T, Q1x, Q1y, xP, yP)
            f, T = pairing_cuda.add_step(self.cfg, f, T, Q2x, Q2y, xP, yP)
        return f

    def final_exp(self, f) -> Tensor:
        return self.tw.f12_final_exp(f)

    def pairing(self, xP, yP, Qx, Qy, reduce: bool = True) -> Tensor:
        f = self.miller_loop(xP, yP, Qx, Qy)
        return self.final_exp(f) if reduce else f

    # ------------------------------------------------------ the strategies --
    @property
    def supports_fused_check(self) -> bool:
        """The all-device product check (final exp and unity test on the
        card) takes BLS12 curves with the factor-3 final exp, whose device
        final exp is the one-launch x-chain kernel."""
        return self.spec.family == Family.BLS12 and self.spec.fexp_factor == 3

    @property
    def supports_fused_product(self) -> bool:
        """The fused Miller + product kernels take BLS12 (factor 3) and BN
        curves: every curve a ``PairingCtx`` accepts."""
        return True

    def product_check(self, xP, yP, Qx, Qy, n=None) -> bool:
        """prod_i e(P_i, Q_i) == 1 with everything on the device, for
        ``supports_fused_check`` curves; lanes >= ``n`` (default B) count as
        one.  ``MATHLIB_PAIR_FUSED`` picks the reference's strategy: ``split``
        (the default here) runs ``product_miller``, the ``final_exp`` kernel
        on the product and the unity test; ``check`` is the one-launch kernel
        (``pairing_check``: Miller loops, product, final exp and unity test;
        the reference's ``_pairing_check_kernel``)."""
        if not self.supports_fused_check:
            raise ValueError(f"{self.spec.name}: the device product check takes BLS12 curves")
        if os.environ.get("MATHLIB_PAIR_FUSED", "split") == "check":
            B = xP.shape[-1]
            ok, _ = pairing_cuda.pairing_check(self.cfg, xP, yP, Qx, Qy, B if n is None else n)
            return bool(ok)
        prod = self.product_miller(xP, yP, Qx, Qy, n=n)
        return bool(self.tw.f12_is_one(self.final_exp(prod))[0])
