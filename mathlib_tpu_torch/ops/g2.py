"""G2 points on the sextic twist E'(Fp2) as limb tensors (port of
``mathlib_tpu/ops/g2.py``: the codecs and ``neg``, the part the pairing needs).

A point batch is ``(..., 3, 2, L, B)``, stacking the (X, Y, Z) Fp2
coordinates in Montgomery form; an affine point encodes with Z = 1 and
infinity as (0 : 1 : 0), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..curves.params import CurveSpec
from ..host.fields import get_tower
from .field import FpCtx

Tensor = torch.Tensor


class G2Ctx:
    def __init__(self, spec: CurveSpec, device=None):
        self.spec = spec
        self.device = _device(device)
        self.fp = FpCtx(spec.p, self.device, spec.name)
        self.host = get_tower(spec)

    def neg(self, P: Tensor) -> Tensor:
        """-P for projective (..., 3, 2, L, B) points: Y negated."""
        out = P.clone()
        out[..., 1, :, :, :] = self.fp.neg(P[..., 1, :, :, :])
        return out

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
