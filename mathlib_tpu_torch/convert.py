"""Moving data between the reference's numpy/JAX arrays and the port's tensors.

The reference keeps limbs as ``uint32``; the port keeps the same bits in
``torch.int32``, because PyTorch on the CPU cannot add, shift or compare
``uint32`` tensors.  Every limb is below 2^16, so the two carry the same
values, and a port tensor can be compared word for word with a JAX array.
"""

from __future__ import annotations

import numpy as np
import torch

FP_CONSTANTS = (
    "p_limbs",
    "nprime_limbs",
    "r_minus_2p",
    "sub_offset",
    "one_mont",
    "r2_limbs",
)
G1_CONSTANTS = ("gen", "inf")
G2_CONSTANTS = ("gen", "inf")


def to_torch(arr, device) -> torch.Tensor:
    """uint32 (or any integer) numpy array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t) -> np.ndarray:
    """Port tensor (int32 or int64 holding 32-bit words) -> uint32 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.uint32)


def check_constants(port, ref) -> None:
    """Raise ``ValueError`` unless a port context's constants equal the
    reference's.  ``port``/``ref`` are both ``FpCtx``, both ``G1Ctx`` or both
    ``G2Ctx`` (a group's check covers its base and scalar fields too, and
    G2's the kernels' gate)."""
    bad = []
    if hasattr(ref, "fp"):  # G1Ctx or G2Ctx
        g2 = hasattr(ref, "tw")
        for name in G2_CONSTANTS if g2 else G1_CONSTANTS:
            if not np.array_equal(to_numpy(getattr(port, name)), getattr(ref, name)):
                bad.append(name)
        if port.F.b3 != ref.F.b3:
            bad.append("F.b3")
        if g2 and (port.rows.b3 if port.rows else None) != ref._pallas_b3:
            bad.append("the kernels' gate")
        pairs = [("fp.", port.fp, ref.fp), ("fr.", port.fr, ref.fr)]
    else:
        pairs = [("", port, ref)]
    for prefix, pf, rf in pairs:
        if (pf.p, pf.L) != (rf.p, rf.L):
            bad.append(prefix + "p/L")
            continue
        for name in FP_CONSTANTS:
            if not np.array_equal(to_numpy(getattr(pf, name)), getattr(rf, name)):
                bad.append(prefix + name)
    if bad:
        raise ValueError("port constants differ from the reference: " + ", ".join(bad))
