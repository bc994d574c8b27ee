"""G1 group-law kernels for Hopper (port of ``mathlib_tpu/ops/kernels/g1_pallas.py``).

Four kernels, CUDA C++ in ``csrc/g1_kernels.cu``, each behind a wrapper here:

=========  ==========================  ======================================
wrapper    computes                    replaces (TPU kernel)
=========  ==========================  ======================================
``add``    P + Q (RCB Alg 7)           ``g1_pallas._add_kernel`` / ``add_pallas``
``double`` 2P (RCB Alg 9)              ``g1_pallas._double_kernel`` / ``double_pallas``
``addsel`` select(sel, P + Q, Q)       ``g1_pallas._addsel_kernel`` / ``addsel_pallas``
``smul``   [k]Q, per-lane scalars      ``g1_pallas._smul_kernel`` / ``smul_pallas``
=========  ==========================  ======================================

Each wrapper takes a ``weier.FieldAdapter`` over the port's ``FpCtx`` (with
``.fp`` and ``.b3``) and int32 point tensors ``(..., 3, L, B)``.  On a CPU
tensor it returns its plain PyTorch version (``*_plain``, built on
``ops/field.py`` + ``ops/weier.py``).  On a CUDA tensor it launches its kernel
on the current stream, adds one to its ``launches`` count, and raises if the
launch fails; it never falls back.  Leading batch dims are folded into the
lane axis before a launch and restored after, as ``g1_pallas._to_tiles`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import weier
from . import build

Tensor = torch.Tensor


def _unstack(P: Tensor):
    return P[..., 0, :, :], P[..., 1, :, :], P[..., 2, :, :]


def _inf_like(F, shape: tuple) -> Tensor:
    """Infinity (0 : 1 : 0) broadcast to a (..., 3, L, B) shape."""
    fp = F.fp
    zero = torch.zeros((fp.L, 1), dtype=torch.int32, device=fp.device)
    return torch.stack([zero, fp.one_mont.to(torch.int32), zero]).expand(shape)


# ------------------------------------------------------------ plain versions --
def add_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor) -> Tensor:
    X3, Y3, Z3 = weier.add_complete(F, _unstack(P), _unstack(Q))
    return torch.stack([X3, Y3, Z3], dim=-3)


def double_plain(F: weier.FieldAdapter, P: Tensor) -> Tensor:
    X3, Y3, Z3 = weier.double_complete(F, _unstack(P))
    return torch.stack([X3, Y3, Z3], dim=-3)


def addsel_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    P, Q = torch.broadcast_tensors(P, Q)
    return torch.where(sel[..., None, None, :], add_plain(F, P, Q), Q)


def _acc_shape(Q: Tensor, scalars: Tensor) -> tuple:
    lanes = torch.broadcast_shapes(Q.shape[-1:], scalars.shape[-1:])
    lead = torch.broadcast_shapes(Q.shape[:-3], scalars.shape[:-2])
    return lead + Q.shape[-3:-1] + lanes


def smul_plain(F: weier.FieldAdapter, Q: Tensor, scalars: Tensor, nbits: int) -> Tensor:
    """[k]Q: MSB-first double-and-add from infinity, select per lane."""
    acc = _inf_like(F, _acc_shape(Q, scalars))
    for i in range(nbits - 1, -1, -1):
        bit = ((scalars[..., i // 16, :] >> (i % 16)) & 1) != 0
        D = double_plain(F, acc)
        acc = torch.where(bit[..., None, None, :], add_plain(F, D, Q), D)
    return acc


# ------------------------------------------------------------------ launches --
def _check(F, *points: Tensor, scalars: Optional[Tensor] = None) -> None:
    """Refuse what the kernels do not take: a limb count other than 16 or 24,
    points not shaped (..., 3, L, B), dtypes other than int32, mixed devices."""
    L = F.fp.L
    if L not in (16, 24):
        raise ValueError(
            f"the CUDA G1 kernels take L = 16 or 24 limbs (8 or 12 32-bit words), got L={L}"
        )
    for t in points:
        if t.shape[-3:-1] != (3, L):
            raise ValueError(f"points must be (..., 3, {L}, B), got {tuple(t.shape)}")
    tensors = points if scalars is None else points + (scalars,)
    for t in tensors:
        if t.device != points[0].device:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {t.dtype}")


def _to_lanes(P: Tensor):
    """(..., 3, L, B) -> ((3, L, n) contiguous, restore)."""
    shape = P.shape
    flat = P.movedim((-3, -2), (0, 1)).reshape(shape[-3], shape[-2], -1).contiguous()
    if flat.shape[-1] >= 1 << 31:
        raise ValueError("the kernels index lanes with a 32-bit int")

    def restore(out: Tensor) -> Tensor:
        return out.reshape(shape[-3:-1] + shape[:-3] + shape[-1:]).movedim((0, 1), (-3, -2))

    return flat, restore


def _require_cuda(t: Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"G1 kernels run on CPU (plain) or CUDA tensors, got {t.device}")


def add(F: weier.FieldAdapter, P: Tensor, Q: Tensor) -> Tensor:
    """P + Q."""
    P, Q = torch.broadcast_tensors(P, Q)
    if P.device.type == "cpu":
        return add_plain(F, P, Q)
    _require_cuda(P)
    _check(F, P, Q)
    P2, restore = _to_lanes(P)
    Q2, _ = _to_lanes(Q)
    out = torch.empty_like(P2)
    n = P2.shape[-1]
    if n:
        with torch.cuda.device(P.device):
            build.launch("mlt_g1_add", P2.data_ptr(), Q2.data_ptr(), out.data_ptr(), n,
                         F.fp.L, ctypes.addressof(build.consts(F.fp.p, F.fp.L)), F.b3,
                         build.stream(P))
        add.launches += 1
    return restore(out)


def double(F: weier.FieldAdapter, P: Tensor) -> Tensor:
    """2P."""
    if P.device.type == "cpu":
        return double_plain(F, P)
    _require_cuda(P)
    _check(F, P)
    P2, restore = _to_lanes(P)
    out = torch.empty_like(P2)
    n = P2.shape[-1]
    if n:
        with torch.cuda.device(P.device):
            build.launch("mlt_g1_double", P2.data_ptr(), out.data_ptr(), n,
                         F.fp.L, ctypes.addressof(build.consts(F.fp.p, F.fp.L)), F.b3,
                         build.stream(P))
        double.launches += 1
    return restore(out)


def addsel(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    """select(sel, P + Q, Q), sel a (..., B) bool tensor."""
    if P.device.type == "cpu":
        return addsel_plain(F, P, Q, sel)
    _require_cuda(P)
    P, Q = torch.broadcast_tensors(P, Q)
    _check(F, P, Q)
    sel = sel.to(torch.bool).expand(P.shape[:-3] + P.shape[-1:]).reshape(-1).contiguous()
    if sel.device != P.device:
        raise ValueError("sel must be on the points' device")
    P2, restore = _to_lanes(P)
    Q2, _ = _to_lanes(Q)
    out = torch.empty_like(P2)
    n = P2.shape[-1]
    if n:
        with torch.cuda.device(P.device):
            build.launch("mlt_g1_addsel", P2.data_ptr(), Q2.data_ptr(), sel.data_ptr(),
                         out.data_ptr(), n, F.fp.L,
                         ctypes.addressof(build.consts(F.fp.p, F.fp.L)), F.b3, build.stream(P))
        addsel.launches += 1
    return restore(out)


def smul(F: weier.FieldAdapter, Q: Tensor, scalars: Tensor, nbits: int) -> Tensor:
    """[k]Q for projective Q (..., 3, L, B) and plain 16-bit scalar limbs
    (..., S, B); the whole ladder runs in one launch."""
    if Q.device.type == "cpu":
        return smul_plain(F, Q, scalars, nbits)
    _require_cuda(Q)
    _check(F, Q, scalars=scalars)
    S = scalars.shape[-2]
    if nbits > 16 * S:
        raise ValueError(f"nbits={nbits} exceeds the {S} scalar limbs")
    shape = _acc_shape(Q, scalars)
    lead, lanes = shape[:-3], shape[-1:]
    Q2, restore = _to_lanes(Q.expand(shape))
    s2 = scalars.expand(lead + (S,) + lanes).movedim(-2, 0).reshape(S, -1).contiguous()
    out = torch.empty_like(Q2)
    n = Q2.shape[-1]
    if n:
        with torch.cuda.device(Q.device):
            build.launch("mlt_g1_smul", Q2.data_ptr(), s2.data_ptr(), out.data_ptr(), n,
                         F.fp.L, S, nbits, ctypes.addressof(build.consts(F.fp.p, F.fp.L)),
                         F.b3, build.stream(Q))
        smul.launches += 1
    return restore(out)


# launch counts: a plain integer on each wrapper, raised only where it launches
KERNELS = (add, double, addsel, smul)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
