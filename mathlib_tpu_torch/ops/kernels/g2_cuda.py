"""G2 group-law kernels for Hopper (port of ``mathlib_tpu/ops/kernels/g2_pallas.py``).

Six kernels, CUDA C++, on one step: each spreads a G2 ladder bit's
base-field products over a block's warps (``csrc/g2_step.cuh``: one half of
a bit, the doubling or the add, is ``half_bit``, with Q, the points and the
products in shared memory).  ``csrc/g2_smul_kernels.cu`` has the two
ladders (one body, ``g2_ladder_kernel``, over 18 warps for all bits);
``csrc/g2_point_kernels.cu`` the add and ``addsel`` (one body,
``add_body<.., SEL>``: the add's half over 18 warps, ``addsel``'s result
sel ? P + Q : Q selected lane by lane where it is stored) and the doubling
(the doubling's half over 12 warps), one launch each;
``csrc/g2_dblsel_kernels.cu`` ``dblsel`` (one whole bit with acc read from
P, in one launch).  16 lanes a block up to 16 lanes an SM, 2,112 on an
H100, 32 above.  Each is behind a wrapper here:

===============  ==============================  ==================================================
wrapper          computes                        replaces (TPU kernel)
===============  ==============================  ==================================================
``add``          P + Q (RCB Alg 7 over Fp2)      ``g2_pallas._add_kernel`` / ``add_pallas``
``double``       2P (RCB Alg 9 over Fp2)         ``g2_pallas._double_kernel`` / ``double_pallas``
``addsel``       select(sel, P + Q, Q)           ``g2_pallas._addsel_kernel`` / ``addsel_pallas``
``dblsel``       select(sel, 2P + Q, 2P)         ``g2_pallas._dblsel_kernel`` / ``dblsel_pallas``
``smul``         [k]Q, per-lane scalars          ``g2_pallas._g2_smul_kernel`` / ``g2_smul_pallas``
``smul_static``  [k]Q, one scalar for all lanes  ``g2_pallas._g2_smul_static_kernel`` /
                                                 ``g2_smul_static_pallas``
===============  ==============================  ==================================================

Each wrapper takes a ``Row2Adapter`` (the field of the kernels: ``.fp``, the
base field's ``FpCtx``, and ``.b3``, the small twist constant 3 b2 as a pair)
and int32 point tensors ``(..., 3, 2, L, B)``.  On a CPU tensor it returns
its plain PyTorch version (``*_plain``: ``weier.add_complete`` /
``double_complete`` over the ``Row2Adapter``).  On a CUDA tensor it launches
its kernel on the current stream, adds one to its ``launches`` count (named
``g2_add``, ``g2_double``, ... by ``launches()``), and raises if the launch
fails; it never falls back.  Leading batch dims are folded into the lane
axis before a launch and restored after, as ``g2_pallas._to_tiles`` does.

The kernels take the reference's gate: beta = -1 and a small b3 (0 <= c <
256, not both 0): BLS12-381 (b3 = (12, 12)) at L = 24, and FP256BN, whose
contexts on the card hold L = 18 (``ops/field.py base_limbs``): nine words,
built by the twins ``csrc/*_nw9.cu``.  The static ladders (hash-to-G2's
cofactor, BLS12-381's) are not built at nine words: their launcher refuses
L = 18.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import weier
from ..field import FpCtx
from . import build
from .g1_cuda import scalar_bit

Tensor = torch.Tensor

# the limb counts the kernels are built for: 24 (12 32-bit words,
# BLS12-381) and 18 (9 words, FP256BN on the card)
KERNEL_LS = (18, 24)


def _stack(xs, dim: int) -> Tensor:
    return torch.stack(torch.broadcast_tensors(*xs), dim=dim)


class Row2Adapter(weier.FieldAdapter):
    """Fp2 with u^2 = -1 as ``g2_pallas.Row2Ctx`` computes it, operation for
    operation, on ``FpCtx``'s plain product (stack axis -4 for the ``*_many``
    calls, as ``ops/g2.py Fp2Adapter``).

    * ``mul_many``: Karatsuba, t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1),
      re = t0 - t1, im = t2 - (t0 + t1).  (``TowerCtx.f2_mul`` computes
      re = t0 + beta t1, whose relaxed limbs differ.)
    * ``mul_b3``: the four branches of ``Row2Ctx.mul_b3`` on ``FpCtx.mul_int``,
      which is ``RowCtx.mul_small``'s add chain.
    * Squares go through the general product, as ``_rcb_double`` does."""

    def __init__(self, fp: FpCtx, b3: Tuple[int, int]):
        if not (all(0 <= c < 256 for c in b3) and any(b3)):
            raise ValueError(f"the G2 kernels take a small twist constant, got b3={b3}")
        self.fp = fp
        self.b3 = tuple(b3)

    def add(self, a, b):
        return self.fp.add(*torch.broadcast_tensors(a, b))

    def sub(self, a, b):
        return self.fp.sub(*torch.broadcast_tensors(a, b))

    def mul_many(self, xs, ys):
        fp = self.fp
        a, b = torch.broadcast_tensors(_stack(xs, -4), _stack(ys, -4))
        a0, a1, b0, b1 = a[..., 0, :, :], a[..., 1, :, :], b[..., 0, :, :], b[..., 1, :, :]
        m = fp.mont_mul_plain(_stack([a0, a1, fp.add(a0, a1)], -3),
                              _stack([b0, b1, fp.add(b0, b1)], -3))
        t0, t1, t2 = m.unbind(-3)
        out = torch.stack([fp.sub(t0, t1), fp.sub(t2, fp.add(t0, t1))], dim=-3)
        return tuple(out.unbind(-4))

    def add_many(self, xs, ys):
        return tuple(self.fp.add(*torch.broadcast_tensors(_stack(xs, -4), _stack(ys, -4))).unbind(-4))

    def sub_many(self, xs, ys):
        return tuple(self.fp.sub(*torch.broadcast_tensors(_stack(xs, -4), _stack(ys, -4))).unbind(-4))

    def mul_b3(self, a):
        fp = self.fp
        c0, c1 = self.b3
        a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
        if c1 == 0:
            out = [fp.mul_int(a0, c0), fp.mul_int(a1, c0)]
        elif c0 == 0:
            out = [fp.neg(fp.mul_int(a1, c1)), fp.mul_int(a0, c1)]
        elif c0 == c1:
            out = [fp.mul_int(fp.sub(a0, a1), c0), fp.mul_int(fp.add(a0, a1), c0)]
        else:
            out = [fp.sub(fp.mul_int(a0, c0), fp.mul_int(a1, c1)),
                   fp.add(fp.mul_int(a1, c0), fp.mul_int(a0, c1))]
        return torch.stack(out, dim=-3)


def _unstack(P: Tensor):
    return P[..., 0, :, :, :], P[..., 1, :, :, :], P[..., 2, :, :, :]


def inf_like(F: Row2Adapter, shape: tuple) -> Tensor:
    """Infinity ((0, 0) : (1, 0) : (0, 0)) broadcast to a (..., 3, 2, L, B) shape."""
    fp = F.fp
    zero = torch.zeros((fp.L, 1), dtype=torch.int32, device=fp.device)
    one = fp.one_mont.to(torch.int32)
    return torch.stack([torch.stack([zero, zero]), torch.stack([one, zero]),
                        torch.stack([zero, zero])]).expand(shape)


# ------------------------------------------------------------ plain versions --
def add_plain(F: Row2Adapter, P: Tensor, Q: Tensor) -> Tensor:
    X3, Y3, Z3 = weier.add_complete(F, _unstack(P), _unstack(Q))
    return torch.stack([X3, Y3, Z3], dim=-4)


def double_plain(F: Row2Adapter, P: Tensor) -> Tensor:
    X3, Y3, Z3 = weier.double_complete(F, _unstack(P))
    return torch.stack([X3, Y3, Z3], dim=-4)


def _sel(mask: Tensor, A: Tensor, B: Tensor) -> Tensor:
    return torch.where(mask[..., None, None, None, :], A, B)


def addsel_plain(F: Row2Adapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    P, Q = torch.broadcast_tensors(P, Q)
    return _sel(sel, add_plain(F, P, Q), Q)


def dblsel_plain(F: Row2Adapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    D, Q = torch.broadcast_tensors(double_plain(F, P), Q)
    return _sel(sel, add_plain(F, D, Q), D)


def _acc_shape(Q: Tensor, scalars: Tensor) -> tuple:
    lanes = torch.broadcast_shapes(Q.shape[-1:], scalars.shape[-1:])
    lead = torch.broadcast_shapes(Q.shape[:-4], scalars.shape[:-2])
    return lead + Q.shape[-4:-1] + lanes


def smul_plain(F: Row2Adapter, Q: Tensor, scalars: Tensor, nbits: int) -> Tensor:
    """[k]Q: MSB-first from infinity, each bit a double, an add of Q and a
    select (``_g2_smul_kernel``)."""
    acc = inf_like(F, _acc_shape(Q, scalars))
    for i in range(nbits - 1, -1, -1):
        D = double_plain(F, acc)
        acc = _sel(scalar_bit(scalars, i), add_plain(F, D, Q), D)
    return acc


def smul_static_plain(F: Row2Adapter, Q: Tensor, bits) -> Tensor:
    """[k]Q for one scalar given by its MSB-first bits: from infinity, a
    double at every bit and the add only at one-bits
    (``_g2_smul_static_kernel``)."""
    acc = inf_like(F, Q.shape)
    for bit in bits:
        acc = double_plain(F, acc)
        if bit:
            acc = add_plain(F, acc, Q)
    return acc


# ------------------------------------------------------------------ launches --
def _check(F: Row2Adapter, *points: Tensor, scalars: Optional[Tensor] = None) -> None:
    """Refuse what the kernels do not take: a device other than CUDA, a limb
    count other than 18 or 24, points not shaped (..., 3, 2, L, B), dtypes
    other than int32, mixed devices."""
    dev = points[0].device
    if dev.type != "cuda":
        raise ValueError(f"G2 kernels run on CPU (plain) or CUDA tensors, got {dev}")
    L = F.fp.L
    if L not in KERNEL_LS:
        raise ValueError(f"the CUDA G2 kernels take L = 18 or 24 limbs (9 or 12 32-bit words), "
                         f"got L={L}")
    for t in points:
        if t.shape[-4:-1] != (3, 2, L):
            raise ValueError(f"points must be (..., 3, 2, {L}, B), got {tuple(t.shape)}")
    for t in points + ((scalars,) if scalars is not None else ()):
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {t.dtype}")


def _to_lanes(P: Tensor):
    """(..., 3, 2, L, B) -> ((3, 2, L, n) contiguous, restore)."""
    shape = P.shape
    flat = P.movedim((-4, -3, -2), (0, 1, 2)).reshape(shape[-4:-1] + (-1,)).contiguous()
    if flat.shape[-1] >= 1 << 31:
        raise ValueError("the kernels index lanes with a 32-bit int")

    def restore(out: Tensor) -> Tensor:
        return out.reshape(shape[-4:-1] + shape[:-4] + shape[-1:]).movedim((0, 1, 2), (-4, -3, -2))

    return flat, restore


def _lane_mask(sel: Tensor, P: Tensor) -> Tensor:
    """A (..., B) bool mask, broadcast to P's lanes, flat and contiguous."""
    if sel.device != P.device:
        raise ValueError("sel must be on the points' device")
    return sel.to(torch.bool).expand(P.shape[:-4] + P.shape[-1:]).reshape(-1).contiguous()


def _launch(kernel, name: str, F: Row2Adapter, P: Tensor, *args) -> Tensor:
    """Launch ``name`` on P's lanes (folded): the launcher takes P, then
    ``args`` (tensors go as their pointers, and are held until the launch is
    queued), then the output, the lane count and the field; one more launch
    counted on ``kernel``."""
    P2, restore = _to_lanes(P)
    out = torch.empty_like(P2)
    n = P2.shape[-1]
    if n:
        fp = F.fp
        ptrs = [a.data_ptr() if isinstance(a, Tensor) else a for a in args]
        with torch.cuda.device(P.device):
            build.launch(name, P2.data_ptr(), *ptrs, out.data_ptr(), n, fp.L,
                         ctypes.addressof(build.consts(fp.p, fp.L)), *F.b3, build.stream(P))
        kernel.launches += 1
    return restore(out)


def add(F: Row2Adapter, P: Tensor, Q: Tensor) -> Tensor:
    """P + Q."""
    P, Q = torch.broadcast_tensors(P, Q)
    if P.device.type == "cpu":
        return add_plain(F, P, Q)
    _check(F, P, Q)
    return _launch(add, "mlt_g2_add", F, P, _to_lanes(Q)[0])


def double(F: Row2Adapter, P: Tensor) -> Tensor:
    """2P."""
    if P.device.type == "cpu":
        return double_plain(F, P)
    _check(F, P)
    return _launch(double, "mlt_g2_double", F, P)


def addsel(F: Row2Adapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    """select(sel, P + Q, Q), sel a (..., B) bool tensor: the add's half and
    the select in one launch (a block with no lane selected runs no add)."""
    if P.device.type == "cpu":
        return addsel_plain(F, P, Q, sel)
    P, Q = torch.broadcast_tensors(P, Q)
    _check(F, P, Q)
    return _launch(addsel, "mlt_g2_addsel", F, P, _to_lanes(Q)[0],
                   _lane_mask(sel, P))


def dblsel(F: Row2Adapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    """select(sel, 2P + Q, 2P), sel a (..., B) bool tensor: one scalar-mul
    step in one launch."""
    if P.device.type == "cpu":
        return dblsel_plain(F, P, Q, sel)
    P, Q = torch.broadcast_tensors(P, Q)
    _check(F, P, Q)
    return _launch(dblsel, "mlt_g2_dblsel", F, P, _to_lanes(Q)[0],
                   _lane_mask(sel, P))


def smul(F: Row2Adapter, Q: Tensor, scalars: Tensor, nbits: int) -> Tensor:
    """[k]Q for projective Q (..., 3, 2, L, B) and plain 16-bit scalar limbs
    (..., S, B); the whole ladder runs in one launch."""
    if Q.device.type == "cpu":
        return smul_plain(F, Q, scalars, nbits)
    _check(F, Q, scalars=scalars)
    S = scalars.shape[-2]
    if nbits > 16 * S:
        raise ValueError(f"nbits={nbits} exceeds the {S} scalar limbs")
    shape = _acc_shape(Q, scalars)
    s2 = scalars.expand(shape[:-4] + (S,) + shape[-1:]).movedim(-2, 0).reshape(S, -1).contiguous()
    return _launch(smul, "mlt_g2_smul", F, Q.expand(shape), s2, S, nbits)


def smul_static(F: Row2Adapter, Q: Tensor, bits) -> Tensor:
    """[k]Q for projective Q (..., 3, 2, L, B) and one scalar shared by every
    lane, its MSB-first bits (copied to the card once per pattern, so one
    build serves every static scalar); the whole ladder runs in one launch."""
    if Q.device.type == "cpu":
        return smul_static_plain(F, Q, bits)
    _check(F, Q)
    dev_bits = F.fp.device_bits(bits, Q.device)
    return _launch(smul_static, "mlt_g2_smul_static", F, Q, dev_bits, dev_bits.numel())


# launch counts: a plain integer on each wrapper, raised only where it launches
KERNELS = (add, double, addsel, dblsel, smul, smul_static)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {"g2_" + k.__name__: k.launches for k in KERNELS}


reset_launches()
