"""G1 group-law kernels for Hopper (port of ``mathlib_tpu/ops/kernels/g1_pallas.py``).

Nine kernels, CUDA C++ in ``csrc/g1_split_kernels.cu`` on the lane layout
of ``csrc/g1_rows.cuh`` (one add or mixed add spread over six warps, one
doubling over four, the ladders ``smul`` and ``smul_static`` a bit's
doubling and add over six warps with their state in shared memory, and
``dbladd`` one bit of that ladder with acc read from P), each behind a
wrapper here:

==============  ================================  ===============================================
wrapper         computes                          replaces (TPU kernel)
==============  ================================  ===============================================
``add``         P + Q (RCB Alg 7)                 ``g1_pallas._add_kernel`` / ``add_pallas``
``double``      2P (RCB Alg 9)                    ``g1_pallas._double_kernel`` / ``double_pallas``
``addsel``      select(sel, P + Q, Q)             ``g1_pallas._addsel_kernel`` / ``addsel_pallas``
``smul``        [k]Q, per-lane scalars            ``g1_pallas._smul_kernel`` / ``smul_pallas``
``dbladd``      select(sel, 2P + Q, 2P)           ``g1_pallas._dbladd_kernel`` / ``dbladd_pallas``
``addselneg``   select(sel, P + Q', Q'),          ``g1_pallas._addselneg_kernel`` / ``addselneg_pallas``
                Q' = neg ? -Q : Q
``maddsel``     select(sel, P + lift(Q), lift(Q)) ``g1_pallas._maddsel_kernel`` / ``maddsel_pallas``
                for affine Q (``_madd_rows``)
``maddselneg``  the mixed add with Q' as above    ``g1_pallas._maddselneg_kernel`` / ``maddselneg_pallas``
``smul_static`` [k]Q, one scalar for every lane   ``g1_pallas._smul_static_kernel`` / ``smul_static_pallas``
==============  ================================  ===============================================

Each wrapper takes a ``weier.FieldAdapter`` over the port's ``FpCtx`` (with
``.fp``, ``.b3`` and ``.plain``, its twin on the plain field product) and
int32 point tensors ``(..., 3, L, B)`` (affine ``(..., 2, L, B)`` for the
mixed adds).  On a CPU tensor it returns its plain PyTorch version
(``*_plain``, built on ``ops/field.py`` + ``ops/weier.py`` with the plain
product on any device).  On a CUDA tensor it launches its kernel on the
current stream, adds one to its ``launches`` count, and raises if the launch
fails; it never falls back.  Leading batch dims are folded into the lane
axis before a launch and restored after, as ``g1_pallas._to_tiles`` does.
``add`` and the four scan combiners ``addsel``, ``addselneg``, ``maddsel``,
``maddselneg`` (and their plain versions) also write into a given ``out``, a
contiguous (3, L, n) int32 tensor of the result's shape that overlaps no
operand (the MSM scan's capture buffer, a step at a time).

The kernels take L = 16, 18 and 24 limbs (8, 9 and 12 32-bit words; nine
for FP256BN on the card, from ``csrc/g1_split_kernels_nw9.cu``); the static
ladder (the device hash's cofactor, BLS12-381's) is not built at nine words,
and its launcher refuses L = 18.

The negation of the signed combiners is ``F.sub(0, Y)``, the relaxed
subtraction (``p2`` added back below zero), not a canonical ``p - Y``.  The
mixed add follows ``_madd_rows`` operation for operation (11 products), not
the reference's XLA fallback (lift Q, full add), so its relaxed limbs are
the TPU kernel's; its unselected output is lift(Q) = (X2, Y2, R mod p).
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
def _span(t: Tensor) -> tuple:
    """The first and one past the last byte address of ``t``'s elements."""
    last = sum((size - 1) * stride for size, stride in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + t.element_size() * (last + 1)


def _check_out(out: Tensor, shape, device, *operands: Tensor) -> None:
    """Refuse an ``out`` the kernels cannot write into: one that is not a
    contiguous (3, L, n) int32 tensor of the result's ``shape`` on the
    operands' ``device``, or that overlaps an operand."""
    if out.dtype != torch.int32:
        raise TypeError(f"out must be torch.int32, got {out.dtype}")
    if out.device != device:
        raise ValueError(f"out must be on the operands' device {device}, got {out.device}")
    if out.dim() != 3 or tuple(out.shape) != tuple(shape):
        raise ValueError(f"out must be (3, L, n) of the result's shape {tuple(shape)}, "
                         f"got {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    lo, hi = _span(out)
    for t in operands:
        if t.numel() and out.numel():
            a, b = _span(t)
            if a < hi and lo < b:
                raise ValueError("out must not overlap an operand")


def _into(out: Optional[Tensor], result: Tensor, *operands: Tensor) -> Tensor:
    """``result``, or ``out`` holding it (checked by ``_check_out``)."""
    if out is None:
        return result
    _check_out(out, result.shape, result.device, *operands)
    return out.copy_(result)


def add_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor,
              out: Optional[Tensor] = None) -> Tensor:
    X3, Y3, Z3 = weier.add_complete(F.plain, _unstack(P), _unstack(Q))
    return _into(out, torch.stack([X3, Y3, Z3], dim=-3), P, Q)


def double_plain(F: weier.FieldAdapter, P: Tensor) -> Tensor:
    X3, Y3, Z3 = weier.double_complete(F.plain, _unstack(P))
    return torch.stack([X3, Y3, Z3], dim=-3)


def addsel_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor,
                 out: Optional[Tensor] = None) -> Tensor:
    P, Q = torch.broadcast_tensors(P, Q)
    return _into(out, torch.where(sel[..., None, None, :], add_plain(F, P, Q), Q), P, Q)


def dbladd_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    D = double_plain(F, P)
    D, Q = torch.broadcast_tensors(D, Q)
    return torch.where(sel[..., None, None, :], add_plain(F, D, Q), D)


def _neg_y(F, Q: Tensor, neg: Tensor) -> Tensor:
    """Q with Y replaced by sub(0, Y) on the ``neg`` lanes (X, Z and any
    further coordinates kept)."""
    Y = Q[..., 1, :, :]
    Yn = torch.where(neg[..., None, :], F.fp.sub(torch.zeros_like(Y), Y), Y)
    return torch.cat([Q[..., :1, :, :], Yn[..., None, :, :], Q[..., 2:, :, :]], dim=-3)


def addselneg_plain(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor,
                    neg: Tensor, out: Optional[Tensor] = None) -> Tensor:
    P, Q = torch.broadcast_tensors(P, Q)
    return _into(out, addsel_plain(F, P, _neg_y(F, Q, neg), sel), P, Q)


def madd_plain(F: weier.FieldAdapter, P: Tensor, Qa: Tensor) -> Tensor:
    """P + lift(Qa) for affine Qa (..., 2, L, B), ``_madd_rows`` operation for
    operation: t4 = Z1 Y2 + Y1, ln = Z1 X2 + X1, t2b = 3b Z1 (11 products)."""
    F = F.plain
    X1, Y1, Z1 = _unstack(P)
    X2, Y2 = Qa[..., 0, :, :], Qa[..., 1, :, :]
    t0, t1, s3, zy, zx = F.mul_many([X1, Y1, F.add(X1, Y1), Z1, Z1],
                                    [X2, Y2, F.add(X2, Y2), Y2, X2])
    t3 = F.sub(s3, F.add(t0, t1))
    t4 = F.add(zy, Y1)
    ln = F.add(zx, X1)
    t0_3 = F.add(F.add(t0, t0), t0)
    t2b = F.mul_b3(Z1)
    lnb = F.mul_b3(ln)
    z3t = F.add(t1, t2b)
    t1m = F.sub(t1, t2b)
    xa, xb, ya, yb, za, zb = F.mul_many([t3, t4, t1m, lnb, z3t, t0_3],
                                        [t1m, lnb, z3t, t0_3, t4, t3])
    return torch.stack([F.sub(xa, xb), F.add(ya, yb), F.add(za, zb)], dim=-3)


def lift(F, Qa: Tensor) -> Tensor:
    """Affine (..., 2, L, B) -> projective with Z = 1 in Montgomery form."""
    one = F.fp.one_mont.to(Qa.device, torch.int32).expand(Qa.shape[:-3] + Qa.shape[-2:])
    return torch.cat([Qa, one[..., None, :, :]], dim=-3)


def _affine_like(P: Tensor, Qa: Tensor) -> Tensor:
    return Qa.expand(P.shape[:-3] + (2,) + P.shape[-2:])


def maddsel_plain(F: weier.FieldAdapter, P: Tensor, Qa: Tensor, sel: Tensor,
                  out: Optional[Tensor] = None) -> Tensor:
    Qa = _affine_like(P, Qa)
    return _into(out, torch.where(sel[..., None, None, :], madd_plain(F, P, Qa), lift(F, Qa)),
                 P, Qa)


def maddselneg_plain(F: weier.FieldAdapter, P: Tensor, Qa: Tensor, sel: Tensor,
                     neg: Tensor, out: Optional[Tensor] = None) -> Tensor:
    Qa = _affine_like(P, Qa)
    return _into(out, maddsel_plain(F, P, _neg_y(F, Qa, neg), sel), P, Qa)


def _acc_shape(Q: Tensor, scalars: Tensor) -> tuple:
    lanes = torch.broadcast_shapes(Q.shape[-1:], scalars.shape[-1:])
    lead = torch.broadcast_shapes(Q.shape[:-3], scalars.shape[:-2])
    return lead + Q.shape[-3:-1] + lanes


def scalar_bit(scalars: Tensor, i: int) -> Tensor:
    """Bit i of batched 16-bit scalar limbs (..., S, B) -> (..., B) bool."""
    return ((scalars[..., i // 16, :] >> (i % 16)) & 1) != 0


def smul_plain(F: weier.FieldAdapter, Q: Tensor, scalars: Tensor, nbits: int) -> Tensor:
    """[k]Q: MSB-first double-and-add from infinity, select per lane."""
    acc = _inf_like(F, _acc_shape(Q, scalars))
    for i in range(nbits - 1, -1, -1):
        bit = scalar_bit(scalars, i)
        D = double_plain(F, acc)
        acc = torch.where(bit[..., None, None, :], add_plain(F, D, Q), D)
    return acc


def smul_static_plain(F: weier.FieldAdapter, Q: Tensor, bits) -> Tensor:
    """[k]Q for one scalar given by its MSB-first bits: a double at every
    bit and the add only at one-bits, from infinity (``_smul_static_kernel``)."""
    acc = _inf_like(F, Q.shape)
    for bit in bits:
        acc = double_plain(F, acc)
        if bit:
            acc = add_plain(F, acc, Q)
    return acc


# ------------------------------------------------------------------ launches --
def _check(F, *points: Tensor, scalars: Optional[Tensor] = None,
           affine: Optional[Tensor] = None) -> None:
    """Refuse what the kernels do not take: a limb count other than 16, 18 or 24,
    points not shaped (..., 3, L, B) (affine: (..., 2, L, B)), dtypes other
    than int32, mixed devices."""
    L = F.fp.L
    if L not in build.KERNEL_LS:
        raise ValueError(
            f"the CUDA G1 kernels take L = 16, 18 or 24 limbs (8, 9 or 12 32-bit words), got L={L}"
        )
    for t in points:
        if t.shape[-3:-1] != (3, L):
            raise ValueError(f"points must be (..., 3, {L}, B), got {tuple(t.shape)}")
    if affine is not None and affine.shape[-3:-1] != (2, L):
        raise ValueError(f"affine points must be (..., 2, {L}, B), got {tuple(affine.shape)}")
    tensors = points + tuple(t for t in (scalars, affine) if t is not None)
    for t in tensors:
        if t.device != points[0].device:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {t.dtype}")


def _to_lanes(P: Tensor):
    """(..., k, L, B) -> ((k, L, n) contiguous, restore)."""
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


def _lane_mask(m: Tensor, P: Tensor, what: str) -> Tensor:
    """A (..., B) bool mask, broadcast to P's lanes, flat and contiguous."""
    m = m.to(torch.bool).expand(P.shape[:-3] + P.shape[-1:]).reshape(-1).contiguous()
    if m.device != P.device:
        raise ValueError(f"{what} must be on the points' device")
    return m


def _launch(kernel, name: str, F, P: Tensor, Q: Tensor, masks=(), out: Optional[Tensor] = None,
            affine: bool = False) -> Tensor:
    """Launch one of the two-point kernels on P (..., 3, L, B) and Q (of P's
    shape, or affine (..., 2, L, B)) with the bool lane masks ``masks``
    (sel, then neg), into ``out`` if given."""
    _check(F, P, *(() if affine else (Q,)), affine=Q if affine else None)
    if out is not None:
        _check_out(out, P.shape, P.device, P, Q)
    masks = [_lane_mask(m, P, what) for m, what in zip(masks, ("sel", "neg"))]
    P2, restore = _to_lanes(P)
    Q2, _ = _to_lanes(Q)
    dst = torch.empty_like(P2) if out is None else out
    n = P2.shape[-1]
    if n:
        with torch.cuda.device(P.device):
            build.launch(name, P2.data_ptr(), Q2.data_ptr(), *(m.data_ptr() for m in masks),
                         dst.data_ptr(), n, F.fp.L,
                         ctypes.addressof(build.consts(F.fp.p, F.fp.L)), F.b3, build.stream(P))
        kernel.launches += 1
    return restore(dst) if out is None else out


def add(F: weier.FieldAdapter, P: Tensor, Q: Tensor, out: Optional[Tensor] = None) -> Tensor:
    """P + Q, into ``out`` if given."""
    P, Q = torch.broadcast_tensors(P, Q)
    if P.device.type == "cpu":
        return add_plain(F, P, Q, out)
    _require_cuda(P)
    return _launch(add, "mlt_g1_add", F, P, Q, out=out)


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


def addsel(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor,
           out: Optional[Tensor] = None) -> Tensor:
    """select(sel, P + Q, Q), sel a (..., B) bool tensor, into ``out`` if given."""
    if P.device.type == "cpu":
        return addsel_plain(F, P, Q, sel, out)
    _require_cuda(P)
    P, Q = torch.broadcast_tensors(P, Q)
    return _launch(addsel, "mlt_g1_addsel", F, P, Q, (sel,), out)


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


def smul_static(F: weier.FieldAdapter, Q: Tensor, bits) -> Tensor:
    """[k]Q for projective Q (..., 3, L, B) and one scalar shared by every
    lane, its MSB-first bits (copied to the card once per pattern, so one
    build serves every static scalar); the whole ladder runs in one launch."""
    if Q.device.type == "cpu":
        return smul_static_plain(F, Q, bits)
    _require_cuda(Q)
    _check(F, Q)
    dev_bits = F.fp.device_bits(bits, Q.device)
    Q2, restore = _to_lanes(Q)
    out = torch.empty_like(Q2)
    n = Q2.shape[-1]
    if n:
        with torch.cuda.device(Q.device):
            build.launch("mlt_g1_smul_static", Q2.data_ptr(), dev_bits.data_ptr(), dev_bits.numel(),
                         out.data_ptr(), n, F.fp.L,
                         ctypes.addressof(build.consts(F.fp.p, F.fp.L)), F.b3, build.stream(Q))
        smul_static.launches += 1
    return restore(out)


def dbladd(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor) -> Tensor:
    """select(sel, 2P + Q, 2P), sel a (..., B) bool tensor: one scalar-mul
    step in one launch."""
    if P.device.type == "cpu":
        return dbladd_plain(F, P, Q, sel)
    _require_cuda(P)
    P, Q = torch.broadcast_tensors(P, Q)
    return _launch(dbladd, "mlt_g1_dbladd", F, P, Q, (sel,))


def addselneg(F: weier.FieldAdapter, P: Tensor, Q: Tensor, sel: Tensor, neg: Tensor,
              out: Optional[Tensor] = None) -> Tensor:
    """select(sel, P + Q', Q') with Q' = neg ? (X, sub(0, Y), Z) : Q: the
    signed-digit scan combiner, into ``out`` if given."""
    if P.device.type == "cpu":
        return addselneg_plain(F, P, Q, sel, neg, out)
    _require_cuda(P)
    P, Q = torch.broadcast_tensors(P, Q)
    return _launch(addselneg, "mlt_g1_addselneg", F, P, Q, (sel, neg), out)


def maddsel(F: weier.FieldAdapter, P: Tensor, Qa: Tensor, sel: Tensor,
            out: Optional[Tensor] = None) -> Tensor:
    """select(sel, P + lift(Qa), lift(Qa)) for affine Qa (..., 2, L, B): the
    mixed-add scan combiner, into ``out`` if given.  Qa must not be the
    (0, 0) of infinity on a selected lane (the MSM zeroes the scalars of
    infinity inputs)."""
    if P.device.type == "cpu":
        return maddsel_plain(F, P, Qa, sel, out)
    _require_cuda(P)
    return _launch(maddsel, "mlt_g1_maddsel", F, P, _affine_like(P, Qa), (sel,), out, affine=True)


def maddselneg(F: weier.FieldAdapter, P: Tensor, Qa: Tensor, sel: Tensor, neg: Tensor,
               out: Optional[Tensor] = None) -> Tensor:
    """The mixed-add combiner with the signed combiner's negation of Y, into
    ``out`` if given."""
    if P.device.type == "cpu":
        return maddselneg_plain(F, P, Qa, sel, neg, out)
    _require_cuda(P)
    return _launch(maddselneg, "mlt_g1_maddselneg", F, P, _affine_like(P, Qa), (sel, neg), out,
                   affine=True)


# launch counts: a plain integer on each wrapper, raised only where it launches
KERNELS = (add, double, addsel, smul, dbladd, addselneg, maddsel, maddselneg, smul_static)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
