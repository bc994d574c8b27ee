"""The hash-to-G1 kernel for Hopper (port of ``mathlib_tpu/ops/kernels/hash_pallas.py``).

One kernel, CUDA C++ in ``csrc/hash_kernels.cu``:

* ``hash_g1`` replaces ``hash_pallas._hash_g1_kernel`` / ``hash_g1_pallas``,
  which the reference's ``HashG1Ctx.hash_to_g1`` reaches on a TPU for the
  signs "parity" and "be"; the port's ``HashG1Ctx.hash_to_g1`` reaches it on
  a card.  (u0, u1) Montgomery ``(L, B)`` field batches in, ``(3, L, B)``
  projective points out: both SSWU maps with their inversion and square-root
  chains, the sign fix, the 11-isogeny, one RCB add and the [h_eff] ladder,
  in one launch.

``hash_g1_plain`` is the same algorithm, operation for operation, in int64
PyTorch (the body's 4-bit fixed-window chains, the canonical sign, the
relaxed negation, the RCB formulas of ``g1_cuda``), so its limbs are the
reference body's; the CPU tests hold it to that body on numpy rows.  On a CPU
tensor the wrapper returns it; on a CUDA tensor it launches the kernel on the
current stream, adds one to its ``launches`` count, and raises if the launch
fails; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, g1_cuda

Tensor = torch.Tensor

SIGNS = ("parity", "be")


def _bits_msb(e: int) -> np.ndarray:
    return np.array([int(b) for b in bin(e)[2:]], dtype=np.uint8)


def chain_bits(p: int):
    """MSB-first bits of the inversion exponent p - 2 and the square-root
    exponent (p + 1)/4 (p = 3 mod 4)."""
    return _bits_msb(p - 2), _bits_msb((p + 1) // 4)


def _in_gate(ctx) -> None:
    from ...curves import isogeny_data

    spec = ctx.spec
    if isogeny_data.G1.get(spec.name) is None or spec.p % 4 != 3:
        raise ValueError(f"{spec.name}: outside the hash_g1 gate (G1 isogeny data and p % 4 == 3)")


# ------------------------------------------------------------ plain version --
def pow_win4_plain(fp, a: Tensor, bits) -> Tensor:
    """a**e (int64 limbs), e's MSB-first bits, by the body's 4-bit fixed
    window (``hash_pallas._pow_ref``): the table a^0..a^15 (a^0 = R mod p),
    the leading len(bits) % 4 bits selected from it, then per window four
    squarings and one product with the selected entry (also for a zero
    digit: the product with R mod p moves the relaxed representative)."""
    mul = fp._mont_mul64
    tab = [fp.one_mont.to(a.device).expand(a.shape), a]
    for _ in range(14):
        tab.append(mul(tab[-1], a))
    bits = [int(b) for b in bits]
    head = len(bits) % 4
    d = 0
    for b in bits[:head]:
        d = 2 * d + b
    acc = tab[d]
    for i in range(head, len(bits), 4):
        for _ in range(4):
            acc = mul(acc, acc)
        acc = mul(acc, tab[bits[i] * 8 + bits[i + 1] * 4 + bits[i + 2] * 2 + bits[i + 3]])
    return acc


def _canon64(fp, a: Tensor) -> Tensor:
    return fp._cond_sub(a, fp.r_minus_p)


def sign_plain(fp, a: Tensor, sign: str) -> Tensor:
    """(..., L, B) int64 Montgomery -> (..., B) bool sign bits: RFC sgn0 (the
    parity of the canonical integer) or the BBS big-endian sign
    std <= p - std, i.e. std <= (p - 1)/2 (``_parity``, ``_le_neg``)."""
    one = torch.zeros_like(fp.one_mont)
    one[0] = 1
    std = _canon64(fp, fp._mont_mul64(a, one))
    if sign == "parity":
        return (std[..., 0, :] & 1) == 1
    half = torch.from_numpy(
        np.array([((fp.p - 1) // 2 >> (16 * k)) & 0xFFFF for k in range(fp.L)], dtype=np.int64)
    ).to(a.device)[:, None]
    weight = (1 << torch.arange(fp.L, device=a.device, dtype=torch.int64))[:, None]
    # the sign of sum_k sign(std_k - half_k) 2^k is that of the top limb
    # where they differ
    return (torch.sign(std - half) * weight).sum(dim=-2) <= 0


def sswu_plain(ctx, u: Tensor, sign: str):
    """Both SSWU maps of ``_sswu_body`` on int64 limbs u (..., L, B): the
    map onto E', the exceptional t2 = 0 select, the choice by is_square and
    the sign fix.  Returns int64 (x, y)."""
    fp = ctx.fp
    mul, add = fp._mont_mul64, fp._add64
    c = {k: v.to(torch.int64) for k, v in ctx.consts().items()}
    inv_bits, sqrt_bits = chain_bits(fp.p)
    t1 = mul(mul(u, u), c["Z"])
    t2 = add(mul(t1, t1), t1)
    x1 = mul(add(pow_win4_plain(fp, t2, inv_bits), fp.one_mont.to(u.device)), c["negB_over_A"])
    z2 = (_canon64(fp, t2) == 0).all(dim=-2, keepdim=True)
    x1 = torch.where(z2, c["B_over_ZA"], x1)
    gx1 = add(mul(add(mul(x1, x1), c["A"]), x1), c["B"])
    x2 = mul(t1, x1)
    gx2 = mul(gx1, mul(t1, mul(t1, t1)))
    y1, y2 = pow_win4_plain(fp, torch.stack([gx1, gx2]), sqrt_bits).unbind(0)
    is_sq = (_canon64(fp, mul(y1, y1)) == _canon64(fp, gx1)).all(dim=-2, keepdim=True)
    x = torch.where(is_sq, x1, x2)
    y = torch.where(is_sq, y1, y2)
    flip = sign_plain(fp, u, sign) != sign_plain(fp, y, sign)
    y = torch.where(flip.unsqueeze(-2), fp._sub64(torch.zeros_like(y), y), y)
    return x, y


def iso_project_plain(ctx, x: Tensor, y: Tensor) -> Tensor:
    """``_iso_project``: Horner from each polynomial's leading coefficient,
    X = xn*yd, Y = y*(yn*xd), Z = xd*yd -> (..., 3, L, B) int64."""
    fp = ctx.fp
    mul, add = fp._mont_mul64, fp._add64
    evals = []
    for coeffs in ctx.iso:
        cs = [cf.to(torch.int64) for cf in coeffs]
        acc = cs[-1].expand(x.shape)
        for cf in reversed(cs[:-1]):
            acc = add(mul(acc, x), cf)
        evals.append(acc)
    xn, xd, yn, yd = evals
    return torch.stack([mul(xn, yd), mul(y, mul(yn, xd)), mul(xd, yd)], dim=-3)


def hash_g1_plain(ctx, u0: Tensor, u1: Tensor, sign: str = "parity") -> Tensor:
    """The kernel's algorithm in PyTorch: (L, B) u0, u1 -> (3, L, B) int32."""
    F = ctx.g1.F
    u = torch.stack([u0, u1]).to(torch.int64)  # both maps as one batch
    x, y = sswu_plain(ctx, u, sign)
    Pa, Pb = iso_project_plain(ctx, x, y).to(torch.int32).unbind(0)
    P = g1_cuda.add_plain(F, Pa, Pb)
    acc = P
    for bit in ctx.h_bits[1:]:
        acc = g1_cuda.double_plain(F, acc)
        if bit:
            acc = g1_cuda.add_plain(F, acc, P)
    if ctx.h_neg:
        acc = g1_cuda._neg_y(F, acc, torch.ones(acc.shape[-1:], dtype=torch.bool, device=acc.device))
    return acc


# ------------------------------------------------------------------- launch --
def const_words(ctx, device) -> Tensor:
    """The kernel's constant array, copied to ``device`` once per context:
    the four isogeny polynomial lengths, then Z, A, B, -B/A, B/(ZA) and the
    coefficients (Montgomery, 32-bit words)."""
    key = str(device)
    if key not in ctx._dev:
        c = ctx.consts()

        def words(t):
            limbs = t.reshape(-1).cpu().numpy().astype(np.uint32)
            return limbs[0::2] | (limbs[1::2] << 16)

        parts = [np.array([len(cs) for cs in ctx.iso], dtype=np.uint32)]
        parts += [words(c[name]) for name in ("Z", "A", "B", "negB_over_A", "B_over_ZA")]
        parts += [words(cf) for cs in ctx.iso for cf in cs]
        arr = np.concatenate(parts).view(np.int32)
        ctx._dev[key] = torch.from_numpy(arr).to(device)
    return ctx._dev[key]


def hash_g1(ctx, u0: Tensor, u1: Tensor, sign: str = "parity") -> Tensor:
    """iso(sswu(u0)) + iso(sswu(u1)), cofactor-cleared, for (L, B) Montgomery
    field batches of a ``HashG1Ctx``'s curve -> (3, L, B) projective points,
    in one launch on a card."""
    if sign not in SIGNS:
        raise ValueError(f"sign must be one of {SIGNS}, got {sign!r}")
    _in_gate(ctx)
    L = ctx.fp.L
    if u0.shape != u1.shape or u0.dim() != 2 or u0.shape[0] != L:
        raise ValueError(f"u0 and u1 must both be ({L}, B), got {tuple(u0.shape)}, {tuple(u1.shape)}")
    if u0.dtype != torch.int32 or u1.dtype != torch.int32:
        raise TypeError("limb tensors must be torch.int32")
    if u0.device.type == "cpu" and u1.device.type == "cpu":
        return hash_g1_plain(ctx, u0, u1, sign)
    if u0.device.type != "cuda" or u1.device != u0.device:
        raise ValueError(f"hash_g1 runs on CPU (plain) or CUDA tensors, got {u0.device}, {u1.device}")
    if L != 24:
        raise ValueError(f"the CUDA hash_g1 kernel takes L = 24 limbs (12 32-bit words), got L={L}")
    n = u0.shape[-1]
    out = torch.empty((3, L, n), dtype=torch.int32, device=u0.device)
    if n:
        inv_bits, sqrt_bits = chain_bits(ctx.fp.p)
        dev = u0.device
        invb, sqrtb = ctx.fp.device_bits(inv_bits, dev), ctx.fp.device_bits(sqrt_bits, dev)
        hb = ctx.fp.device_bits(ctx.h_bits, dev)
        hc = const_words(ctx, dev)
        a, b = u0.contiguous(), u1.contiguous()
        with torch.cuda.device(dev):
            build.launch("mlt_hash_g1", a.data_ptr(), b.data_ptr(), invb.data_ptr(), invb.numel(),
                         sqrtb.data_ptr(), sqrtb.numel(), hb.data_ptr(), hb.numel(),
                         int(ctx.h_neg), hc.data_ptr(), SIGNS.index(sign), out.data_ptr(), n, L,
                         ctypes.addressof(build.consts(ctx.fp.p, L)), ctx.g1.F.b3,
                         build.stream(u0))
        hash_g1.launches += 1
    return out


KERNELS = (hash_g1,)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
