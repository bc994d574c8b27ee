"""Base-field kernels for Hopper (port of ``mathlib_tpu/ops/kernels/fp_pallas.py``
and of ``pairing_pallas.py _fp_pow_kernel``).

Two kernels, CUDA C++ in ``csrc/fp_kernels.cu``:

* ``mont_mul`` replaces ``fp_pallas._mont_mul_kernel`` / ``mont_mul_pallas``,
  which the reference's ``FpCtx.mont_mul`` reaches on a TPU; the port's
  ``FpCtx.mont_mul``, ``sqr``, ``from_mont`` and ``to_mont`` reach it on a
  card.  On the pairing paths it is the Montgomery entry of the encoded
  pairs; on the G1 paths the products of ``G1Ctx.eq``/``to_affine`` and
  the GLV endomorphism.  Below ``MONT_GROUP_BELOW`` elements a call runs
  ``mont_mul_group_kernel`` (four threads share an element's product), from
  there ``mont_mul_kernel`` (one element a thread): ``mont_group``.
* ``fp_pow`` replaces ``pairing_pallas._fp_pow_kernel`` / ``fp_pow_pallas``,
  behind ``FpCtx.pow_bits`` (``inv``, ``batch_inv``, ``sqrt``): the one
  chain of ``batch_inv`` in ``g1_scalar_mul``, sign and verify, and the G2
  map's inverses and square roots in ``hash_to_g2_batch``.  Below
  ``POW_GROUP_BELOW`` elements a call runs ``fp_pow_group_kernel`` (four
  threads share each product of an element's chain), from there
  ``fp_pow_kernel`` (one element a thread): ``pow_group``.

Both take L = 16, 18 and 24 limbs (8, 9 and 12 32-bit words); nine words
(FP256BN on the card) do not split into the group bodies' four slices, so
there the launchers run the one-thread bodies whatever the group.

On a CPU tensor each wrapper returns its plain version.  On a CUDA tensor it
launches the kernel on the current stream, adds one to its ``launches``
count, and raises if the launch fails; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..field import FpCtx
from . import build

Tensor = torch.Tensor


def mont_mul_plain(fp: FpCtx, a: Tensor, b: Tensor) -> Tensor:
    return fp.mont_mul_plain(a, b)


# elements of a call from which mont_mul runs one element a thread: below,
# a group of four threads shares each element's product, whose chain is
# then what the call waits for (PERF.md section 6)
MONT_GROUP_BELOW = 1 << 14


def mont_group(elements: int) -> int:
    """Threads an element of the ``mont_mul`` kernel for a call of
    ``elements``: 4 (``mont_mul_group_kernel``) below ``MONT_GROUP_BELOW``,
    else 1 (``mont_mul_kernel``)."""
    return 4 if elements < MONT_GROUP_BELOW else 1


def mont_mul(fp: FpCtx, a: Tensor, b: Tensor) -> Tensor:
    """a * b * R^-1 mod p for broadcast (..., L, B) limb tensors.  One (L, 1)
    constant operand goes to the kernel as it is (the product commutes);
    otherwise both are broadcast to one shape.  The result is contiguous,
    shaped as the broadcast."""
    if a.device.type == "cpu":
        return mont_mul_plain(fp, a, b)
    L = fp.L
    if L not in build.KERNEL_LS:
        raise ValueError(f"the CUDA mont_mul kernel takes L = 16, 18 or 24 limbs, got L={L}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mont_mul runs on CPU (plain) or CUDA tensors, got {a.device}, {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("limb tensors must be torch.int32")
    if tuple(a.shape) == (L, 1) and tuple(b.shape) != (L, 1):
        a, b = b, a
    if tuple(b.shape) != (L, 1):
        a, b = torch.broadcast_tensors(a, b)
    if a.dim() < 2 or a.shape[-2] != L:
        raise ValueError(f"expected (..., {L}, B) limbs, got {tuple(a.shape)}")
    const = tuple(b.shape) == (L, 1)
    n = a.shape[-1]
    a3 = a.reshape(-1, L, n).contiguous()
    b3 = b.contiguous() if const else b.reshape(-1, L, n).contiguous()
    out = torch.empty_like(a3)
    rows = a3.shape[0]
    if rows * n >= 1 << 31:
        raise ValueError("the kernel indexes elements with a 32-bit int")
    if rows * n:
        with torch.cuda.device(a.device):
            build.launch("mlt_fp_mont_mul", a3.data_ptr(), b3.data_ptr(), 0 if const else 1,
                         out.data_ptr(), rows, n, L, ctypes.addressof(build.consts(fp.p, L)),
                         mont_group(rows * n), build.stream(a))
        mont_mul.launches += 1
    return out.reshape(a.shape)


def fp_pow_plain(fp: FpCtx, a: Tensor, bits) -> Tensor:
    """a**e for (..., L, B) limbs, e's MSB-first bits: square, then multiply
    by a at each one bit (``_fp_pow_kernel``, and ``RowTower.fp_pow`` in the
    reference's final exp; the reference computes the product at every bit
    and selects it, which gives the same values).  The square is a
    Montgomery product of acc with itself: REDC's output depends on the
    product alone, so it equals ``RowCtx.sqr``."""
    acc = fp.one_mont.to(a.device).expand(a.shape)
    a = a.to(torch.int64)
    for bit in bits:
        acc = fp._mont_mul64(acc, acc)
        if bit:
            acc = fp._mont_mul64(acc, a)
    return acc.to(torch.int32)


# elements of a call from which fp_pow runs one element a thread: below, a
# group of four threads shares each product of an element's chain, which
# the call then waits for.  A BLS12-381 chain of p - 2, grouped against one
# element a thread (ms; NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
# --time-hash and a timing at 16,384; PERF.md section 6): 2,048 elements
# 0.436 against 0.928, 4,096 0.437 against 0.945, 8,192 0.556 against
# 0.948, 16,384 0.939 against 0.944, 32,768 1.770 against 1.365
POW_GROUP_BELOW = 1 << 14


def pow_group(elements: int) -> int:
    """Threads an element of the ``fp_pow`` kernel for a call of
    ``elements``: 4 (``fp_pow_group_kernel``) below ``POW_GROUP_BELOW``,
    else 1 (``fp_pow_kernel``)."""
    return 4 if elements < POW_GROUP_BELOW else 1


def fp_pow(fp: FpCtx, a: Tensor, bits) -> Tensor:
    """a**e for (..., L, B) limb tensors, e's MSB-first bits (copied to the
    card once per pattern, so one build serves every exponent).  The result
    is contiguous, shaped as a."""
    if a.device.type == "cpu":
        return fp_pow_plain(fp, a, bits)
    L = fp.L
    if L not in build.KERNEL_LS:
        raise ValueError(f"the CUDA fp_pow kernel takes L = 16, 18 or 24 limbs, got L={L}")
    if a.device.type != "cuda":
        raise ValueError(f"fp_pow runs on CPU (plain) or CUDA tensors, got {a.device}")
    if a.dtype != torch.int32:
        raise TypeError("limb tensors must be torch.int32")
    if a.dim() < 2 or a.shape[-2] != L:
        raise ValueError(f"expected (..., {L}, B) limbs, got {tuple(a.shape)}")
    dev_bits = fp.device_bits(bits, a.device)
    n = a.shape[-1]
    a3 = a.reshape(-1, L, n).contiguous()
    out = torch.empty_like(a3)
    rows = a3.shape[0]
    if rows * n >= 1 << 31:
        raise ValueError("the kernel indexes elements with a 32-bit int")
    if rows * n:
        with torch.cuda.device(a.device):
            build.launch("mlt_fp_pow", a3.data_ptr(), dev_bits.data_ptr(), dev_bits.numel(),
                         out.data_ptr(), rows, n, L, ctypes.addressof(build.consts(fp.p, L)),
                         pow_group(rows * n), build.stream(a))
        fp_pow.launches += 1
    return out.reshape(a.shape)


KERNELS = (mont_mul, fp_pow)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
