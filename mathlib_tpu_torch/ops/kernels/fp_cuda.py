"""Batched Montgomery product for Hopper (port of ``mathlib_tpu/ops/kernels/fp_pallas.py``).

One kernel, CUDA C++ in ``csrc/fp_kernels.cu``: ``mont_mul`` replaces
``fp_pallas._mont_mul_kernel`` / ``mont_mul_pallas``, which the reference's
``FpCtx.mont_mul`` reaches on a TPU.  On the pairing-check path it is the
Montgomery entry of the encoded pairs (``FpCtx.to_mont``).

On a CPU tensor the wrapper returns its plain version (``FpCtx.mont_mul``).
On a CUDA tensor it launches the kernel on the current stream, adds one to
its ``launches`` count, and raises if the launch fails; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..field import FpCtx
from . import build

Tensor = torch.Tensor


def mont_mul_plain(fp: FpCtx, a: Tensor, b: Tensor) -> Tensor:
    return fp.mont_mul(a, b)


def mont_mul(fp: FpCtx, a: Tensor, b: Tensor) -> Tensor:
    """a * b * R^-1 mod p for (..., L, B) limb tensors; b is one (L, 1)
    constant (broadcast over every element of a) or has a's shape.  The
    result is contiguous, shaped as a."""
    if a.device.type == "cpu":
        return mont_mul_plain(fp, a, b)
    L = fp.L
    if L not in (16, 24):
        raise ValueError(f"the CUDA mont_mul kernel takes L = 16 or 24 limbs, got L={L}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mont_mul runs on CPU (plain) or CUDA tensors, got {a.device}, {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("limb tensors must be torch.int32")
    if a.dim() < 2 or a.shape[-2] != L:
        raise ValueError(f"expected (..., {L}, B) limbs, got {tuple(a.shape)}")
    const = tuple(b.shape) == (L, 1)
    if not const and b.shape != a.shape:
        raise ValueError(f"b must be (L, 1) or a's shape, got {tuple(b.shape)}")
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
                         build.stream(a))
        mont_mul.launches += 1
    return out.reshape(a.shape)


KERNELS = (mont_mul,)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
