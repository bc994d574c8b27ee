"""Pairing-product kernels for Hopper (port of the fused Miller + product kernels of
``mathlib_tpu/ops/kernels/pairing_pallas.py``).

Two kernels, CUDA C++ in ``csrc/pairing_kernels.cu`` over ``csrc/tower_rows.cuh``,
each behind a wrapper here:

===================  =========================================  ==============================
wrapper              computes                                   replaces (TPU kernel)
===================  =========================================  ==============================
``miller_lanes``     per lane: Miller loop, conjugation, BN     front half of
                     Frobenius tail; lanes >= n set to one      ``_pairing_prod_kernel`` and
                                                                ``_pairing_prod_seg_kernel``
                                                                (``_miller_conj_tail``,
                                                                ``_mask_pad_to_one``)
``f12_seg_product``  product of each aligned segment of ``seg``  their rotation product
                     lanes (a tree, one launch per level)       (``_product_all_positions``)
===================  =========================================  ==============================

Together they replace ``_pairing_prod_kernel`` (``pairing_product_pallas``)
and ``_pairing_prod_seg_kernel`` (``pairing_products_pallas``).  Each
wrapper takes a ``MillerCfg`` (the curve's ``RowTower``, loop bits, and
tail constants) and int32 limb tensors.  On a CPU tensor it returns its plain
PyTorch version (``*_plain``, on ``tower_rows.RowTower``, bit-equal to the
reference's kernel body).  On a CUDA tensor it launches its kernel on the
current stream, adds one to its ``launches`` count per launch, and raises if
a launch fails; it never falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..field import FpCtx
from . import build
from .tower_rows import MulBatch, RowTower

Tensor = torch.Tensor


@dataclass
class MillerCfg:
    """What the pairing kernels need of one curve: its in-kernel tower, the
    Miller loop's bits (MSB-first, leading one skipped), whether the loop
    parameter is negative, and the BN tail's twist Frobenius constants
    (cx1, cy1, cx2, cy2) as host Fp2 pairs, or None on BLS12 curves."""

    tower: RowTower
    bits: np.ndarray
    conj_end: bool
    tail: Optional[Tuple] = None
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def fp(self) -> FpCtx:
        return self.tower.fp

    def tail_limbs(self, device) -> Tensor:
        """(4, 2, L, 1) int64 Montgomery limbs of the tail constants."""
        return self.fp.encode(np.array(self.tail, dtype=object)[..., None]).to(device, torch.int64)


# ------------------------------------------------------------ plain versions --
def miller_lanes_plain(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor,
                       n: int) -> Tensor:
    """(2, 3, 2, L, B) int32: the Miller value of lanes < n, one elsewhere."""
    tw = cfg.tower
    B = xP.shape[-1]
    m = max(0, min(n, B))
    x, y, qx, qy = (t[..., :m].to(torch.int64) for t in (xP, yP, Qx, Qy))
    f = tw.f12_one_like(m, xP.device)
    one2 = f[0, 0]  # (2, L, m): the f2 one
    T = torch.stack([qx, qy, one2], dim=-4)
    if m:
        for bit in cfg.bits:
            line, T = tw.dbl_step(T, x, y)
            f = tw.f12_sparse_mul(tw.f12_sqr(f), *line)
            if bit:
                line, T = tw.add_step(T, qx, qy, x, y)
                f = tw.f12_sparse_mul(f, *line)
        if cfg.conj_end:
            f = tw.f12_conj(f)
        if cfg.tail is not None:
            if cfg.conj_end:
                T = torch.stack([T[0], tw.neg(T[1]), T[2]], dim=-4)
            cx1, cy1, cx2, cy2 = cfg.tail_limbs(xP.device)
            mb = MulBatch(tw.fp)
            r1x = tw.q_mul(mb, tw.conj(qx), cx1)
            r1y = tw.q_mul(mb, tw.conj(qy), cy1)
            r2x = tw.q_mul(mb, qx, cx2)
            r2y = tw.q_mul(mb, qy, cy2)
            o = mb.run()
            line, T = tw.add_step(T, r1x(o), r1y(o), x, y)
            f = tw.f12_sparse_mul(f, *line)
            line, T = tw.add_step(T, r2x(o), tw.neg(r2y(o)), x, y)
            f = tw.f12_sparse_mul(f, *line)
    pad = tw.f12_one_like(B - m, xP.device)
    return torch.cat([f, pad], dim=-1).to(torch.int32)


def f12_seg_product_plain(cfg: MillerCfg, f: Tensor, seg: int) -> Tensor:
    """(2, 3, 2, L, B) -> (2, 3, 2, L, B/seg): the product of each aligned
    segment, by the tree the kernel runs (lanes 2i and 2i+1 per level)."""
    _check_seg(f, seg)
    x = f.to(torch.int64)
    while x.shape[-1] > f.shape[-1] // seg:
        x = cfg.tower.f12_mul(x[..., 0::2], x[..., 1::2])
    return x.to(torch.int32)


def _check_seg(f: Tensor, seg: int) -> None:
    B = f.shape[-1]
    if seg < 1 or seg & (seg - 1) or B % seg:
        raise ValueError(f"seg must be a power of two dividing the {B} lanes, got {seg}")


# ------------------------------------------------------------------ launches --
def _tower_args(cfg: MillerCfg):
    """(int32[5], uint32[4*2*NW]) ctypes arrays: tower flags and tail words."""
    key = "tower_args"
    if key not in cfg._dev:
        tw, nw = cfg.tower, cfg.fp.L // 2
        ints = [tw.n, tw.xi0, int(tw.twist == "M"), int(cfg.conj_end), int(cfg.tail is not None)]
        words = [0] * (8 * nw)
        if cfg.tail is not None:
            p, R = cfg.fp.p, cfg.fp.R
            for a, pair in enumerate(cfg.tail):
                for c, v in enumerate(pair):
                    m = v % p * R % p
                    for j in range(nw):
                        words[(a * 2 + c) * nw + j] = (m >> (32 * j)) & 0xFFFFFFFF
        cfg._dev[key] = ((ctypes.c_int32 * 5)(*ints), (ctypes.c_uint32 * len(words))(*words))
    return cfg._dev[key]


def _bits_on(cfg: MillerCfg, device) -> Tensor:
    key = ("bits", str(device))
    if key not in cfg._dev:
        cfg._dev[key] = torch.from_numpy(np.asarray(cfg.bits, dtype=np.uint8)).to(device)
    return cfg._dev[key]


def _check(cfg: MillerCfg, *tensors: Tensor, shapes) -> None:
    """Refuse what the kernels do not take."""
    L = cfg.fp.L
    if L not in (16, 24):
        raise ValueError(
            f"the CUDA pairing kernels take L = 16 or 24 limbs (8 or 12 32-bit words), got L={L}"
        )
    dev = tensors[0].device
    for t, want in zip(tensors, shapes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"pairing kernels run on CPU (plain) or CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"expected shape {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("limb tensors must be contiguous")
    if tensors[0].shape[-1] >= 1 << 31:
        raise ValueError("the kernels index lanes with a 32-bit int")


def miller_lanes(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor,
                 n: int) -> Tensor:
    """Per-lane Miller values (2, 3, 2, L, B) of affine G1 (xP, yP: (L, B))
    and G2 (Qx, Qy: (2, L, B)) points in Montgomery form; lanes >= n are the
    f12 one whatever their inputs hold."""
    if xP.device.type == "cpu":
        return miller_lanes_plain(cfg, xP, yP, Qx, Qy, n)
    L, B = xP.shape[-2:]
    _check(cfg, xP, yP, Qx, Qy, shapes=[(L, B), (L, B), (2, L, B), (2, L, B)])
    out = torch.empty((2, 3, 2, L, B), dtype=torch.int32, device=xP.device)
    if B:
        bits = _bits_on(cfg, xP.device)
        ints, tail = _tower_args(cfg)
        with torch.cuda.device(xP.device):
            build.launch("mlt_pairing_miller_lanes", xP.data_ptr(), yP.data_ptr(),
                         Qx.data_ptr(), Qy.data_ptr(), bits.data_ptr(), len(cfg.bits),
                         max(0, min(n, B)), out.data_ptr(), B, L,
                         ctypes.addressof(build.consts(cfg.fp.p, L)), ctypes.addressof(ints),
                         ctypes.addressof(tail), build.stream(xP))
        miller_lanes.launches += 1
    return out


def f12_seg_product(cfg: MillerCfg, f: Tensor, seg: int) -> Tensor:
    """(2, 3, 2, L, B) -> (2, 3, 2, L, B/seg): one product per aligned
    segment of ``seg`` lanes (a power of two); ``seg == B`` multiplies all
    lanes.  On the card: log2(seg) launches, each multiplying lane pairs."""
    if f.device.type == "cpu":
        return f12_seg_product_plain(cfg, f, seg)
    L, B = f.shape[-2:]
    _check(cfg, f, shapes=[(2, 3, 2, L, B)])
    _check_seg(f, seg)
    ints, tail = _tower_args(cfg)
    with torch.cuda.device(f.device):
        while f.shape[-1] > B // seg:
            half = f.shape[-1] // 2
            out = torch.empty((2, 3, 2, L, half), dtype=torch.int32, device=f.device)
            build.launch("mlt_f12_pair_mul", f.data_ptr(), out.data_ptr(), half, L,
                         ctypes.addressof(build.consts(cfg.fp.p, L)), ctypes.addressof(ints),
                         ctypes.addressof(tail), build.stream(f))
            f12_seg_product.launches += 1
            f = out
    return f


KERNELS = (miller_lanes, f12_seg_product)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
