"""Pairing kernels for Hopper (port of the fused Miller, product, step, pow and
final-exponentiation kernels of ``mathlib_tpu/ops/kernels/pairing_pallas.py``).

CUDA C++ in ``csrc/miller_split_kernels.cu`` (the Miller loops and the
addition step, one lane's work spread over the warps of a block, running
the programs of ``miller_prog``), ``csrc/fexp_split_kernels.cu`` (the power
chain and the final exponentiations, the same way, running the programs of
``fexp_prog``, and the product tree, several levels a launch, running
``tree_prog``'s) and ``csrc/check_kernels.cu`` (the one-launch check: the
same programs in one launch, by the scripts of ``check_prog``), each kernel
behind a wrapper here:

===================  =========================================  ==============================
wrapper              computes                                   replaces (TPU kernel)
===================  =========================================  ==============================
``miller_lanes``     per lane: Miller loop, conjugation, BN     front half of
                     Frobenius tail; lanes >= n set to one      ``_pairing_prod_kernel`` and
                                                                ``_pairing_prod_seg_kernel``
                                                                (``_miller_conj_tail``,
                                                                ``_mask_pad_to_one``)
``f12_seg_product``  product of each aligned segment of ``seg``  their rotation product
                     lanes (a tree, 4 levels a launch)          (``_product_all_positions``)
``miller_ft``        per lane: (f, T) after the Miller loop     ``_miller_kernel``
                                                                (``miller_pallas``)
``add_step``         per lane: (f l_{T,Q}(P), T + Q)            ``_add_step_kernel``
                                                                (``add_step_pallas``)
``f12_pow``          per lane: f^e, MSB-first bits, optional    ``_f12_pow_kernel``
                     cyclotomic squaring                        (``f12_pow_pallas``)
``final_exp``        per lane: the final exponentiation (easy   ``_final_exp_kernel``
                     part with the Fp12 inverse; hard part:     (``final_exp_pallas``);
                     BLS12 x-chains, or BN's base-p digit       on BN curves the easy part
                     chains and their Frobenius products)       around ``_fp_pow_kernel``
                                                                and one ``_f12_pow_kernel``
                                                                a digit
``pairing_check``    prod_i e(P_i, Q_i) == 1 in one launch:     ``_pairing_check_kernel``
                     Miller loops, pad lanes to one, the        (``pairing_check_pallas``)
                     product, final exp, unity test
===================  =========================================  ==============================

``miller_lanes`` and ``f12_seg_product`` together replace
``_pairing_prod_kernel`` (``pairing_product_pallas``) and
``_pairing_prod_seg_kernel`` (``pairing_products_pallas``).  Each wrapper
takes a config of the curve (``MillerCfg``: loop bits and tail, beside the
``TowerCfg`` that ``f12_pow`` and ``final_exp`` take: the ``RowTower``,
Frobenius constants, x or the hard part's base-p digits) and int32 limb
tensors.  On a CPU tensor it
returns its plain PyTorch version (``*_plain``, on ``tower_rows.RowTower``,
bit-equal to the reference's kernel body).  On a CUDA tensor it launches its
kernel on the current stream, adds one to its ``launches`` count per launch,
and raises if a launch fails; it never falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..field import FpCtx
from . import build, check_prog, fexp_prog, miller_prog, tree_prog
from .check_prog import tree_width
from .tower_rows import MulBatch, RowTower

Tensor = torch.Tensor


def msb_bits(e: int) -> np.ndarray:
    """The bits of e > 0, most significant first (uint8)."""
    return np.array([int(b) for b in bin(e)[2:]], dtype=np.uint8)


@dataclass
class TowerCfg:
    """What the tower kernels (``f12_pow``, ``final_exp``) need of one curve:
    its in-kernel tower, the Frobenius constants gamma_1, gamma_2 and
    gamma_3 as (3, 2, 3, 2, L, 1) Montgomery limbs (``gammas[n - 1]`` laid
    out as an f12: its coefficient (h, j) scales coefficient (h, j) of
    a^(p^n)), and the curve parameter x (BLS12) or the base-p digits of the
    hard-part exponent, lowest first (BN)."""

    tower: RowTower
    gammas: Optional[Tensor] = None
    x: Optional[int] = None
    digits: Optional[Tuple[int, ...]] = None
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def fp(self) -> FpCtx:
        return self.tower.fp

    def gamma_limbs(self, n: int, device) -> Tensor:
        """(2, 3, 2, L, 1) int64 Montgomery limbs of gamma_n."""
        return self.gammas[n - 1].to(device, torch.int64)

    @property
    def inv_bits(self) -> np.ndarray:
        """MSB-first bits of p - 2: the exponent of the base-field inverse."""
        return msb_bits(self.fp.p - 2)

    @property
    def x_bits(self) -> np.ndarray:
        """MSB-first bits of |x|: the exponent of the hard part's x-chains."""
        return msb_bits(abs(self.x))

    @property
    def digit_bits(self) -> list:
        """MSB-first bits of each BN hard-part digit, lowest digit first."""
        if self.digits is None:
            raise ValueError("the config holds no hard-part digits (a BLS12 curve takes x)")
        return [msb_bits(d) for d in self.digits]


@dataclass
class MillerCfg:
    """What the Miller kernels need of one curve: its ``TowerCfg``, the
    Miller loop's bits (MSB-first, leading one skipped), whether the loop
    parameter is negative, and the BN tail's twist Frobenius constants
    (cx1, cy1, cx2, cy2) as host Fp2 pairs, or None on BLS12 curves."""

    tc: TowerCfg
    bits: np.ndarray
    conj_end: bool
    tail: Optional[Tuple] = None
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def tower(self) -> RowTower:
        return self.tc.tower

    @property
    def fp(self) -> FpCtx:
        return self.tower.fp

    def tail_limbs(self, device) -> Tensor:
        """(4, 2, L, 1) int64 Montgomery limbs of the tail constants."""
        return self.fp.encode(np.array(self.tail, dtype=object)[..., None]).to(device, torch.int64)


# ------------------------------------------------------------ plain versions --
def _miller_loop(tw: RowTower, bits, x: Tensor, y: Tensor, qx: Tensor, qy: Tensor):
    """(f, T), int64, after the Miller loop over ``bits`` (``_miller_body``)."""
    f = tw.f12_one_like(x.shape[-1], x.device)
    T = torch.stack([qx, qy, f[0, 0]], dim=-4)  # f[0, 0]: the f2 one
    for bit in bits:
        line, T = tw.dbl_step(T, x, y)
        f = tw.f12_sparse_mul(tw.f12_sqr(f), *line)
        if bit:
            line, T = tw.add_step(T, qx, qy, x, y)
            f = tw.f12_sparse_mul(f, *line)
    return f, T


def miller_lanes_plain(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor,
                       n: int) -> Tensor:
    """(2, 3, 2, L, B) int32: the Miller value of lanes < n, one elsewhere."""
    tw = cfg.tower
    B = xP.shape[-1]
    m = max(0, min(n, B))
    x, y, qx, qy = (t[..., :m].to(torch.int64) for t in (xP, yP, Qx, Qy))
    f = tw.f12_one_like(m, xP.device)
    if m:
        f, T = _miller_loop(tw, cfg.bits, x, y, qx, qy)
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


def miller_ft_plain(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor):
    """(f (2, 3, 2, L, B), T (3, 2, L, B)) int32 after the Miller loop."""
    f, T = _miller_loop(cfg.tower, cfg.bits, *(t.to(torch.int64) for t in (xP, yP, Qx, Qy)))
    return f.to(torch.int32), T.to(torch.int32)


def add_step_plain(cfg: MillerCfg, f: Tensor, T: Tensor, Qx: Tensor, Qy: Tensor, xP: Tensor,
                   yP: Tensor):
    """(f * l_{T,Q}(P), T + Q), int32."""
    tw = cfg.tower
    line, T = tw.add_step(*(t.to(torch.int64) for t in (T, Qx, Qy, xP, yP)))
    f = tw.f12_sparse_mul(f.to(torch.int64), *line)
    return f.to(torch.int32), T.to(torch.int32)


def _f12_pow64(tw: RowTower, base: Tensor, bits, cyclo: bool, acc=None) -> Tensor:
    """acc * base^e, e's MSB-first bits (acc: one when None)."""
    acc = tw.f12_one_like(base.shape[-1], base.device) if acc is None else acc
    sqr = tw.f12_cyclo_sqr if cyclo else tw.f12_sqr
    for bit in bits:
        acc = sqr(acc)
        if bit:
            acc = tw.f12_mul(acc, base)
    return acc


def f12_pow_plain(cfg: TowerCfg, f: Tensor, bits, cyclo: bool = False) -> Tensor:
    """f^e per lane, e's MSB-first bits; cyclotomic squaring when ``cyclo``
    (valid for unitary f only)."""
    return _f12_pow64(cfg.tower, f.to(torch.int64), bits, cyclo).to(torch.int32)


def final_exp_plain(cfg: TowerCfg, f: Tensor, inv_bits, x_bits, x_neg: bool) -> Tensor:
    """The BLS12 final exponentiation of each lane (``_final_exp_body``):
    the easy part t = conj(f) / f, f1 = frob^2(t) t, with the inverse chain
    over ``inv_bits``; the hard part with the x-chains over ``x_bits``,
    conjugated when ``x_neg``."""
    tw = cfg.tower
    g1, g2 = (cfg.gamma_limbs(n, f.device) for n in (1, 2))
    f = f.to(torch.int64)
    t = tw.f12_mul(tw.f12_conj(f), tw.f12_inv(f, inv_bits))
    f1 = tw.f12_mul(tw.f12_frob(t, g2, 2), t)

    def exp_x(a):
        r = _f12_pow64(tw, a, x_bits, True)
        return tw.f12_conj(r) if x_neg else r

    def exp_xm1(a):
        return tw.f12_mul(exp_x(a), tw.f12_conj(a))

    y = exp_xm1(exp_xm1(f1))
    y = tw.f12_mul(exp_x(y), tw.f12_frob(y, g1, 1))
    y = tw.f12_mul(tw.f12_mul(exp_x(exp_x(y)), tw.f12_frob(y, g2, 2)), tw.f12_conj(y))
    f3 = tw.f12_mul(tw.f12_sqr(f1), f1)
    return tw.f12_mul(y, f3).to(torch.int32)


def final_exp_bn_plain(cfg: TowerCfg, f: Tensor, inv_bits, digit_bits) -> Tensor:
    """The BN final exponentiation of each lane, as ``final_exp_bn``'s
    script runs it: the easy part of ``final_exp_plain`` (f1), then
    y = prod_i frob^i(f1^(d_i)) over the digits' MSB-first bits, lowest
    digit first, each power a cyclotomic chain from f1 (the leading one)
    over the bits after it."""
    fexp_prog.check_bn_digits(digit_bits)
    tw = cfg.tower
    f = f.to(torch.int64)
    t = tw.f12_mul(tw.f12_conj(f), tw.f12_inv(f, inv_bits))
    f1 = tw.f12_mul(tw.f12_frob(t, cfg.gamma_limbs(2, f.device), 2), t)
    y = _f12_pow64(tw, f1, digit_bits[0][1:], True, acc=f1)
    for i, bits in enumerate(digit_bits[1:], 1):
        part = _f12_pow64(tw, f1, bits[1:], True, acc=f1)
        y = tw.f12_mul(y, tw.f12_frob(part, cfg.gamma_limbs(i, f.device), i))
    return y.to(torch.int32)


def f12_is_one_plain(cfg, f: Tensor) -> Tensor:
    """A 0-d bool tensor: the one-lane f12 f (2, 3, 2, L, 1) is one, every
    coefficient canonical ([0, p)) against the one's (``_is_one_flag``)."""
    return (cfg.fp.canon(f) == cfg.tower.f12_one_like(1, f.device)).all()


def _check_bls12(cfg: MillerCfg) -> None:
    if cfg.tail is not None or cfg.tc.x is None or cfg.tc.gammas is None:
        raise ValueError("the one-launch check takes BLS12 curves (the factor-3 final exp)")


def pairing_check_plain(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor,
                        nvalid: int):
    """(ok, prod): ok a 0-d bool tensor, prod_{i < nvalid} e(P_i, Q_i) == 1;
    prod the unreduced product (2, 3, 2, L, 1), int32: ``miller_lanes_plain``,
    the lanes padded with ones to the next power of two, the product tree of
    ``f12_seg_product_plain``, ``final_exp_plain`` and the unity test."""
    _check_bls12(cfg)
    B = xP.shape[-1]
    width = tree_width(B)
    f = miller_lanes_plain(cfg, xP, yP, Qx, Qy, nvalid)
    if width != B:
        f = torch.cat([f, cfg.tower.f12_one_like(width - B, f.device).to(torch.int32)], dim=-1)
    prod = f12_seg_product_plain(cfg, f, width)
    tc = cfg.tc
    red = final_exp_plain(tc, prod, tc.inv_bits, tc.x_bits, tc.x < 0)
    return f12_is_one_plain(cfg, red), prod


# ------------------------------------------------------------------ launches --
def _tower_args(cfg):
    """(int32[5], uint32[4*2*NW]) ctypes arrays: tower flags and tail words
    (no conjugation and no tail for a ``TowerCfg``)."""
    key = "tower_args"
    if key not in cfg._dev:
        tw, nw = cfg.tower, cfg.fp.L // 2
        conj_end, tail = (cfg.conj_end, cfg.tail) if isinstance(cfg, MillerCfg) else (False, None)
        ints = [tw.n, tw.xi0, int(tw.twist == "M"), int(conj_end), int(tail is not None)]
        words = [0] * (8 * nw)
        if tail is not None:
            p, R = cfg.fp.p, cfg.fp.R
            for a, pair in enumerate(tail):
                for c, v in enumerate(pair):
                    m = v % p * R % p
                    for j in range(nw):
                        words[(a * 2 + c) * nw + j] = (m >> (32 * j)) & 0xFFFFFFFF
        cfg._dev[key] = ((ctypes.c_int32 * 5)(*ints), (ctypes.c_uint32 * len(words))(*words))
    return cfg._dev[key]


def _bits_on(cfg, device, bits=None) -> Tensor:
    """A bit array (the loop bits by default) as a uint8 tensor on the card,
    copied there once per device and bit pattern."""
    bits = np.ascontiguousarray(cfg.bits if bits is None else bits, dtype=np.uint8)
    key = ("bits", str(device), bits.tobytes())
    if key not in cfg._dev:
        cfg._dev[key] = torch.from_numpy(bits).to(device)
    return cfg._dev[key]


def _gammas_on(cfg: TowerCfg, device) -> Tensor:
    """gamma_1, gamma_2 and gamma_3 as Montgomery words [n-1][h][j][c][NW] on
    the card: the limbs of ``cfg.gammas``, two to a 32-bit word."""
    key = ("gammas", str(device))
    if key not in cfg._dev:
        limbs = cfg.gammas[..., 0].cpu().numpy().astype(np.uint32)
        words = limbs[..., 0::2] | limbs[..., 1::2] << 16
        cfg._dev[key] = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)
    return cfg._dev[key]


def _check(cfg, *tensors: Tensor, shapes) -> None:
    """Refuse what the kernels do not take."""
    L = cfg.fp.L
    if L not in build.KERNEL_LS:
        raise ValueError(
            f"the CUDA pairing kernels take L = 16, 18 or 24 limbs (8, 9 or 12 32-bit words), "
            f"got L={L}"
        )
    dev = tensors[0].device
    for t, want in zip(tensors, shapes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"pairing kernels run on CPU (plain) or CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {t.dtype}")
        if tuple(t.shape) != want or t.shape[-2] != L:
            raise ValueError(f"expected shape {want} with L = {L}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("limb tensors must be contiguous")
    if tensors[0].shape[-1] >= 1 << 31:
        raise ValueError("the kernels index lanes with a 32-bit int")


def _launch(name: str, like: Tensor, cfg, *args, extra=(), tower: bool = True) -> None:
    """Launch ``name`` on ``like``'s card with the curve's constants (and,
    when ``tower``, its tower flags and tail words) after ``args``, then
    ``extra``, then the stream."""
    L = cfg.fp.L
    towers = [ctypes.addressof(a) for a in _tower_args(cfg)] if tower else []
    with torch.cuda.device(like.device):
        build.launch(name, *args, L, ctypes.addressof(build.consts(cfg.fp.p, L)), *towers,
                     *extra, build.stream(like))


# lanes a block of the split kernels (Miller and final exp: G) and its workers (K)
MILLER_WORKERS = {32: 32, 16: 48, 8: 64}
MILLER_BLOCKS = 128  # blocks a call should put on the card
MILLER_SMEM = 227 * 1024  # shared memory a block may take on an H100


def slot_words(L: int, G: int) -> int:
    """32-bit words of one shared-memory slot of a G-lane Miller block: NW
    words a lane (word j of lane t at j G + t), and in a block of G < 32
    lanes the words a lane rounded up to an odd count, so that the 32 / G
    workers of a warp, reading one word of different slots, fall on
    different banks: a slot then starts an odd multiple of G words after
    the one before, which is 0, G, 2G, ... mod 32 over 32 / G slots in a
    row (NW = 8 and 12 take one word more, 9 none)."""
    nw = L // 2
    return nw * G if G == 32 else (nw | 1) * G


def miller_programs(cfg: MillerCfg, G: int):
    """(programs, slots, slot words) of ``cfg``'s Miller loop for a block of
    G lanes and ``MILLER_WORKERS[G]`` workers."""
    tw = cfg.tower
    progs = miller_prog.programs(tw.n, tw.xi0, tw.twist == "M", bool(cfg.conj_end),
                                 cfg.tail is not None, MILLER_WORKERS[G], 32 // G)
    return progs, max(p.nslots for p in progs if p is not None), slot_words(cfg.fp.L, G)


def _block_shape(lanes: int, programs_of) -> Tuple[int, int]:
    """(G, K) of a split launch over ``lanes`` lanes: the largest group of
    32, 16 or 8 lanes that still gives ``MILLER_BLOCKS`` blocks and whose
    programs' slots (``programs_of(G)``: programs, slots, slot words) fit
    ``MILLER_SMEM``."""
    for G in (32, 16, 8):
        if G == 8 or -(-lanes // G) >= MILLER_BLOCKS:
            _, slots, words = programs_of(G)
            if slots * words * 4 <= MILLER_SMEM:
                return G, MILLER_WORKERS[G]
    raise ValueError(f"the programs need {slots} slots of {4 * words} bytes, more "
                     f"shared memory than a block has")


def miller_shape(cfg: MillerCfg, lanes: int) -> Tuple[int, int]:
    """(G, K) of a Miller launch over ``lanes`` lanes (BLS12-377's programs
    do not fit a 32-lane block)."""
    return _block_shape(lanes, lambda G: miller_programs(cfg, G))


def add_programs(cfg: MillerCfg, G: int):
    """(programs, slots, slot words) of ``cfg``'s addition step (the add
    step and the sparse product, one program) for a block of G lanes and
    ``MILLER_WORKERS[G]`` workers."""
    tw = cfg.tower
    prog = miller_prog.add_program(tw.n, tw.xi0, tw.twist == "M", MILLER_WORKERS[G], 32 // G)
    return (prog,), prog.nslots, slot_words(cfg.fp.L, G)


def add_shape(cfg: MillerCfg, lanes: int) -> Tuple[int, int]:
    """(G, K) of an ``add_step`` launch over ``lanes`` lanes."""
    return _block_shape(lanes, lambda G: add_programs(cfg, G))


def _add_program(cfg: MillerCfg, device, lanes: int):
    """The addition step's program for the block ``add_shape`` picks, packed
    onto the card once per device and block, and its host meta."""
    G, K = add_shape(cfg, lanes)
    key = ("add_prog", str(device), G)
    if key not in cfg._dev:
        progs, slots, words = add_programs(cfg, G)
        code, ranges = miller_prog.pack(progs, K)
        meta = (ctypes.c_int32 * 6)(G, K, slots, words, *ranges)
        cfg._dev[key] = (torch.from_numpy(code).to(device), meta)
    return cfg._dev[key]


def _miller_program(cfg: MillerCfg, device, lanes: int):
    """The programs of ``cfg``'s Miller loop for the block ``miller_shape``
    picks for ``lanes`` lanes, packed onto the card once per device and
    block, and their host meta."""
    G, K = miller_shape(cfg, lanes)
    key = ("miller_prog", str(device), G)
    if key not in cfg._dev:
        progs, slots, words = miller_programs(cfg, G)
        code, ranges = miller_prog.pack(progs, K)
        meta = (ctypes.c_int32 * 10)(G, K, slots, words, *ranges)
        cfg._dev[key] = (torch.from_numpy(code).to(device), meta)
    return cfg._dev[key]


FEXP_KINDS = {"f12_pow": (fexp_prog.pow_programs, fexp_prog.POW_PROGRAMS),
              "final_exp": (fexp_prog.fexp_programs, fexp_prog.FEXP_PROGRAMS),
              "final_exp_bn": (fexp_prog.fexp_bn_programs, fexp_prog.BN_PROGRAMS)}


def fexp_programs(cfg: TowerCfg, kind: str, G: int):
    """(programs, slots, slot words) of ``cfg``'s ``kind`` ("f12_pow",
    "final_exp" or "final_exp_bn") for a block of G lanes and
    ``MILLER_WORKERS[G]`` workers."""
    tw = cfg.tower
    progs = FEXP_KINDS[kind][0](tw.n, tw.xi0, MILLER_WORKERS[G], 32 // G)
    return progs, max(p.nslots for p in progs), slot_words(cfg.fp.L, G)


def fexp_shape(cfg: TowerCfg, kind: str, lanes: int) -> Tuple[int, int]:
    """(G, K) of an ``f12_pow`` or ``final_exp`` launch (``kind`` as
    ``fexp_programs``) over ``lanes`` lanes (BLS12-377's final exp does not
    fit a 32-lane block)."""
    return _block_shape(lanes, lambda G: fexp_programs(cfg, kind, G))


def _fexp_launch_args(cfg: TowerCfg, kind: str, device, lanes: int, steps_key, steps):
    """(program, script, meta) of a ``kind`` launch over ``lanes`` lanes: the
    programs of the block ``fexp_shape`` picks, packed onto the card once per
    device and block, and the script of ``steps`` (``steps_key``: the
    exponent it encodes), once per device, block and exponent."""
    G, K = fexp_shape(cfg, kind, lanes)
    key = (kind, str(device), G)
    if key not in cfg._dev:
        progs, slots, words = fexp_programs(cfg, kind, G)
        code, ranges = miller_prog.pack(progs, K)
        cfg._dev[key] = (torch.from_numpy(code).to(device), ranges,
                         (ctypes.c_int32 * 4)(G, K, slots, words))
    code, ranges, meta = cfg._dev[key]
    skey = key + (steps_key,)
    if skey not in cfg._dev:
        script = fexp_prog.encode_steps(steps(), FEXP_KINDS[kind][1], ranges)
        cfg._dev[skey] = torch.from_numpy(script).to(device)
    return code, cfg._dev[skey], meta


TREE_GROUP = 8  # lanes a block of the product tree (tree_shape; csrc's kTreeGroup)


def tree_programs(cfg: MillerCfg, G: int):
    """(programs, slots, slot words) of the product tree of ``cfg``'s curve
    for a block of G lanes and ``MILLER_WORKERS[G]`` workers."""
    tw = cfg.tower
    progs = tree_prog.tree_programs(tw.n, tw.xi0, MILLER_WORKERS[G], 32 // G)
    return progs, max(p.nslots for p in progs), slot_words(cfg.fp.L, G)


def tree_shape(cfg: MillerCfg) -> Tuple[int, int]:
    """(G, K) of the tree's launches: 8-lane blocks of 64 workers, whatever
    the lane count.  A level is one f12 product a lane, and the levels are
    serial, so the tree's time is its depth times a level's latency: with
    K = 64 a block runs the product's 54 field products in one layer, a
    worker each, the shortest level its programs have (8 phases at
    BLS12-381, against 11 for 16- and 32-lane blocks, which took 0.2077 and
    0.3014 ms at 4,096 lanes against 0.1588: PERF.md section 6)."""
    G = TREE_GROUP
    _, slots, words = tree_programs(cfg, G)
    if slots * words * 4 > MILLER_SMEM:
        raise ValueError(f"the tree's program needs {slots} slots of {4 * words} bytes, more "
                         f"shared memory than a block has")
    return G, MILLER_WORKERS[G]


def tree_plan(cfg: MillerCfg, seg: int) -> Tuple[int, int, list]:
    """(G, K, levels of each launch) of a product over segments of ``seg``
    lanes: log2(seg) levels, at most log2(2G) of them a launch."""
    G, K = tree_shape(cfg)
    depth, most = seg.bit_length() - 1, tree_prog.max_levels(G)
    return G, K, [min(most, depth - d) for d in range(0, depth, most)]


def _tree_launch_args(cfg: MillerCfg, device, G: int, K: int, levels: int):
    """(program, script, meta) of a tree launch of ``levels`` levels: the
    program packed onto the card once per device and block, the script once
    per device, block and level count."""
    key = ("tree", str(device), G)
    if key not in cfg._dev:
        progs, slots, words = tree_programs(cfg, G)
        code, ranges = miller_prog.pack(progs, K)
        cfg._dev[key] = (torch.from_numpy(code).to(device), ranges,
                         (ctypes.c_int32 * 4)(G, K, slots, words))
    code, ranges, meta = cfg._dev[key]
    skey = key + (levels,)
    if skey not in cfg._dev:
        script = fexp_prog.encode_steps(tree_prog.tree_steps(levels), tree_prog.TREE_PROGRAMS,
                                        ranges)
        cfg._dev[skey] = torch.from_numpy(script).to(device)
    return code, cfg._dev[skey], meta


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
        prog, meta = _miller_program(cfg, xP.device, B)
        _launch("mlt_pairing_miller_lanes", xP, cfg, xP.data_ptr(), yP.data_ptr(), Qx.data_ptr(),
                Qy.data_ptr(), bits.data_ptr(), len(cfg.bits), max(0, min(n, B)),
                out.data_ptr(), B, extra=(prog.data_ptr(), ctypes.addressof(meta)))
        miller_lanes.launches += 1
    return out


def f12_seg_product(cfg: MillerCfg, f: Tensor, seg: int) -> Tensor:
    """(2, 3, 2, L, B) -> (2, 3, 2, L, B/seg): one product per aligned
    segment of ``seg`` lanes (a power of two); ``seg == B`` multiplies all
    lanes.  On the card: log2(seg) levels of the plain version's tree, up to
    4 of them a launch (``tree_plan``)."""
    if f.device.type == "cpu":
        return f12_seg_product_plain(cfg, f, seg)
    L, B = f.shape[-2:]
    _check(cfg, f, shapes=[(2, 3, 2, L, B)])
    _check_seg(f, seg)
    G, K, plan = tree_plan(cfg, seg)
    for levels in plan:
        prog, script, meta = _tree_launch_args(cfg, f.device, G, K, levels)
        out = torch.empty((2, 3, 2, L, f.shape[-1] >> levels), dtype=torch.int32,
                          device=f.device)
        _launch("mlt_f12_tree", f, cfg, f.data_ptr(), out.data_ptr(), f.shape[-1], levels,
                script.data_ptr(), len(script), extra=(prog.data_ptr(), ctypes.addressof(meta)),
                tower=False)
        f12_seg_product.launches += 1
        f = out
    return f


def miller_ft(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor):
    """(f (2, 3, 2, L, B), T (3, 2, L, B)) after the Miller loop of each lane
    of affine G1 (xP, yP: (L, B)) and G2 (Qx, Qy: (2, L, B)) points in
    Montgomery form; no conjugation and no BN tail (the caller's)."""
    if xP.device.type == "cpu":
        return miller_ft_plain(cfg, xP, yP, Qx, Qy)
    L, B = cfg.fp.L, xP.shape[-1]
    _check(cfg, xP, yP, Qx, Qy, shapes=[(L, B), (L, B), (2, L, B), (2, L, B)])
    f = torch.empty((2, 3, 2, L, B), dtype=torch.int32, device=xP.device)
    T = torch.empty((3, 2, L, B), dtype=torch.int32, device=xP.device)
    if B:
        bits = _bits_on(cfg, xP.device)
        prog, meta = _miller_program(cfg, xP.device, B)
        _launch("mlt_pairing_miller_ft", xP, cfg, xP.data_ptr(), yP.data_ptr(), Qx.data_ptr(),
                Qy.data_ptr(), bits.data_ptr(), len(cfg.bits), f.data_ptr(), T.data_ptr(), B,
                extra=(prog.data_ptr(), ctypes.addressof(meta)))
        miller_ft.launches += 1
    return f, T


def add_step(cfg: MillerCfg, f: Tensor, T: Tensor, Qx: Tensor, Qy: Tensor, xP: Tensor,
             yP: Tensor):
    """(f * l_{T,Q}(P), T + Q) per lane: one Miller addition step through the
    affine G2 points (Qx, Qy), the line evaluated at (xP, yP).  On the card
    one lane's step runs over the workers of a block (``add_shape``)."""
    if f.device.type == "cpu":
        return add_step_plain(cfg, f, T, Qx, Qy, xP, yP)
    L, B = cfg.fp.L, f.shape[-1]
    _check(cfg, f, T, Qx, Qy, xP, yP, shapes=[(2, 3, 2, L, B), (3, 2, L, B), (2, L, B),
                                             (2, L, B), (L, B), (L, B)])
    f_out, T_out = torch.empty_like(f), torch.empty_like(T)
    if B:
        prog, meta = _add_program(cfg, f.device, B)
        _launch("mlt_pairing_add_step", f, cfg, f.data_ptr(), T.data_ptr(), Qx.data_ptr(),
                Qy.data_ptr(), xP.data_ptr(), yP.data_ptr(), f_out.data_ptr(), T_out.data_ptr(),
                B, extra=(prog.data_ptr(), ctypes.addressof(meta)), tower=False)
        add_step.launches += 1
    return f_out, T_out


def f12_pow(cfg: TowerCfg, f: Tensor, bits, cyclo: bool = False) -> Tensor:
    """f^e for each lane of f (2, 3, 2, L, B), e's MSB-first bits (one build
    serves every exponent); Granger-Scott squaring when ``cyclo`` (unitary
    f only)."""
    if f.device.type == "cpu":
        return f12_pow_plain(cfg, f, bits, cyclo)
    L, B = cfg.fp.L, f.shape[-1]
    _check(cfg, f, shapes=[(2, 3, 2, L, B)])
    out = torch.empty_like(f)
    if B:
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        prog, script, meta = _fexp_launch_args(
            cfg, "f12_pow", f.device, B, (bits.tobytes(), bool(cyclo)),
            lambda: fexp_prog.pow_steps(bits, cyclo))
        _launch("mlt_f12_pow", f, cfg, f.data_ptr(), script.data_ptr(), len(script),
                out.data_ptr(), B, extra=(prog.data_ptr(), ctypes.addressof(meta)), tower=False)
        f12_pow.launches += 1
    return out


def final_exp(cfg: TowerCfg, f: Tensor, inv_bits=None, x_bits=None, x_neg=None,
              digit_bits=None) -> Tensor:
    """The final exponentiation of each lane of f (2, 3, 2, L, B), one launch.
    The inverse chain runs over ``inv_bits`` (default: p - 2).  BLS12
    (factor-3 chain): the x-chains over ``x_bits`` (default: |x|),
    conjugated when ``x_neg`` (default: x < 0).  BN (a config with digits
    and no ``x_bits`` given, or ``digit_bits`` given): one cyclotomic chain a
    hard-part digit over its MSB-first bits (default: ``cfg.digit_bits``),
    at most ``fexp_prog.BN_DIGITS`` digits.  The bits are inputs of the
    kernel."""
    inv_bits = cfg.inv_bits if inv_bits is None else inv_bits
    bn = digit_bits is not None or (x_bits is None and cfg.digits is not None)
    if bn:
        digit_bits = [np.ascontiguousarray(b, dtype=np.uint8)
                      for b in (cfg.digit_bits if digit_bits is None else digit_bits)]
        kind, key = "final_exp_bn", tuple(b.tobytes() for b in digit_bits)
        steps = lambda: fexp_prog.fexp_bn_steps(digit_bits)  # noqa: E731
    else:
        x_bits = np.ascontiguousarray(cfg.x_bits if x_bits is None else x_bits, dtype=np.uint8)
        x_neg = bool(cfg.x < 0 if x_neg is None else x_neg)
        kind, key = "final_exp", (x_bits.tobytes(), x_neg)
        steps = lambda: fexp_prog.fexp_steps(x_bits, x_neg)  # noqa: E731
    if f.device.type == "cpu":
        if bn:
            return final_exp_bn_plain(cfg, f, inv_bits, digit_bits)
        return final_exp_plain(cfg, f, inv_bits, x_bits, x_neg)
    L, B = cfg.fp.L, f.shape[-1]
    _check(cfg, f, shapes=[(2, 3, 2, L, B)])
    out = torch.empty_like(f)
    if B:
        prog, script, meta = _fexp_launch_args(cfg, kind, f.device, B, key, steps)
        ib = _bits_on(cfg, f.device, inv_bits)
        _launch("mlt_final_exp", f, cfg, f.data_ptr(), script.data_ptr(), len(script),
                ib.data_ptr(), len(ib), _gammas_on(cfg, f.device).data_ptr(), out.data_ptr(), B,
                extra=(prog.data_ptr(), ctypes.addressof(meta)), tower=False)
        final_exp.launches += 1
    return out


def check_programs(cfg: MillerCfg, G: int):
    """The one-launch check's programs for a block of G lanes: part 1's
    (the Miller loop's and the tree's product, ``check_prog.PART1_PROGRAMS``'
    order, for ``MILLER_WORKERS[G]`` workers), their slots and slot words,
    and part 2's (the final exp's for ``fexp_shape``'s one-lane block of 8
    lanes and 64 workers), their slots and slot words."""
    progs, slots, words = miller_programs(cfg, G)
    (mul,), tree_slots, _ = tree_programs(cfg, G)
    fprogs, fslots, fwords = fexp_programs(cfg.tc, "final_exp", check_prog.FEXP_GROUP)
    return progs + (mul,), max(slots, tree_slots), words, fprogs, fslots, fwords


def check_shape(cfg: MillerCfg, lanes: int) -> Tuple[int, int]:
    """(G, K) of a ``pairing_check`` launch over ``lanes`` lanes: the largest
    group of 32, 16 or 8 lanes that still gives ``MILLER_BLOCKS`` blocks over
    the tree's width and whose slots, part 1's or part 2's, fit
    ``MILLER_SMEM`` (BLS12-377's Miller programs do not fit a 32-lane
    block)."""
    W = tree_width(lanes)
    for G in (32, 16, 8):
        if G == 8 or W // G >= MILLER_BLOCKS:
            _, slots, words, _, fslots, fwords = check_programs(cfg, G)
            if 4 * max(slots * words, fslots * fwords) <= MILLER_SMEM:
                return G, MILLER_WORKERS[G]
    raise ValueError("the check's programs need more shared memory than a block has")


def _check_launch_args(cfg: MillerCfg, device, lanes: int):
    """(code, meta, blocks) of a ``pairing_check`` launch over ``lanes``
    lanes, once per device, block and tree width: one int32 array on the
    card with part 1's programs, part 2's, then the two scripts
    (``check_prog.check_steps`` and ``fexp_prog.fexp_steps``), and the host
    meta of csrc/check_kernels.cu (the blocks, the slots, the offsets)."""
    G, K = check_shape(cfg, lanes)
    W = tree_width(lanes)
    key = ("check", str(device), G, W)
    if key not in cfg._dev:
        progs, slots, words, fprogs, fslots, fwords = check_programs(cfg, G)
        code1, ranges1 = miller_prog.pack(progs, K)
        code2, ranges2 = miller_prog.pack(fprogs, check_prog.FEXP_WORKERS)
        pl = check_prog.plan(lanes, lanes, G)
        tc = cfg.tc
        script1 = fexp_prog.encode_steps(
            check_prog.check_steps(pl, cfg.bits, progs[2] is not None),
            check_prog.PART1_PROGRAMS, ranges1)
        script2 = fexp_prog.encode_steps(fexp_prog.fexp_steps(tc.x_bits, tc.x < 0),
                                         fexp_prog.FEXP_PROGRAMS, ranges2)
        at1 = len(code1) + len(code2)
        at2 = at1 + script1.size
        code = np.concatenate([code1, code2, script1.ravel(), script2.ravel()])
        meta = (ctypes.c_int32 * 12)(G, K, slots, words, check_prog.FEXP_WORKERS, fslots, fwords,
                                     len(code1), at1, len(script1), at2, len(script2))
        cfg._dev[key] = (torch.from_numpy(code).to(device), meta, pl.blocks)
    return cfg._dev[key]


def _check_state(cfg: MillerCfg, device, words: int, stream: int):
    """The scratch (``words`` words at least: a partial product a block)
    and the ticket of ``pairing_check`` for one device and stream, kept on
    the curve's config: made once (the ticket zeroed then), the scratch
    grown when a call needs more.  Calls on one stream are serialised by it,
    so they never race on the ticket."""
    key = ("check_state", str(device), stream)
    scratch, ticket = cfg._dev.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if scratch is None or scratch.numel() < words:
        scratch = torch.empty(words, dtype=torch.int32, device=device)
    cfg._dev[key] = (scratch, ticket)
    return scratch, ticket


def pairing_check(cfg: MillerCfg, xP: Tensor, yP: Tensor, Qx: Tensor, Qy: Tensor,
                  nvalid: int):
    """(ok, prod): prod_{i < nvalid} e(P_i, Q_i) == 1 over affine G1 (xP, yP:
    (L, B)) and G2 (Qx, Qy: (2, L, B)) points in Montgomery form, as a 0-d
    bool tensor, and the unreduced product (2, 3, 2, L, 1) of the masked
    Miller values, by the tree of ``f12_seg_product`` over the lanes padded
    with ones to the next power of two.  BLS12 curves with the factor-3
    final exp (``cfg.tc`` carries gammas and x).  On the card: one launch
    (``check_shape``'s blocks, ``check_prog``'s scripts)."""
    if xP.device.type == "cpu":
        return pairing_check_plain(cfg, xP, yP, Qx, Qy, nvalid)
    L, B = cfg.fp.L, xP.shape[-1]
    _check(cfg, xP, yP, Qx, Qy, shapes=[(L, B), (L, B), (2, L, B), (2, L, B)])
    _check_bls12(cfg)
    tc = cfg.tc
    code, meta, blocks = _check_launch_args(cfg, xP.device, B)
    scratch, ticket = _check_state(cfg, xP.device, blocks * 12 * (L // 2), build.stream(xP))
    ok = torch.empty(1, dtype=torch.int32, device=xP.device)
    prod = torch.empty((2, 3, 2, L, 1), dtype=torch.int32, device=xP.device)
    ib = _bits_on(cfg, xP.device, tc.inv_bits)
    _launch("mlt_pairing_check", xP, cfg, xP.data_ptr(), yP.data_ptr(), Qx.data_ptr(),
            Qy.data_ptr(), max(0, min(nvalid, B)), ib.data_ptr(), len(ib),
            _gammas_on(tc, xP.device).data_ptr(), ok.data_ptr(), prod.data_ptr(),
            scratch.data_ptr(), ticket.data_ptr(), B, blocks,
            extra=(code.data_ptr(), ctypes.addressof(meta)))
    pairing_check.launches += 1
    return ok[0] != 0, prod


KERNELS = (miller_lanes, f12_seg_product, miller_ft, add_step, f12_pow, final_exp, pairing_check)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
