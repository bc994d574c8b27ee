"""Batched prime-field arithmetic on limb tensors (port of ``mathlib_tpu/ops/field.py``).

Layout and value domain are the reference's: a batch of field elements is a
``(..., L, B)`` tensor of 16-bit limbs (little-endian) with the element batch
``B`` last, in Montgomery form with ``R = 2**(16*L)``, lazily reduced to
``[0, 2p)``.  Edge tensors are ``torch.int32``; the arithmetic runs in
``int64``, where every intermediate of a 16x16-bit schoolbook product fits.

L is the reference's, the least count with ``4p <= R``, with one exception:
a curve's base field on a CUDA device takes the next even count
(``base_limbs``), since the kernels hold an element as L / 2 whole 32-bit
words and run one Montgomery round a word (``R = 2**(32 * NW)``).  Only
FP256BN changes: its p has its top bit set, so its least L is 17
(``R = 2**272``), and on the card it holds L = 18 (nine words,
``R = 2**288``).  Its device tensors then differ from the reference's limb
for limb and agree with them canonically (decoded values);
``widen_limbs`` and ``narrow_limbs`` move a tensor between the two.  Scalar-field contexts
keep the least L everywhere (no kernel takes an Fr element).

This is plain PyTorch and runs on any device.  Every result is a function of
the input integers alone (``add``/``sub`` are fixed by ``a +- b`` and one
conditional subtraction of 2p, ``mont_mul`` by ``(ab + m*p)/R`` with
``m = -ab/p mod R``), so it is bit-equal to the reference's limbs however the
carries are scheduled.  Design notes:

* **Schoolbook product** as one outer product plus one ``index_add_`` along
  the limb axis (``_conv``).
* **Non-interleaved Montgomery (REDC)**: ``m = (T mod R) * N' mod R``, then
  ``(T + m*p) / R``, with no final conditional subtraction.
* **Carry normalisation** in a fixed number of tensor ops: two shift-carry
  passes leave 0/1 carries, which a ``cummax`` over the limb axis resolves
  (the carry into limb k is the carry out of the last limb below k that does
  not merely propagate).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from ..convert import to_numpy

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

Tensor = torch.Tensor


def int_to_limbs(x: int, L: int) -> np.ndarray:
    if not 0 <= x < (1 << (LIMB_BITS * L)):
        raise ValueError("value does not fit in L limbs")
    return np.array(
        [(x >> (LIMB_BITS * k)) & LIMB_MASK for k in range(L)], dtype=np.uint32
    )


def ints_to_limbs(vals: Sequence[int], L: int) -> np.ndarray:
    """Non-negative ints below 2^(16L) -> (len, L) uint32 limbs, in one pass."""
    buf = b"".join(int(v).to_bytes(2 * L, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), L).astype(np.uint32)


def limb_tensor(limbs: np.ndarray, shape: tuple, device) -> Tensor:
    """(prod(shape), L) limbs -> shape[:-1] + (L, shape[-1]) int32 tensor:
    the trailing input axis becomes the lane axis."""
    arr = np.moveaxis(limbs.reshape(shape + limbs.shape[-1:]), -1, -2)
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def limbs_to_ints(arr: np.ndarray) -> list:
    """(n, L) limbs -> list of n ints."""
    rows = np.ascontiguousarray(np.asarray(arr).astype("<u2"))
    width = 2 * rows.shape[-1]
    buf = rows.tobytes()
    return [
        int.from_bytes(buf[i : i + width], "little") for i in range(0, len(buf), width)
    ]


def bits_of(e: int, n: int = None) -> np.ndarray:
    """Little-endian bit array of e >= 0 (length n, or minimal)."""
    n = max(1, e.bit_length()) if n is None else n
    if e < 0 or e >= 1 << n:
        raise ValueError(f"{e} does not fit in {n} bits")
    return np.array([(e >> i) & 1 for i in range(n)], dtype=np.uint32)


# The plain arithmetic runs many small tensor ops (a few lanes in the tests):
# the pads call the aten op directly, without functional.pad's Python checks.
def _shift_in(c: Tensor, fill: int = 0) -> Tensor:
    """out[..., k, :] = c[..., k-1, :]; out[..., 0, :] = fill (limb axis -2)."""
    return torch.constant_pad_nd(c[..., :-1, :], (0, 0, 1, 0), fill)


def _pad_top(t: Tensor, n: int = 1) -> Tensor:
    """Append n zero limbs above the top limb."""
    return torch.constant_pad_nd(t, (0, 0, 0, n))


@lru_cache(maxsize=None)
def _limb_index1(K: int, device: torch.device) -> Tensor:
    """(K, 1) int64: 1, 2, ..., K."""
    return torch.arange(1, K + 1, device=device).view(K, 1)


def _normalize(t: Tensor, passes: int = 2) -> Tensor:
    """Redundant non-negative int64 limbs (each < 2^47; < 2^31 with
    ``passes=1``, the sums of add and sub) -> canonical 16-bit digits of the
    same value mod 2^(16K), K = t.shape[-2]."""
    v = t
    for _ in range(passes):
        v = (v & LIMB_MASK) + _shift_in(v >> LIMB_BITS)  # in the end < 2^16 + 2^15
    g = v >> LIMB_BITS  # 0/1: carry out of the limb whatever comes in
    keep = (v & LIMB_MASK) != LIMB_MASK  # does not pass an incoming carry on
    # 1 + the last non-propagating limb at or below k (0: none)
    last1 = torch.cummax(torch.where(keep, _limb_index1(v.shape[-2], v.device), 0), dim=-2).values
    # limb k takes the carry out of the last non-propagating limb below it;
    # row 0 of the padded g is the zero carry of "none"
    cin = torch.gather(torch.constant_pad_nd(g, (0, 0, 1, 0)), -2, _shift_in(last1))
    return (v + cin) & LIMB_MASK


def _conv(a: Tensor, b: Tensor) -> Tensor:
    """Limb convolution (big-int product) of canonical int64 limb tensors:
    (..., A, B) x (..., A2, B) -> (..., A+A2-1, B), each < min(A, A2) * 2^32."""
    A, A2 = a.shape[-2], b.shape[-2]
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., A, A2, B)
    lead, lanes = prod.shape[:-3], prod.shape[-1]
    prod = prod.reshape(lead + (A * A2, lanes))
    out = torch.zeros(lead + (A + A2 - 1, lanes), dtype=torch.int64, device=a.device)
    return out.index_add_(-2, _conv_index(A, A2, a.device), prod)


@lru_cache(maxsize=None)
def _conv_index(A: int, A2: int, device: torch.device) -> Tensor:
    """(A * A2,) int64: the output limb i + j of each partial product."""
    return (torch.arange(A, device=device)[:, None]
            + torch.arange(A2, device=device)[None, :]).reshape(-1)


def _i64(x: Tensor) -> Tensor:
    return x.to(torch.int64)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def least_limbs(p: int) -> int:
    """The least L with 4p <= R = 2^(16L): headroom for the lazy [0, 2p)
    value domain (the reference's L)."""
    return -(-(p.bit_length() + 2) // LIMB_BITS)


def base_limbs(p: int, device: torch.device, L: Optional[int] = None) -> int:
    """The limbs of a curve's base-field context on ``device`` (a resolved
    ``torch.device``): ``L`` where the caller asks for it (a CPU test
    running the card's arithmetic asks for 18 on FP256BN), else
    ``least_limbs(p)``, rounded up to an even count on a CUDA device, where
    the kernels take whole 32-bit words."""
    if L is not None:
        return L
    L = least_limbs(p)
    return L + L % 2 if device.type == "cuda" else L


class FpCtx:
    """All batched mod-p arithmetic for one prime ``p``, with its constants as
    ``(L, 1)`` int64 tensors on ``device``; L is ``least_limbs(p)`` unless
    given (at least that)."""

    def __init__(self, p: int, device=None, name: str = "fp", L: Optional[int] = None):
        self.p = p
        self.name = name
        self.device = _device(device)
        self.nbits = p.bit_length()
        self.L = least_limbs(p) if L is None else L
        L = self.L
        self.R = 1 << (LIMB_BITS * L)
        if p % 2 == 0 or 4 * p > self.R:
            raise ValueError("p must be odd with 4p <= R")

        def col(x: int) -> Tensor:
            return torch.from_numpy(int_to_limbs(x, L).astype(np.int64)[:, None]).to(
                self.device
            )

        self.p_limbs = col(p)
        # N' = -p^{-1} mod R (full-width Montgomery constant)
        self.nprime_limbs = col((-pow(p, -1, self.R)) % self.R)
        self.r_minus_p = col(self.R - p)
        self.r_minus_2p = col(self.R - 2 * p)
        self._r_minus_2p_top = _pad_top(self.r_minus_2p)
        # borrow-absorbing limbs of 2p + R: every limb >= 2^16 - 1, so
        # a + X - b never goes negative limbwise (see ``sub``)
        self.sub_offset = col(2 * p) + LIMB_MASK
        self.sub_offset[0] += 1
        self.r_mod_p = self.R % p
        self.r2 = (self.R * self.R) % p
        self.r2_limbs = col(self.r2)
        self.one_mont = col(self.r_mod_p)  # 1 in Montgomery form
        self._inv_bits = bits_of(p - 2, self.nbits)
        # sqrt exponent for p = 3 mod 4 (BLS12-381, BN254, FP256BN); BLS12-377
        # has p = 1 mod 4 and has none
        self.sqrt_bits = bits_of((p + 1) // 4, self.nbits) if p % 4 == 3 else None
        self._dev: dict = {}  # device copies of exponent bits (device_bits)

    # ------------------------------------------------------------ host <-> --
    def encode(self, x: Union[int, Sequence[int], np.ndarray]) -> Tensor:
        """Host int(s) -> Montgomery limb tensor.

        A scalar encodes to (L, 1); an array of shape S to S[:-1] + (L, S[-1])
        -- the trailing input axis becomes the lane axis."""
        xs = np.asarray([x] if isinstance(x, (int, np.integer)) else x, dtype=object)
        if xs.ndim < 1:
            raise ValueError("encode wants an int or a non-empty array")
        p, R = self.p, self.R
        vals = [(int(v) % p) * R % p for v in xs.reshape(-1)]
        return limb_tensor(ints_to_limbs(vals, self.L), xs.shape, self.device)

    def encode_plain(self, xs) -> Tensor:
        """Host ints -> PLAIN (non-Montgomery) limbs: list of N ints -> (L, N).
        Pair with ``to_mont`` for the Montgomery entry on the device."""
        vals = [int(x) % self.p for x in xs]
        return limb_tensor(ints_to_limbs(vals, self.L), (len(vals),), self.device)

    def decode(self, a) -> np.ndarray:
        """Montgomery limb tensor/array (..., L, B) -> host ints (..., B)."""
        arr = np.moveaxis(to_numpy(a), -2, -1)  # (..., B, L)
        rinv = pow(self.R, -1, self.p)
        vals = [v * rinv % self.p for v in limbs_to_ints(arr.reshape(-1, self.L))]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out.reshape(arr.shape[:-1])

    def device_bits(self, bits, device) -> Tensor:
        """MSB-first exponent or scalar bits as a uint8 tensor on ``device``,
        copied once per pattern: the kernels read them as a small device
        array, so one build serves every exponent."""
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        key = (str(device), bits.tobytes())
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(bits).to(device)
        return self._dev[key]

    # ------------------------------------------------------------- helpers --
    def _cond_sub(self, r: Tensor, r_minus: Tensor) -> Tensor:
        """r - X if r >= X, via r + (R - X) with an overflow test (int64)."""
        w = _normalize(_pad_top(r + r_minus))
        ge = w[..., self.L, :] > 0  # r + (R - X) overflowed R  <=>  r >= X
        return torch.where(ge.unsqueeze(-2), w[..., : self.L, :], r)

    def _add64(self, a: Tensor, b: Tensor) -> Tensor:
        # s = a + b < 4p <= R, and s + (R - 2p) >= R iff s >= 2p: both
        # candidates normalised in one call
        s = _pad_top(a + b)
        r, w = _normalize(torch.stack([s, s + self._r_minus_2p_top]), passes=1).unbind(0)
        L = self.L
        return torch.where((w[..., L, :] > 0).unsqueeze(-2), w[..., :L, :], r[..., :L, :])

    def _sub64(self, a: Tensor, b: Tensor) -> Tensor:
        # v = a - b + 2p + R with the offset borrow-absorbing; its low L
        # digits are r = a - b + 2p < 4p, and v + (R - 2p) = a - b + 2R
        # reaches 2R iff r >= 2p: both candidates normalised in one call
        v = _pad_top(a + self.sub_offset - b)
        r, w = _normalize(torch.stack([v, v + self._r_minus_2p_top]), passes=1).unbind(0)
        L = self.L
        return torch.where((w[..., L, :] >= 2).unsqueeze(-2), w[..., :L, :], r[..., :L, :])

    def _mont_mul64(self, a: Tensor, b: Tensor) -> Tensor:
        L = self.L
        T = _normalize(_pad_top(_conv(a, b)))  # (..., 2L), value < 4p^2 < R^2
        m = _normalize(_conv(T[..., :L, :], self.nprime_limbs)[..., :L, :])  # mod R
        S = T + _pad_top(_conv(m, self.p_limbs))  # value < 4p^2 + R*p < R^2
        return _normalize(S)[..., L : 2 * L, :]  # low L digits are zero; < 2p

    # ------------------------------------------------------------- arith ----
    def canon(self, a: Tensor) -> Tensor:
        """Relaxed [0, 2p) -> canonical [0, p)."""
        return _i32(self._cond_sub(_i64(a), self.r_minus_p))

    def add(self, a: Tensor, b: Tensor) -> Tensor:
        return _i32(self._add64(_i64(a), _i64(b)))

    def sub(self, a: Tensor, b: Tensor) -> Tensor:
        return _i32(self._sub64(_i64(a), _i64(b)))

    def neg(self, a: Tensor) -> Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul_int(self, a: Tensor, n: int) -> Tensor:
        """a * n for a small host integer n (the reference's double-and-add chain)."""
        n = n % self.p
        if n == 0:
            return torch.zeros_like(a, dtype=torch.int32)
        if n > self.p - n:  # cheaper as -(p-n)
            return self.neg(self.mul_int(a, self.p - n))
        a = _i64(a)
        acc = a
        for bit in bin(n)[3:]:
            acc = self._add64(acc, acc)
            if bit == "1":
                acc = self._add64(acc, a)
        return _i32(acc)

    def mont_mul(self, a: Tensor, b: Tensor) -> Tensor:
        """Montgomery product a*b*R^{-1} mod p, relaxed [0, 2p) in and out,
        of broadcast limb tensors: the ``mont_mul`` kernel on a card, as the
        reference's reaches its Pallas kernel on a TPU; its plain version on
        the CPU."""
        from .kernels import fp_cuda

        return fp_cuda.mont_mul(self, a, b)

    def mont_mul_plain(self, a: Tensor, b: Tensor) -> Tensor:
        """``mont_mul`` in plain PyTorch on any device: the plain versions of
        the kernels build on it."""
        return _i32(self._mont_mul64(_i64(a), _i64(b)))

    def sqr(self, a: Tensor) -> Tensor:
        return self.mont_mul(a, a)

    def to_mont(self, a_std: Tensor) -> Tensor:
        """Plain limbs (< p) -> Montgomery form; the ``mont_mul`` kernel on a
        card, as the reference reaches its Pallas kernel here."""
        from .kernels import fp_cuda

        return fp_cuda.mont_mul(self, a_std, self.r2_limbs.to(torch.int32))

    def from_mont(self, a: Tensor) -> Tensor:
        one = torch.zeros_like(a)
        one[..., 0, :] = 1
        return self.mont_mul(a, one)

    # --------------------------------------------------------- predicates ---
    def is_zero(self, a: Tensor) -> Tensor:
        """a = 0 (mod p) -> (..., B) bool; relaxed values are 0 mod p iff 0 or p."""
        return (a == 0).all(dim=-2) | (a == self.p_limbs).all(dim=-2)

    def eq(self, a: Tensor, b: Tensor) -> Tensor:
        """a = b (mod p) for relaxed values."""
        return self.is_zero(self.sub(a, b))

    def select(self, mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
        """mask ? a : b, mask shaped (..., B)."""
        return torch.where(mask.unsqueeze(-2), a, b)

    # ------------------------------------------------------ exponentiation --
    def pow_bits(self, a: Tensor, bits: np.ndarray) -> Tensor:
        """a**e, ``bits`` the little-endian bit array of e: the ``fp_pow``
        kernel on a card (one launch for the whole chain), its plain version
        on the CPU."""
        from .kernels import fp_cuda

        return fp_cuda.fp_pow(self, a, np.asarray(bits)[::-1])

    def inv(self, a: Tensor) -> Tensor:
        """a^(p-2): the inverse, 0 for 0."""
        return self.pow_bits(a, self._inv_bits)

    BATCH_INV_CUTOFF = 2048  # lanes of batch_inv's one pow chain, at most

    def batch_inv(self, a: Tensor) -> Tensor:
        """Elementwise inverse along the lane axis by Montgomery's trick: a
        product tree up to at most ``BATCH_INV_CUTOFF`` lanes, ONE pow chain
        on that level, and the tree back down (~3N products instead of N
        chains).  Zeros map to zero.  (..., L, N) in and out.  The products
        go to the ``mont_mul`` kernel on a card, as the reference's to its
        Pallas product."""
        from .kernels import fp_cuda

        N = a.shape[-1]
        if N == 1:
            return self.inv(a)
        nonzero = ~self.is_zero(a)
        one = self.one_mont.to(a.device, torch.int32)
        cur = self.select(nonzero, a, one.expand(a.shape))
        P2 = 1 << (N - 1).bit_length()
        if P2 != N:
            cur = torch.cat([cur, one.expand(a.shape[:-1] + (P2 - N,))], dim=-1)
        levels = [cur]
        while levels[-1].shape[-1] > min(self.BATCH_INV_CUTOFF, P2):
            c = levels[-1]
            levels.append(fp_cuda.mont_mul(self, c[..., 0::2], c[..., 1::2]))
        inv = self.inv(levels[-1].contiguous())
        for c in reversed(levels[:-1]):  # child inverse = parent inverse * sibling
            m = c.shape[-1]
            sibling = c.reshape(c.shape[:-1] + (m // 2, 2)).flip(-1).reshape(c.shape)
            inv = fp_cuda.mont_mul(self, inv.repeat_interleave(2, dim=-1), sibling)
        return self.select(nonzero, inv[..., :N], torch.zeros_like(a))

    def sqrt(self, a: Tensor) -> Tensor:
        """a^((p+1)/4) for p = 3 mod 4; the caller checks that it squares
        back to a."""
        if self.sqrt_bits is None:
            raise ValueError(f"{self.name}: p % 4 != 3, no sqrt by one exponentiation")
        return self.pow_bits(a, self.sqrt_bits)



# FP256BN's edge between the reference's L = 17 (R' = 2^272) and the card's
# L = 18 (R = 2^288): one Montgomery product at fp's L each way, on
# ``FpCtx.mont_mul`` (the kernel on a card, its plain version on the CPU)
def widen_limbs(fp: FpCtx, a: Tensor) -> Tensor:
    """A Montgomery tensor (..., L', B) at R' = 2^(16 L'), L' <= fp.L, ->
    (..., fp.L, B) at fp.R: x R' padded with zero limbs, times R^2 / R' mod
    p (2^304 for 17 -> 18) in one product, is x R, in [0, 2p)."""
    Lin = a.shape[-2]
    if Lin == fp.L:
        return a
    if Lin > fp.L:
        raise ValueError(f"widen_limbs: {Lin} limbs are more than the context's {fp.L}")
    c = fp.R * fp.R * pow(1 << (LIMB_BITS * Lin), -1, fp.p) % fp.p
    return fp.mont_mul(_pad_top(a, fp.L - Lin), _limb_const(fp, c))


def narrow_limbs(fp: FpCtx, a: Tensor, L: int) -> Tensor:
    """``widen_limbs`` back: (..., fp.L, B) at fp.R -> (..., L, B) at R' =
    2^(16 L), L <= fp.L with 4p <= R': x R times R' mod p in one product is
    x R', in [0, 2p), and the limbs from L up, which that leaves zero, are
    dropped."""
    if L == fp.L:
        return a
    if L > fp.L or 4 * fp.p > 1 << (LIMB_BITS * L):
        raise ValueError(f"narrow_limbs: {L} limbs do not hold [0, 2p) below fp's {fp.L}")
    return fp.mont_mul(a, _limb_const(fp, (1 << (LIMB_BITS * L)) % fp.p))[..., :L, :]


def _limb_const(fp: FpCtx, c: int) -> Tensor:
    """c < p as an (L, 1) int32 limb column on fp's device (a constant
    operand of ``mont_mul``)."""
    return torch.from_numpy(int_to_limbs(c, fp.L).astype(np.int32)[:, None]).to(fp.device)
