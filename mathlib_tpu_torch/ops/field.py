"""Batched prime-field arithmetic on limb tensors (port of ``mathlib_tpu/ops/field.py``).

Layout and value domain are the reference's: a batch of field elements is a
``(..., L, B)`` tensor of 16-bit limbs (little-endian) with the element batch
``B`` last, in Montgomery form with ``R = 2**(16*L)``, lazily reduced to
``[0, 2p)``.  Edge tensors are ``torch.int32``; the arithmetic runs in
``int64``, where every intermediate of a 16x16-bit schoolbook product fits.

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

from typing import Sequence, Union

import numpy as np
import torch

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


def _shift_in(c: Tensor, fill: int = 0) -> Tensor:
    """out[..., k, :] = c[..., k-1, :]; out[..., 0, :] = fill (limb axis -2)."""
    return torch.nn.functional.pad(c[..., :-1, :], (0, 0, 1, 0), value=fill)


def _pad_top(t: Tensor, n: int = 1) -> Tensor:
    """Append n zero limbs above the top limb."""
    return torch.nn.functional.pad(t, (0, 0, 0, n))


def _normalize(t: Tensor) -> Tensor:
    """Redundant non-negative int64 limbs (each < 2^47) -> canonical 16-bit
    digits of the same value mod 2^(16K), K = t.shape[-2]."""
    v = (t & LIMB_MASK) + _shift_in(t >> LIMB_BITS)
    v = (v & LIMB_MASK) + _shift_in(v >> LIMB_BITS)  # now < 2^16 + 2^15
    g = v >> LIMB_BITS  # 0/1: carry out of the limb whatever comes in
    keep = (v & LIMB_MASK) != LIMB_MASK  # does not pass an incoming carry on
    K = v.shape[-2]
    idx = torch.arange(K, device=v.device).view(K, 1)
    last = torch.cummax(torch.where(keep, idx, -1), dim=-2).values
    src = _shift_in(last, -1)  # last non-propagating limb below k
    cin = torch.where(src >= 0, torch.gather(g, -2, src.clamp(min=0)), 0)
    return (v + cin) & LIMB_MASK


def _conv(a: Tensor, b: Tensor) -> Tensor:
    """Limb convolution (big-int product) of canonical int64 limb tensors:
    (..., A, B) x (..., A2, B) -> (..., A+A2-1, B), each < min(A, A2) * 2^32."""
    A, A2 = a.shape[-2], b.shape[-2]
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., A, A2, B)
    lead, lanes = prod.shape[:-3], prod.shape[-1]
    prod = prod.reshape(lead + (A * A2, lanes))
    idx = (
        torch.arange(A, device=a.device)[:, None]
        + torch.arange(A2, device=a.device)[None, :]
    ).reshape(-1)
    out = torch.zeros(lead + (A + A2 - 1, lanes), dtype=torch.int64, device=a.device)
    return out.index_add_(-2, idx, prod)


def _i64(x: Tensor) -> Tensor:
    return x.to(torch.int64)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


class FpCtx:
    """All batched mod-p arithmetic for one prime ``p``, with its constants as
    ``(L, 1)`` int64 tensors on ``device``."""

    def __init__(self, p: int, device, name: str = "fp"):
        self.p = p
        self.name = name
        self.device = torch.device(device)
        self.nbits = p.bit_length()
        # pad so R >= 4p: headroom for the lazy [0, 2p) value domain
        self.L = -(-(self.nbits + 2) // LIMB_BITS)
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
        # borrow-absorbing limbs of 2p + R: every limb >= 2^16 - 1, so
        # a + X - b never goes negative limbwise (see ``sub``)
        self.sub_offset = col(2 * p) + LIMB_MASK
        self.sub_offset[0] += 1
        self.r_mod_p = self.R % p
        self.r2 = (self.R * self.R) % p
        self.r2_limbs = col(self.r2)
        self.one_mont = col(self.r_mod_p)  # 1 in Montgomery form

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

    # ------------------------------------------------------------- helpers --
    def _cond_sub(self, r: Tensor, r_minus: Tensor) -> Tensor:
        """r - X if r >= X, via r + (R - X) with an overflow test (int64)."""
        w = _normalize(_pad_top(r + r_minus))
        ge = w[..., self.L, :] > 0  # r + (R - X) overflowed R  <=>  r >= X
        return torch.where(ge.unsqueeze(-2), w[..., : self.L, :], r)

    def _add64(self, a: Tensor, b: Tensor) -> Tensor:
        return self._cond_sub(_normalize(a + b), self.r_minus_2p)  # a + b < 4p <= R

    def _sub64(self, a: Tensor, b: Tensor) -> Tensor:
        # a - b + (2p + R) with the offset borrow-absorbing; the guaranteed
        # top digit (= R) is dropped
        w = _normalize(_pad_top(a + self.sub_offset - b))
        return self._cond_sub(w[..., : self.L, :], self.r_minus_2p)

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
        """Montgomery product a*b*R^{-1} mod p, relaxed [0, 2p) in and out."""
        return _i32(self._mont_mul64(_i64(a), _i64(b)))

    def sqr(self, a: Tensor) -> Tensor:
        return self.mont_mul(a, a)

    def to_mont(self, a_std: Tensor) -> Tensor:
        return self.mont_mul(a_std, self.r2_limbs)

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
