"""expand_message_xmd (SHA-256) and the hash_to_field embedding on the device
(port of ``mathlib_tpu/ops/xmd.py``).

Hashing N messages of one length runs as tensor code on the card:

    host:   pack the fixed-structure padded SHA-256 blocks of
            b_0 = H(Z_pad || msg || l_i_b || 0 || DST') as numpy words (or
            only the message words, when they align on 32-bit words),
    device: b_0, then b_i = H((b_0 ^ b_{i-1}) || i || DST') for i = 1..ell
            (RFC 9380 5.3.1 steps 7-9), and the mod-p embedding of each
            big-endian L-byte slice in Montgomery form,
            enc(u) = mont_mul(u_lo, R^2) + mont_mul(u_hi, 2^256 R^2)
            (``FieldEmbed``; its products go to the ``mont_mul`` kernel).

In the reference this is XLA code outside any Pallas kernel, so here it is
PyTorch tensor code, not a hand-written kernel.  The SHA-256 words are held
in ``int64`` below 2^32: PyTorch on CUDA does not shift, rotate or add
``uint32`` reliably, and an ``int32`` right shift would sign-extend.  Every
sum is masked with ``& 0xFFFFFFFF`` before it is shifted or stored.  A
compression is a few thousand small launches (each round is serial), and a
BLS12-381 hash of a 32-byte message runs 11 compressions (b_0 is 3 blocks,
each of b_1..b_4 is 2 with a 43-byte DST), so on the card this stage is
bound by launches, not by the card's arithmetic.

The numpy packers are the reference's, array for array.  Byte equality with
``hashlib`` and the host ``expand_message_xmd`` is held by
``tests/test_torch_hash.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .field import FpCtx, int_to_limbs

Tensor = torch.Tensor

M32 = 0xFFFFFFFF

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.int64,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.int64,
)

# Rotation amounts, one row per sigma, with the left-shift mask of each term
# (0 for the plain right shift of the schedule's small sigmas):
# Sigma0(a), Sigma1(e) of the rounds; sigma0, sigma1 of the schedule.
_BIG = np.array([[2, 13, 22], [6, 11, 25]], dtype=np.int64)
_SMALL = np.array([[7, 18, 3], [17, 19, 10]], dtype=np.int64)
_SMALL_KEEP = np.array([[M32, M32, 0], [M32, M32, 0]], dtype=np.int64)


class _Consts:
    """The round constants and rotation tables on one device."""

    def __init__(self, device: torch.device):
        def t(a):
            return torch.from_numpy(a).to(device)

        self.K = t(_K)[:, None]
        self.H0 = t(_H0)[:, None]
        self.big = t(_BIG)[:, :, None]
        self.big_left = 32 - self.big
        self.small = t(_SMALL)[:, :, None]
        self.small_left = (32 - self.small) % 32
        self.small_keep = t(_SMALL_KEEP)[:, :, None]


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> _Consts:
    return _Consts(device)


def _sigmas(x: Tensor, right: Tensor, left: Tensor, keep=None) -> Tensor:
    """x (2, N) -> (2, N): for each row r, the xor over its three terms
    (x >> right[r, j]) | (x << left[r, j]) (the left part masked by keep)."""
    hi = x[:, None] << left
    if keep is not None:
        hi = hi & keep
    r = ((x[:, None] >> right) | hi) & M32
    return r[:, 0] ^ r[:, 1] ^ r[:, 2]


def _compress(c: _Consts, state: Tensor, w16: Tensor) -> Tensor:
    """One SHA-256 compression: state (8, N), block words (16, N), int64
    below 2^32."""
    w = list(w16.unbind(0))
    for i in range(16, 64):
        s = _sigmas(torch.stack([w[i - 15], w[i - 2]]), c.small, c.small_left, c.small_keep)
        w.append((w[i - 16] + s[0] + w[i - 7] + s[1]) & M32)
    kw = torch.stack(w) + c.K  # (64, N): K[i] + W[i], below 2^33
    a, b, cc, d, e, f, g, h = state.unbind(0)
    for i in range(64):
        s = _sigmas(torch.stack([a, e]), c.big, c.big_left)
        ch = g ^ (e & (f ^ g))
        maj = (a & b) | (cc & (a | b))
        t1 = h + s[1] + ch + kw[i]
        a, b, cc, d, e, f, g, h = (t1 + s[0] + maj) & M32, a, b, cc, (d + t1) & M32, e, f, g
    return (torch.stack([a, b, cc, d, e, f, g, h]) + state) & M32


def sha256_device(blocks: Tensor) -> Tensor:
    """Padded message blocks (nblk, 16, N) big-endian words (int64 below
    2^32) -> digests (8, N), on the blocks' device."""
    c = _consts(blocks.device)
    st = c.H0.expand(8, blocks.shape[-1])
    for k in range(blocks.shape[0]):
        st = _compress(c, st, blocks[k])
    return st


# ---------------------------------------------------------------------------
# host packing (numpy byte shuffling only -- no hashing)
# ---------------------------------------------------------------------------


def _pad_to_blocks(pre_len: int) -> int:
    """SHA-256 block count for a pre_len-byte message (incl. 0x80 + length)."""
    return (pre_len + 8) // 64 + 1


def _bytes_to_words(buf: np.ndarray) -> np.ndarray:
    """(N, nblk*64) u8 -> (nblk, 16, N) u32 big-endian words."""
    n, total = buf.shape
    w = buf.reshape(n, total // 64, 16, 4).astype(np.uint32)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    return np.ascontiguousarray(np.transpose(words, (1, 2, 0)))


def pack_b0_blocks(msgs: Sequence[bytes], dst: bytes, out_len: int) -> np.ndarray:
    """Pack b_0 = H(Z_pad || msg || l_i_b || 0x00 || DST') padded blocks.

    All messages must share one length (checked by the caller).  Returns
    (nblk, 16, N) u32 big-endian words ready for sha256_device.
    """
    n = len(msgs)
    m = len(msgs[0])
    dst_prime = dst + bytes([len(dst)])
    pre_len = 64 + m + 2 + 1 + len(dst_prime)
    nblk = _pad_to_blocks(pre_len)
    buf = np.zeros((n, nblk * 64), dtype=np.uint8)
    if m:
        buf[:, 64 : 64 + m] = np.frombuffer(b"".join(msgs), np.uint8).reshape(n, m)
    tail = out_len.to_bytes(2, "big") + b"\x00" + dst_prime
    buf[:, 64 + m : pre_len] = np.frombuffer(tail, np.uint8)
    buf[:, pre_len] = 0x80
    buf[:, -8:] = np.frombuffer((pre_len * 8).to_bytes(8, "big"), np.uint8)
    return _bytes_to_words(buf)


def pack_msg_words(msgs: Sequence[bytes], mlen: int) -> np.ndarray:
    """(mlen//4, N) u32 BE words of the raw messages (mlen % 4 == 0).

    Everything in the b_0 preimage EXCEPT the message bytes is constant
    across the batch (Z_pad zeros, l_i_b, DST', SHA padding), so only these
    words cross to the device."""
    n = len(msgs)
    return (
        np.frombuffer(b"".join(msgs), dtype=">u4")
        .reshape(n, mlen // 4)
        .T.astype(np.uint32)
    )


def b0_template(mlen: int, dst: bytes, out_len: int) -> np.ndarray:
    """(nblk*16,) u32 constant words of the b_0 preimage for any message of
    length mlen: the message slot (words 16 .. 16+mlen//4) is zero."""
    return pack_b0_blocks([bytes(mlen)], dst, out_len)[:, :, 0].reshape(-1)


def to_device_words(words: np.ndarray, device) -> Tensor:
    """u32 words (numpy) -> int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words).astype(np.int64)).to(device)


def b0_blocks_device(msg_w: Tensor, tmpl: np.ndarray, mlen: int) -> Tensor:
    """Assemble (nblk, 16, N) b_0 preimage blocks on the device from the
    per-message words (mlen//4, N) and the constant template (the message
    starts at byte 64 = word 16; mlen % 4 == 0 keeps the slot word-aligned)."""
    w = mlen // 4
    n = msg_w.shape[-1]
    t = to_device_words(tmpl, msg_w.device)[:, None]
    pre = t[:16].expand(16, n)
    post = t[16 + w :].expand(t.shape[0] - 16 - w, n)
    return torch.cat([pre, msg_w, post], dim=0).reshape(-1, 16, n)


def _bi_template(dst: bytes, i: int) -> np.ndarray:
    """Constant words of the b_i preimage block(s): 32 zero bytes (the
    digest slot, filled on the device) || i || DST' || SHA padding.
    Returns (nblk, 16) u32."""
    dst_prime = dst + bytes([len(dst)])
    pre = bytes(32) + bytes([i]) + dst_prime
    nblk = _pad_to_blocks(len(pre))
    buf = np.zeros((1, nblk * 64), dtype=np.uint8)
    buf[0, : len(pre)] = np.frombuffer(pre, np.uint8)
    buf[0, len(pre)] = 0x80
    buf[0, -8:] = np.frombuffer((len(pre) * 8).to_bytes(8, "big"), np.uint8)
    return _bytes_to_words(buf)[..., 0]  # (nblk, 16)


def xmd_sha256_device(blocks0: Tensor, templates: Sequence[np.ndarray]) -> Tensor:
    """RFC 9380 expand_message_xmd on the device.

    blocks0: packed b_0 preimage (nblk0, 16, N); templates: per-i constant
    words from _bi_template.  Returns the uniform bytes as (8*ell, N)
    big-endian words (b_1 || ... || b_ell), int64 below 2^32.
    """
    n = blocks0.shape[-1]
    b0 = sha256_device(blocks0)
    outs: List[Tensor] = []
    prev = b0
    for idx, tmpl in enumerate(templates):
        x = b0 if idx == 0 else b0 ^ prev
        blk = to_device_words(tmpl, blocks0.device)[:, :, None].repeat(1, 1, n)
        blk[0, :8] = x
        prev = sha256_device(blk)
        outs.append(prev)
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# digest words -> field elements (mod-p embedding, on the device)
# ---------------------------------------------------------------------------


class FieldEmbed:
    """int.from_bytes(uniform[i*L:(i+1)*L], 'big') % p, in Montgomery form.

    L is the RFC hash_to_field byte length (64 for 48-byte fields, 48
    otherwise) and must be a multiple of 4 so slices align on 32-bit words.
    Both products go to ``FpCtx.mont_mul`` (the ``mont_mul`` kernel on a
    card): u_lo, u_hi < 2^256 <= R and the constants are below p, so the
    output stays in the relaxed [0, 2p).
    """

    def __init__(self, fp: FpCtx, l_bytes: int):
        if l_bytes % 4:
            raise ValueError("the byte length must be a multiple of 4")
        self.fp = fp
        self.l_bytes = l_bytes
        self.words = l_bytes // 4
        r2 = fp.r2
        # enc(u) = mont_mul(u_lo, R^2) + mont_mul(u_hi, 2^256 * R^2)
        self.c_lo = self._col(int_to_limbs(r2, fp.L))
        self.c_hi = self._col(int_to_limbs((r2 << 256) % fp.p, fp.L))

    def _col(self, limbs: np.ndarray) -> Tensor:
        return torch.from_numpy(limbs.astype(np.int32)[:, None]).to(self.fp.device)

    def _limbs(self, words: Tensor, lo: int, hi: int) -> Tensor:
        """16-bit limbs lo..hi-1 of the big integer behind (W, N) BE words,
        zero-padded to (L, N) int32."""
        w = self.words
        rows = [(words[w - 1 - k // 2] >> (16 * (k % 2))) & 0xFFFF for k in range(lo, hi)]
        out = torch.stack(rows).to(torch.int32)
        return torch.nn.functional.pad(out, (0, 0, 0, self.fp.L - len(rows)))

    def embed(self, words: Tensor) -> Tensor:
        """(W, N) BE words -> (L, N) Montgomery limbs of value mod p."""
        fp = self.fp
        total = 2 * self.words  # 16-bit limbs in the input
        out = fp.mont_mul(self._limbs(words, 0, min(16, total)), self.c_lo)
        if total > 16:
            out = fp.add(out, fp.mont_mul(self._limbs(words, 16, total), self.c_hi))
        return out


def hash_to_field_device(
    fp: FpCtx, blocks0: Tensor, dst: bytes, count: int, l_bytes: int
) -> Tuple[Tensor, ...]:
    """Device hash_to_field: packed b_0 blocks -> count field elements,
    equal mod p to the host ``hash_to_field_fp`` (SHA-256), in the relaxed
    Montgomery domain of FpCtx."""
    out_len = count * l_bytes
    ell = (out_len + 31) // 32
    templates = [_bi_template(dst, i) for i in range(1, ell + 1)]
    uniform = xmd_sha256_device(blocks0, templates)  # (8*ell, N)
    emb = FieldEmbed(fp, l_bytes)
    w = l_bytes // 4
    return tuple(emb.embed(uniform[i * w : (i + 1) * w]) for i in range(count))
