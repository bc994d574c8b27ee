"""Device hash-to-curve: SSWU map, isogeny, cofactor clearing (port of
``mathlib_tpu/ops/hash.py``).

Hashing N messages of one length runs on the card:

  host:   numpy packing of the padded SHA-256 blocks (or only the message
          words), or, for mixed lengths and other hashes, the RFC
          hash_to_field values as plain limbs (``host/hash_to_curve.py``),
  device: expand_message_xmd and the mod-p embedding (``ops/xmd.py``,
          PyTorch tensor code and the ``mont_mul`` kernel), then the map.

G1: the whole map -- both SSWU maps, the sign fix, the isogeny, one add and
the cofactor ladder -- in one launch of the ``hash_g1`` kernel
(``kernels/hash_cuda.py``) for the signs "parity" (RFC sgn0) and "be" (the
BBS+ big-endian sign of kilic custom.go:99-105).  On the CPU ``hash_to_g1``
runs the kernel's plain version.  ``sign="none"`` runs the tensor pipeline
below (the reference's off-TPU path): ``FpCtx``'s products and chains (the
``mont_mul`` and ``fp_pow`` kernels on a card), ``G1Ctx.add`` and
``clear_cofactor`` on the ``smul_static`` kernel.

G2 (``HashG2Ctx``, the RFC 9380 BLS12381G2 suite): the reference has no
fused kernel for this map.  The two SSWU maps on Fp2, with the branchless
Fp2 square root (three shared ``FpCtx`` chains, the ``fp_pow`` kernel on a
card), and the two 3-isogenies are ``TowerCtx`` ops (their products the
``mont_mul`` kernel); the add, the double and the two cofactor ladders of
the Budroni-Pintore clearing are the ``g2_add``, ``g2_double`` and
``g2_smul_static`` kernels (``kernels/g2_cuda.py``).

Gates: G1 needs G1 SSWU isogeny data and p = 3 (mod 4) for the square-root
chain: BLS12-381 today; BLS12-377 (p = 1 mod 4) and BN254 (no isogeny) stay
on the host hasher.  G2 needs G2 isogeny data, p = 3 (mod 4) and beta = -1:
BLS12-381.  Equality with the host hasher, and through it with RFC 9380
J.9.1 and J.10.1, is held by ``tests/test_torch_hash.py`` and
``tests/test_torch_hash_g2.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from ..curves import isogeny_data
from ..curves.params import CurveSpec, Family
from ..host.fields import get_tower
from ..host.hash_to_curve import get_hasher
from .field import FpCtx, bits_of
from .g1 import G1Ctx, get_g1_ctx
from .g2 import G2Ctx, get_g2_ctx
from .kernels import g1_cuda, g2_cuda, hash_cuda

Tensor = torch.Tensor


class HashG1Ctx:
    """Batched device hash-to-G1 for one CurveSpec (SSWU curves only), on
    the card unless ``device="cpu"``."""

    def __init__(self, spec: CurveSpec, device=None):
        d = isogeny_data.G1.get(spec.name)
        if d is None:
            raise ValueError(f"{spec.name}: no G1 SSWU isogeny data")
        if spec.p % 4 != 3:
            raise ValueError(f"{spec.name}: p % 4 != 3, no device sqrt chain")
        self.spec = spec
        self.g1: G1Ctx = get_g1_ctx(spec, device)
        self.fp: FpCtx = self.g1.fp
        self.device = self.fp.device
        fp, p = self.fp, spec.p

        A, B, Z = d["A"], d["B"], d["Z"]
        self.A = fp.encode(A)
        self.B = fp.encode(B)
        self.Z = fp.encode(Z)
        self.negB_over_A = fp.encode((-B * pow(A, -1, p)) % p)
        self.B_over_ZA = fp.encode(B * pow(Z * A, -1, p) % p)
        # isogeny coefficients, low-degree-first, Montgomery-encoded
        self.iso = tuple([fp.encode(c) for c in coeffs] for coeffs in d["iso"])
        # effective G1 cofactor: 1-x for BLS12 (kilic/gnark), 1 for BN
        h = 1 - spec.x if spec.family == Family.BLS12 else 1
        self.h_bits = bits_of(abs(h))[::-1].copy()  # MSB first
        self.h_neg = h < 0
        self._dev: dict = {}  # device copies of the kernel's constants (hash_cuda)

    def consts(self) -> dict:
        """The map's (L, 1) Montgomery constants by name."""
        return {"Z": self.Z, "A": self.A, "B": self.B, "negB_over_A": self.negB_over_A,
                "B_over_ZA": self.B_over_ZA}

    # ------------------------------------------------------------ helpers ---
    def _std(self, a: Tensor) -> Tensor:
        return self.fp.canon(self.fp.from_mont(a))

    def _parity(self, a: Tensor) -> Tensor:
        """sgn0 of the canonical integer behind a Montgomery value -> (..., B)."""
        return self._std(a)[..., 0, :] & 1

    def _le_half(self, a: Tensor) -> Tensor:
        """BBS big-endian sign: canonical(a) <= canonical(-a)?

        kilic/custom.go:99-105 defines sign(z) = (-z >= z); equivalently
        z <= p/2 with 0 counted positive."""
        std = self._std(a).to(torch.int64)
        neg = self._std(self.fp.neg(a)).to(torch.int64)
        # the most significant differing limb decides: the sign of
        # sum_k sign(std_k - neg_k) 2^k is that limb's
        weight = (1 << torch.arange(self.fp.L, device=a.device, dtype=torch.int64))[:, None]
        return (torch.sign(std - neg) * weight).sum(dim=-2) <= 0

    # ---------------------------------------------------------------- SSWU --
    def sswu(self, u: Tensor, sign: str = "parity") -> Tuple[Tensor, Tensor]:
        """map_to_curve_simple_swu onto E': u (L, B) -> affine (x, y).

        ``sign``: "parity" (RFC sgn0) or "be" (the kilic BBS+ variant's
        big-endian sign, custom.go:134-237) or "none" (caller fixes it)."""
        fp = self.fp
        one = fp.one_mont.to(torch.int32).expand(u.shape)
        t1 = fp.mont_mul(self.Z, fp.sqr(u))  # Z u^2
        t2 = fp.add(fp.sqr(t1), t1)  # Z^2 u^4 + Z u^2
        # inv(0) = 0: overwritten by the exceptional case below
        x1 = fp.mont_mul(self.negB_over_A, fp.add(one, fp.inv(t2)))
        x1 = fp.select(fp.is_zero(t2), self.B_over_ZA.expand(x1.shape), x1)
        gx1 = fp.add(fp.mont_mul(fp.add(fp.sqr(x1), self.A), x1), self.B)
        x2 = fp.mont_mul(t1, x1)
        t13 = fp.mont_mul(t1, fp.sqr(t1))
        gx2 = fp.mont_mul(gx1, t13)  # g(x2) = g(x1) Z^3 u^6

        y_cand = fp.sqrt(torch.stack([gx1, gx2], dim=0))  # one shared chain
        is_sq = fp.eq(fp.sqr(y_cand[0]), gx1)
        x = fp.select(is_sq, x1, x2)
        y = fp.select(is_sq, y_cand[0], y_cand[1])

        if sign == "parity":
            flip = self._parity(u) != self._parity(y)
        elif sign == "be":
            flip = self._le_half(u) != self._le_half(y)
        elif sign == "none":
            return x, y
        else:
            raise ValueError(f"sign must be 'parity', 'be' or 'none', got {sign!r}")
        return x, fp.select(flip, fp.neg(y), y)

    # -------------------------------------------------------------- isogeny --
    def _horner(self, coeffs, x: Tensor) -> Tensor:
        fp = self.fp
        acc = coeffs[-1].expand(x.shape)
        for c in reversed(coeffs[:-1]):
            acc = fp.add(fp.mont_mul(acc, x), c)
        return acc

    def iso_project(self, x: Tensor, y: Tensor) -> Tensor:
        """Evaluate the rational isogeny E' -> E, returning (3, L, B)
        projective -- X = xn*yd, Y = y*yn*xd, Z = xd*yd (no inversions;
        kernel points land on infinity automatically)."""
        fp = self.fp
        xn, xd, yn, yd = (self._horner(cs, x) for cs in self.iso)
        X = fp.mont_mul(xn, yd)
        Y = fp.mont_mul(y, fp.mont_mul(yn, xd))
        Z = fp.mont_mul(xd, yd)
        return torch.stack([X, Y, Z], dim=-3)

    # ------------------------------------------------------------- cofactor --
    def clear_cofactor(self, P: Tensor) -> Tensor:
        """[h_eff] P: the ladder over the static cofactor bits in one launch
        of the ``smul_static`` kernel (the add only at the one-bits), negated
        when h_eff < 0."""
        if len(self.h_bits) == 1 and self.h_bits[0] == 1 and not self.h_neg:
            return P
        acc = g1_cuda.smul_static(self.g1.F, P, self.h_bits)
        return self.g1.neg(acc) if self.h_neg else acc

    # ---------------------------------------------------------- entry point --
    def hash_to_g1(self, u0: Tensor, u1: Tensor, sign: str = "parity") -> Tensor:
        """(u0, u1) field-element batches -> (3, L, B) projective points.

        iso(sswu(u0)) + iso(sswu(u1)) (the isogeny is a group homomorphism,
        so mapping each point and adding on E equals the host's add on E'
        then map) followed by the cofactor clearing -- equal to the host's
        hash_to_g1.  For "parity" and "be" the whole map is one launch of
        the ``hash_g1`` kernel on a card (its plain version on the CPU)."""
        if sign in hash_cuda.SIGNS:
            return hash_cuda.hash_g1(self, u0, u1, sign)
        x0, y0 = self.sswu(u0, sign)
        x1, y1 = self.sswu(u1, sign)
        P = self.g1.add(self.iso_project(x0, y0), self.iso_project(x1, y1))
        return self.clear_cofactor(P)


@lru_cache(maxsize=None)
def get_hash_g1_ctx(spec: CurveSpec, device=None) -> HashG1Ctx:
    """One HashG1Ctx per curve and device (the card unless ``device="cpu"``)."""
    return HashG1Ctx(spec, device)


# ---------------------------------------------------------------------------
# G2: SSWU on E''(Fp2), 3-isogeny, endomorphism cofactor clearing
# ---------------------------------------------------------------------------


class HashG2Ctx:
    """Batched device hash-to-G2 (BLS12-381: the RFC 9380 BLS12381G2 suite),
    on the card unless ``device="cpu"``.

    HashG1Ctx's pipeline over Fp2.  The Fp2 square root is the complex
    method, branchless: for beta = -1, sqrt(a0 + a1 u) has x0^2 in
    {(a0 +/- sqrt(a0^2 + a1^2))/2} -- exactly one of them a square when a is
    one -- and x1 = a1 / (2 x0): three shared base-field chains a map (the
    norm's square root, the stacked square roots, the inverse of x0).

    The cofactor clearing is Budroni-Pintore (eprint 2017/419 4.1):
    [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P), psi the
    untwist-Frobenius-twist endomorphism; the two ladders run over static
    bits, one ``g2_smul_static`` launch each."""

    def __init__(self, spec: CurveSpec, device=None):
        d = isogeny_data.G2.get(spec.name)
        if d is None:
            raise ValueError(f"{spec.name}: no G2 SSWU isogeny data")
        if spec.p % 4 != 3 or spec.beta != spec.p - 1:
            raise ValueError(f"{spec.name}: device Fp2 sqrt needs p % 4 == 3 and beta == -1")
        self.spec = spec
        self.g2: G2Ctx = get_g2_ctx(spec, device)
        if self.g2.rows is None:
            raise ValueError(f"{spec.name}: the G2 ladders need a small twist constant")
        self.tw = self.g2.tw
        self.fp: FpCtx = self.tw.fp
        self.device = self.fp.device
        ht = get_tower(spec)
        p = spec.p

        A, B, Z = d["A"], d["B"], d["Z"]
        f2e = self.tw.f2_encode
        self.A = f2e(A)
        self.B = f2e(B)
        self.Z = f2e(Z)
        self.negB_over_A = f2e(ht.f2_neg(ht.f2_mul(B, ht.f2_inv(A))))
        self.B_over_ZA = f2e(ht.f2_mul(B, ht.f2_inv(ht.f2_mul(Z, A))))
        self.iso = tuple([f2e(c) for c in coeffs] for coeffs in d["iso"])
        self.inv2 = self.fp.encode((p + 1) // 2)  # 1/2 mod p
        # psi(x, y) = (conj(x) cx, conj(y) cy), from the host hasher's
        # convention search
        self.psi_cx, self.psi_cy = (f2e(c) for c in get_hasher(spec).psi_consts)

        x = spec.x
        self.x_bits_1 = bits_of(abs(x * x - x - 1))[::-1].copy()  # MSB first
        self.x_neg_1 = (x * x - x - 1) < 0
        self.x_bits_2 = bits_of(abs(x - 1))[::-1].copy()
        self.x_neg_2 = (x - 1) < 0

    # ----------------------------------------------------------- Fp2 sqrt ---
    def f2_sqrt_candidate(self, a: Tensor) -> Tensor:
        """Branchless candidate square root of (..., 2, L, B); right whenever
        a is a square (the caller checks that it squares back to a)."""
        fp, tw = self.fp, self.tw
        a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
        # chain 1: s = sqrt(a0^2 + a1^2), the norm (beta = -1)
        s = fp.sqrt(fp.add(fp.sqr(a0), fp.sqr(a1)))
        d1 = fp.mont_mul(fp.add(a0, s), self.inv2)
        d2 = fp.mont_mul(fp.sub(a0, s), self.inv2)
        # chain 2 (stacked): the square roots of d1, d2, a0 and -a0
        x0a, x0b, sa, sb = fp.sqrt(torch.stack([d1, d2, a0, fp.neg(a0)], dim=0)).unbind(0)
        x0 = fp.select(fp.eq(fp.sqr(x0a), d1), x0a, x0b)
        # chain 3: x1 = a1 / (2 x0)
        x1 = fp.mont_mul(fp.mont_mul(a1, self.inv2), fp.inv(x0))
        # a1 = 0: sqrt(a0) in Fp, else sqrt(-a0) u (beta = -1)
        zero = torch.zeros_like(sa)
        base = tw.f2_select(fp.eq(fp.sqr(sa), a0), torch.stack([sa, zero], dim=-3),
                            torch.stack([zero, sb], dim=-3))
        return tw.f2_select(fp.is_zero(a1), base, torch.stack([x0, x1], dim=-3))

    def _sgn0_f2(self, a: Tensor) -> Tensor:
        """RFC 9380 sgn0 for m = 2: sgn0(a0) unless a0 = 0, then sgn0(a1)."""
        fp = self.fp
        s0 = fp.canon(fp.from_mont(a[..., 0, :, :]))[..., 0, :] & 1
        s1 = fp.canon(fp.from_mont(a[..., 1, :, :]))[..., 0, :] & 1
        return torch.where(fp.is_zero(a[..., 0, :, :]), s1, s0)

    # ---------------------------------------------------------------- SSWU --
    def sswu(self, u: Tensor) -> Tuple[Tensor, Tensor]:
        """map_to_curve_simple_swu on E''(Fp2): u (2, L, B) -> affine (x, y)."""
        tw = self.tw
        one = tw.f2_one.expand(u.shape)
        t1 = tw.f2_mul(self.Z, tw.f2_sqr(u))  # Z u^2
        t2 = tw.f2_add(tw.f2_sqr(t1), t1)  # Z^2 u^4 + Z u^2
        # inv(0) = 0: overwritten by the exceptional case below
        x1 = tw.f2_mul(self.negB_over_A, tw.f2_add(one, tw.f2_inv(t2)))
        x1 = tw.f2_select(tw.f2_is_zero(t2), self.B_over_ZA.expand(x1.shape), x1)
        gx1 = tw.f2_add(tw.f2_mul(tw.f2_add(tw.f2_sqr(x1), self.A), x1), self.B)
        x2 = tw.f2_mul(t1, x1)
        t13 = tw.f2_mul(t1, tw.f2_sqr(t1))
        gx2 = tw.f2_mul(gx1, t13)  # g(x2) = g(x1) Z^3 u^6

        y_cand = self.f2_sqrt_candidate(torch.stack([gx1, gx2], dim=0))  # shared chains
        is_sq = tw.f2_eq(tw.f2_sqr(y_cand[0]), gx1)
        x = tw.f2_select(is_sq, x1, x2)
        y = tw.f2_select(is_sq, y_cand[0], y_cand[1])
        flip = self._sgn0_f2(u) != self._sgn0_f2(y)
        return x, tw.f2_select(flip, tw.f2_neg(y), y)

    # -------------------------------------------------------------- isogeny --
    def _horner(self, coeffs, x: Tensor) -> Tensor:
        tw = self.tw
        acc = coeffs[-1].expand(x.shape)
        for c in reversed(coeffs[:-1]):
            acc = tw.f2_add(tw.f2_mul(acc, x), c)
        return acc

    def iso_project(self, x: Tensor, y: Tensor) -> Tensor:
        """(x, y) on E'' -> (3, 2, L, B) projective on E: X = xn yd,
        Y = y yn xd, Z = xd yd (no inversions)."""
        tw = self.tw
        xn, xd, yn, yd = (self._horner(cs, x) for cs in self.iso)
        X = tw.f2_mul(xn, yd)
        Y = tw.f2_mul(y, tw.f2_mul(yn, xd))
        Z = tw.f2_mul(xd, yd)
        return torch.stack([X, Y, Z], dim=-4)

    # ---------------------------------------------------------------- psi ----
    def psi(self, P: Tensor) -> Tensor:
        """Untwist-Frobenius-twist on projective (..., 3, 2, L, B):
        (X : Y : Z) -> (conj(X) cx : conj(Y) cy : conj(Z))."""
        tw = self.tw
        X = tw.f2_mul(tw.f2_conj(P[..., 0, :, :, :]), self.psi_cx)
        Y = tw.f2_mul(tw.f2_conj(P[..., 1, :, :, :]), self.psi_cy)
        Z = tw.f2_conj(P[..., 2, :, :, :])
        return torch.stack([X, Y, Z], dim=-4)

    # ------------------------------------------------------------- cofactor --
    def _mul_bits(self, P: Tensor, bits, negate: bool) -> Tensor:
        """[k] P over static MSB-first bits: one ``g2_smul_static`` launch on
        a card, negated when k < 0."""
        acc = g2_cuda.smul_static(self.g2.rows, P, bits)
        return self.g2.neg(acc) if negate else acc

    def clear_cofactor(self, P: Tensor) -> Tensor:
        """Budroni-Pintore: [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P)."""
        g2 = self.g2
        acc = self._mul_bits(P, self.x_bits_1, self.x_neg_1)
        acc = g2.add(acc, self.psi(self._mul_bits(P, self.x_bits_2, self.x_neg_2)))
        return g2.add(acc, self.psi(self.psi(g2.double(P))))

    # ---------------------------------------------------------- entry point --
    def hash_to_g2(self, u0: Tensor, u1: Tensor) -> Tensor:
        """(u0, u1) Fp2 batches (2, L, B) -> (3, 2, L, B) projective points:
        iso(sswu(u0)) + iso(sswu(u1)), then the cofactor clearing, equal to
        the host hasher's hash_to_g2."""
        x0, y0 = self.sswu(u0)
        x1, y1 = self.sswu(u1)
        P = self.g2.add(self.iso_project(x0, y0), self.iso_project(x1, y1))
        return self.clear_cofactor(P)


@lru_cache(maxsize=None)
def get_hash_g2_ctx(spec: CurveSpec, device=None) -> HashG2Ctx:
    """One HashG2Ctx per curve and device (the card unless ``device="cpu"``)."""
    return HashG2Ctx(spec, device)


# ---------------------------------------------------------------------------
# host seam: messages -> device points
# ---------------------------------------------------------------------------


def _uniform_len(msgs) -> int:
    """Shared message length, or -1 if the batch mixes lengths."""
    m = len(msgs[0])
    return m if all(len(x) == m for x in msgs) else -1


def hash_to_g1_batch(spec: CurveSpec, msgs, dst: bytes, sign: str = "parity",
                     hash_name: str = "sha256", device=None) -> Tensor:
    """Batched messages -> (3, L, N) projective G1 points on the device.

    SHA-256 and one message length: expand_message_xmd, the embedding and
    the map all run on the device; the host packs the message words (the
    word path, lengths a multiple of 4) or the whole padded b_0 blocks (the
    block path).  Otherwise the host computes the RFC hash_to_field values
    and the device enters Montgomery form and runs the map."""
    from .xmd import (b0_blocks_device, b0_template, hash_to_field_device, pack_b0_blocks,
                      pack_msg_words, to_device_words)

    ctx = get_hash_g1_ctx(spec, device)
    L = 64 if spec.fp_bytes == 48 else 48
    mlen = _uniform_len(msgs)
    if hash_name == "sha256" and mlen >= 0:
        if mlen > 0 and mlen % 4 == 0:
            # only the message words cross to the device; the constant rest
            # of the b_0 preimage is assembled there
            words = to_device_words(pack_msg_words(msgs, mlen), ctx.device)
            blocks = b0_blocks_device(words, b0_template(mlen, dst, 2 * L), mlen)
        else:
            blocks = to_device_words(pack_b0_blocks(msgs, dst, 2 * L), ctx.device)
        u0, u1 = hash_to_field_device(ctx.fp, blocks, dst, 2, L)
        return ctx.hash_to_g1(u0, u1, sign)

    from ..host.hash_to_curve import hash_to_field_fp

    us = [hash_to_field_fp(m, dst, spec.p, 2, L, hash_name) for m in msgs]
    # plain limbs from the host, the Montgomery entry on the device (one
    # mont_mul launch on a card), as BatchEngine._pair_split_mont enters it
    n = len(msgs)
    u = ctx.fp.to_mont(ctx.fp.encode_plain([u[0] for u in us] + [u[1] for u in us]))
    return ctx.hash_to_g1(u[:, :n], u[:, n:], sign)


def hash_to_g1_bbs_batch(spec: CurveSpec, msgs, dst: bytes, device=None) -> Tensor:
    """Batched BBS+ legacy hash-to-G1 on the device (kilic/custom.go:134-237).

    The host does only the BLAKE2b-512 expand_message_xmd bytes; the
    from64Bytes embedding e1 + e0*2^256 mod p (custom.go:312-342) runs on the
    device (each 64-byte half read as one big-endian integer IS
    e0*2^256 + e1, so ``FieldEmbed`` computes it in two products), and the
    map is the ``hash_g1`` kernel with the big-endian sign."""
    import numpy as np

    from ..host.hash_to_curve import expand_message_xmd
    from .xmd import FieldEmbed, to_device_words

    ctx = get_hash_g1_ctx(spec, device)
    n = len(msgs)
    buf = b"".join(expand_message_xmd(m, dst, 128, "blake2b512") for m in msgs)
    # (32, N) BE words; rows 0-15 = the first 64-byte half, 16-31 = the second
    words = to_device_words(np.frombuffer(buf, dtype=">u4").reshape(n, 32).T, ctx.device)
    emb = FieldEmbed(ctx.fp, 64)
    return ctx.hash_to_g1(emb.embed(words[:16]), emb.embed(words[16:]), "be")


def hash_to_g2_batch(spec: CurveSpec, msgs, dst: bytes, hash_name: str = "sha256",
                     device=None) -> Tensor:
    """Batched messages -> (3, 2, L, N) projective G2 points on the device.

    SHA-256 and one message length: expand_message_xmd (four field elements
    a message), the embedding and the map all run on the device; the host
    packs the message words (the word path, lengths a multiple of 4) or the
    whole padded b_0 blocks (the block path).  Otherwise the host computes
    the RFC hash_to_field values and the device enters Montgomery form and
    runs the map.  Equal to the host hasher's hash_to_g2 (and through it to
    RFC 9380 J.10.1)."""
    from .xmd import (b0_blocks_device, b0_template, hash_to_field_device, pack_b0_blocks,
                      pack_msg_words, to_device_words)

    ctx = get_hash_g2_ctx(spec, device)
    L = 64 if spec.fp_bytes == 48 else 48
    mlen = _uniform_len(msgs)
    if hash_name == "sha256" and mlen >= 0:
        if mlen > 0 and mlen % 4 == 0:
            words = to_device_words(pack_msg_words(msgs, mlen), ctx.device)
            blocks = b0_blocks_device(words, b0_template(mlen, dst, 4 * L), mlen)
        else:
            blocks = to_device_words(pack_b0_blocks(msgs, dst, 4 * L), ctx.device)
        es = hash_to_field_device(ctx.fp, blocks, dst, 4, L)
        return ctx.hash_to_g2(torch.stack(es[:2]), torch.stack(es[2:]))

    from ..host.hash_to_curve import hash_to_field_fp2

    us = [hash_to_field_fp2(m, dst, spec.p, 2, L, hash_name) for m in msgs]
    # plain limbs from the host, the Montgomery entry on the device (one
    # mont_mul launch on a card): rows u0.c0, u0.c1, u1.c0, u1.c1
    cols = [u[i][j] for i in range(2) for j in range(2) for u in us]
    u = ctx.fp.to_mont(ctx.fp.encode_plain(cols)).reshape(ctx.fp.L, 2, 2, len(msgs))
    u = u.permute(1, 2, 0, 3)
    return ctx.hash_to_g2(u[0], u[1])
