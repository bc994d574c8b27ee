"""Batched pairings and pairing-product checks (port of ``mathlib_tpu/batch.py``,
the pairing part of ``BatchEngine``).

``pairing_batch`` returns e(P_i, Q_i), final-exponentiated, for host point
lists: every lane's Miller loop and final exponentiation run on the card
(``ops/pairing.py``).  ``pairing_product_is_one(_async)`` and
``pairing_products_are_one`` are how a BLS or BBS+ verifier checks
signatures: prod_i e(P_i, Q_i) == 1 in one device pass.  The device runs
every pair's Miller loop and multiplies the lanes together; by default the
host C++ engine (``host/native.py``) does the single final exponentiation of
each product and tests it for unity, as the reference's default
``hostfexp`` strategy does.  The reference's opt-in all-device strategies
are read where the reference reads them: ``MATHLIB_PAIR_FUSED=split`` (the
final exp and unity test of the product on the card; ``check``, its
one-launch kernel, is not ported and raises) and
``MATHLIB_GROUP_FEXP=device`` (the grouped checks' final exps on the card).

The G1 entry points: ``g1_msm`` (host points and scalars to one affine
point; the window and GLV from ``auto_window``/``auto_glv`` unless pinned),
``g1_msm_device`` (the same on device tensors) and ``g1_scalar_mul`` (one
per-lane ladder launch, then affine on the card: one batch inversion).
``for_curve`` and ``get_batch_engine`` give one engine per curve and device.

The hash and BLS entry points (min-signature layout: signatures in G1, public
keys in G2): ``hash_to_g1_batch`` and ``hash_to_g1_bbs_batch`` (the device
hash of ``ops/hash.py``), ``bls_sign_batch`` (the device hash, one ladder
launch, affine on the card) and ``bls_verify_batch`` (a random linear
combination: two MSMs on the card, then one two-pair product check).  Curves
outside the device hash's gate (BN254, BLS12-377) hash on the host hasher.

``g2_scalar_mul`` is the G2 entry point: [k_i] Q_i for host lists, one
ladder on the card (the ``g2_smul`` kernel on BLS12-381; on the other
curves the reference's double-add-select scan over ``mont_mul``), decoded
on the host as the reference decodes it.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import device as _device
from .curves.params import CURVE_ID_SPEC, CurveID, CurveSpec, get_spec
from .host import get_engine
from .host.hash_to_curve import get_hasher
from .ops.field import ints_to_limbs, narrow_limbs, widen_limbs
from .ops.g1 import G1Ctx
from .ops.msm import auto_glv, auto_window, msm
from .ops.pairing import PairingCtx

Tensor = torch.Tensor

MAX_GROUP = 1024  # the reference's cap on pairs per grouped check


class BatchEngine:
    """Batched device engine for one curve, on the card unless ``device="cpu"``,
    its base field at ``base_limbs`` (L = 18 for FP256BN on a card; a CPU
    caller may ask for the card's limbs with ``L``)."""

    def __init__(self, spec: CurveSpec, device=None, L: Optional[int] = None):
        self.spec = spec
        self.device = _device(device)
        self.pair = PairingCtx(spec, self.device, L)
        self.tw = self.pair.tw
        self.fp = self.tw.fp
        self.g1 = G1Ctx(spec, self.device, L)
        self.g2 = self.pair.g2c
        self.host = get_engine(spec)

    @classmethod
    def for_curve(cls, curve_id: CurveID, device=None) -> "BatchEngine":
        return get_batch_engine(get_spec(CURVE_ID_SPEC[curve_id]), device)

    # ------------------------------------------------------------- G1 -------
    def _msm_params(self, n: int, c: Optional[int], glv: Optional[bool]):
        """The window width and the GLV split from n, unless pinned."""
        if c is None:
            c = auto_window(n, self.g1.nbits)
        if glv is None:
            glv = auto_glv(self.spec, n)
        return c, glv

    def g1_msm(self, points, scalars, c: Optional[int] = None, glv: Optional[bool] = None):
        """MSM over host inputs (affine points, None = infinity; ints):
        one affine host point (None = infinity)."""
        P = self.g1.encode_points(points)
        S = self.g1.encode_scalars([int(k) for k in scalars])
        return self.g1.decode_point(self.g1_msm_device(P, S, c, glv))

    def g1_msm_device(self, P: Tensor, S: Tensor, c: Optional[int] = None,
                      glv: Optional[bool] = None) -> Tensor:
        """MSM over device tensors: (3, L, N) points, (S, N) scalar limbs ->
        one (3, L, 1) point.  Points at the reference's L where the engine
        holds more limbs (FP256BN on a card: 17 against 18) enter by
        ``widen_limbs`` and the result leaves at their L by
        ``narrow_limbs``."""
        c, glv = self._msm_params(P.shape[-1], c, glv)
        Lin = P.shape[-2]
        out = msm(self.g1, widen_limbs(self.g1.fp, P), S, c=c, glv=glv)
        return narrow_limbs(self.g1.fp, out, Lin)

    def g1_scalar_mul(self, points, scalars) -> List:
        """[k_i] P_i for host lists, as affine host points: the ladder in one
        launch, then affine on the card (one batch inversion), so the host
        decode does no modular inverse."""
        P = self.g1.encode_points(points)
        S = self.g1.encode_scalars([int(k) for k in scalars])
        return self.g1.decode_points_affine(self.g1.to_affine_rows(self.g1.scalar_mul(P, S)))

    # ------------------------------------------------------------- G2 -------
    def g2_scalar_mul(self, points, scalars) -> List:
        """[k_i] Q_i for host lists (affine G2 points, None = infinity; ints),
        as affine host points: one ``G2Ctx.scalar_mul``, then the host
        decode (a host Fp2 inverse a point)."""
        P = self.g2.encode_points(points)
        S = self.g2.encode_scalars([int(k) for k in scalars])
        return self.g2.decode_points(self.g2.scalar_mul(P, S))

    # ---------------------------------------------------------- pairing -----
    def _encode_pairs(self, g1_points, g2_points) -> np.ndarray:
        """Affine pair lists -> ONE plain (non-Montgomery) (6, L, N) uint16
        array: xP, yP, Qx.c0, Qx.c1, Qy.c0, Qy.c1, one host->device copy."""
        if len(g1_points) != len(g2_points):
            raise ValueError("g1_points and g2_points differ in length")
        p, L = self.spec.p, self.fp.L
        cols = (
            [P[0] for P in g1_points],
            [P[1] for P in g1_points],
            [Q[0][0] for Q in g2_points],
            [Q[0][1] for Q in g2_points],
            [Q[1][0] for Q in g2_points],
            [Q[1][1] for Q in g2_points],
        )
        return np.stack(
            [ints_to_limbs([int(v) % p for v in c], L).T.astype(np.uint16) for c in cols]
        )

    def _pair_split_mont(self, packed: np.ndarray):
        """Widen, enter Montgomery form on the device, and unpack the
        (6, L, N) pair array into (xP, yP, Qx, Qy)."""
        t = torch.from_numpy(packed.astype(np.int32)).to(self.device)
        m = self.fp.to_mont(t)
        return m[0], m[1], m[2:4], m[4:6]

    def pairing_batch(self, g1_points, g2_points) -> List:
        """e(P_i, Q_i) for affine host point lists, as a list of host Fp12
        values; always final-exponentiated.  No pairs give an empty list, as
        in the reference."""
        packed = self._encode_pairs(g1_points, g2_points)
        if packed.shape[-1] == 0:
            return []
        return self.tw.f12_decode(self.pair.pairing(*self._pair_split_mont(packed)))

    def pairing_product_is_one(self, g1_points, g2_points) -> bool:
        """prod_i e(P_i, Q_i) == 1, with one shared final exponentiation: on
        the host engine, or on the card under ``MATHLIB_PAIR_FUSED=split``
        (BLS12 curves)."""
        strat = os.environ.get("MATHLIB_PAIR_FUSED")
        if strat in ("check", "split") and self.pair.supports_fused_check:
            packed = self._encode_pairs(g1_points, g2_points)
            return self.pair.product_check(*self._pair_split_mont(packed))
        return self.pairing_product_is_one_async(g1_points, g2_points)()

    def pairing_product_is_one_async(self, g1_points, g2_points) -> Callable[[], bool]:
        """Launch a product check now; return a zero-argument resolver that
        waits for the device product and finishes it on the host.  A
        serving loop that submits check i+1 before resolving check i
        overlaps the device work with the previous check's final exp."""
        packed = self._encode_pairs(g1_points, g2_points)
        prod = self.pair.product_miller(*self._pair_split_mont(packed))
        if prod.device.type == "cuda":
            host = torch.empty(prod.shape, dtype=prod.dtype, pin_memory=True)
            host.copy_(prod, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

            def resolve() -> bool:
                done.synchronize()
                return self._host_finish_product(host)

            return resolve
        return lambda: self._host_finish_product(prod)

    def pairing_products_are_one(self, g1_points, g2_points, group_size: int) -> List[bool]:
        """Many independent product checks: pairs are consecutive groups of
        ``group_size``; returns one verdict per group.  A power of two up to
        1024 runs in one device pass; any other size that divides the pair
        count runs one ``pairing_product_is_one`` per group, as the
        reference does."""
        n = len(g1_points)
        if n != len(g2_points) or group_size < 1 or n % group_size:
            raise ValueError("the pair count must be a multiple of group_size")
        if group_size & (group_size - 1):
            return [
                self.pairing_product_is_one(g1_points[k : k + group_size],
                                            g2_points[k : k + group_size])
                for k in range(0, n, group_size)
            ]
        if group_size > MAX_GROUP:
            raise ValueError(f"a power-of-two group_size must be <= {MAX_GROUP}")
        if n == 0:  # no groups, no device work: the reference's []
            return []
        packed = self._encode_pairs(g1_points, g2_points)
        prods = self.pair.products_miller(*self._pair_split_mont(packed), group_size)
        if os.environ.get("MATHLIB_GROUP_FEXP") == "device" and self.pair.supports_fused_check:
            # all G final exps as one launch, and the unity tests, on the card
            return self.tw.f12_is_one(self.tw.f12_final_exp(prods)).tolist()
        vals = self.tw.f12_decode(prods)

        def finish(v) -> bool:
            return bool(self.host.gt_is_one(self.host.final_exp(v)))

        if len(vals) >= 4:
            # ctypes releases the GIL and the engine context is read-only:
            # four final exps at a time
            with ThreadPoolExecutor(max_workers=4) as pool:
                return list(pool.map(finish, vals))
        return [finish(v) for v in vals]

    def _host_finish_product(self, prod) -> bool:
        """Finish a (2, 3, 2, L, 1) unreduced Miller product: decode the
        single Fp12, final-exponentiate on the host engine, test unity."""
        val = self.tw.f12_decode(prod)[0]
        return bool(self.host.gt_is_one(self.host.final_exp(val)))

    # ------------------------------------------------------------- BLS ------
    def _device_hash_ctx(self):
        """The device hash-to-G1 context, or None where this curve hashes on
        the host (no SSWU isogeny data, or p % 4 != 3: ops/hash.py's gate)."""
        from .ops.hash import get_hash_g1_ctx

        try:
            return get_hash_g1_ctx(self.spec, self.device)
        except ValueError:
            return None

    def hash_to_g1_batch(self, messages: Sequence[bytes], dst: bytes = b"") -> Tensor:
        """Messages -> (3, L, N) projective points on the device: the XMD
        expansion, the embedding and the map all on the card (ops/hash.py)."""
        from .ops.hash import hash_to_g1_batch

        return hash_to_g1_batch(self.spec, messages, dst, device=self.device)

    def hash_to_g1_bbs_batch(self, messages: Sequence[bytes], dst: bytes = b"") -> Tensor:
        """Messages -> (3, L, N) points by the BBS+ legacy big-endian-sign
        SSWU (kilic/custom.go:134-237), on the device apart from the BLAKE2b
        XMD bytes."""
        from .ops.hash import hash_to_g1_bbs_batch

        return hash_to_g1_bbs_batch(self.spec, messages, dst, device=self.device)

    def bls_sign_batch(self, sk: int, messages: Sequence[bytes], dst: bytes = b"") -> List:
        """sig_i = [sk] H(m_i), as affine host points.

        Inside the device hash's gate the hashes feed one ladder launch and
        the affine exit on the card; other curves hash on the host hasher."""
        if self._device_hash_ctx() is not None:
            H = self.hash_to_g1_batch(messages, dst)
            S = self.g1.encode_scalars([sk] * len(messages))
            return self.g1.decode_points_affine(self.g1.to_affine_rows(self.g1.scalar_mul(H, S)))
        hasher = get_hasher(self.spec)
        pts = [hasher.hash_to_g1(m, dst) for m in messages]
        return self.g1_scalar_mul(pts, [sk] * len(pts))

    def bls_verify_batch(self, pk, signatures, messages: Sequence[bytes],
                         dst: bytes = b"") -> bool:
        """Verify all (sig_i, m_i) under the G2 public key pk with one random
        linear combination and a single two-pair product check:
        e(sum w_i sig_i, -g2) e(sum w_i H(m_i), pk) == 1.  The weights come
        from ``random.SystemRandom``: they must stay unpredictable.

        Inside the device hash's gate the hashes and both weighted MSMs run
        on the card; other curves hash on the host hasher."""
        rng = random.SystemRandom()
        weights = [rng.randrange(1, self.spec.r) for _ in signatures]
        if self._device_hash_ctx() is not None:
            H = self.hash_to_g1_batch(messages, dst)
            P = self.g1.encode_points(list(signatures))
            W = self.g1.encode_scalars(weights)
            c, glv = self._msm_params(len(messages), None, None)
            sums = torch.cat([msm(self.g1, P, W, c=c, glv=glv), msm(self.g1, H, W, c=c, glv=glv)],
                             dim=-1)
            Spt, Hpt = self.g1.decode_points_affine(self.g1.to_affine_rows(sums))
        else:
            hasher = get_hasher(self.spec)
            hs = [hasher.hash_to_g1(m, dst) for m in messages]
            Spt = self.g1_msm(list(signatures), weights, c=4)
            Hpt = self.g1_msm(hs, weights, c=4)
        if Spt is None or Hpt is None:
            return False
        neg_g2 = self.host.g2.neg(self.spec.g2_gen)
        return self.pairing_product_is_one([Spt, Hpt], [neg_g2, pk])


@lru_cache(maxsize=None)
def get_batch_engine(spec: CurveSpec, device=None) -> BatchEngine:
    """One BatchEngine per curve and device (the card unless ``device="cpu"``)."""
    return BatchEngine(spec, device)
