"""The port's one-launch pairing check (``pairing_cuda.pairing_check``, the
reference's ``_pairing_check_kernel`` behind ``MATHLIB_PAIR_FUSED=check``)
against the JAX package, on the CPU, on BLS12-381.

* ``PairingCtx.product_check`` under ``check`` on 4 lanes whose last 2 hold
  garbage: n = 2 is a True set (e(P, G) e(-P, G)), n = 1 the False set
  e(P, G).  These are the file's only two plain checks (each a plain Miller
  loop and a plain final exp).
* Their verdicts equal the host engine's ``gt_is_one(final_exp(prod))`` of
  the unreduced product, the default strategy's host finish of it, and
  ``BatchEngine.pairing_product_is_one`` under the default strategy on the
  True set.
* The unreduced product equals, mod p, the product of the reference's Miller
  values (``_miller_conj_tail`` on numpy rows, the stand-ins of
  ``tests/test_pairing_pallas.py``), the pad lanes left out.
* ``BatchEngine.pairing_product_is_one`` and ``bls_verify_batch`` reach the
  kernel's wrapper under ``check`` and nothing else (a recorder stands in).

Nothing here jits the reference's pairing, Miller loop or final exp.
"""

from functools import reduce

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.fp_rows as ref_fp_rows
import mathlib_tpu.ops.kernels.pairing_pallas as ref_pp
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from test_pairing_pallas import _FakeJax, _FakePl, _FakePltpu, _Ref

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bls():
    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    P, G = eng.g1.mul(eng.gen_g1, 99), eng.gen_g2
    junk = [eng.g1.mul(eng.gen_g1, 5), eng.g1.mul(eng.gen_g1, 7)]
    g1s, g2s = [P, eng.g1.neg(P)] + junk, [G, G, eng.g2.mul(G, 3), G]
    return spec, eng, BatchEngine(spec, "cpu"), g1s, g2s


def _ref_miller_values(be, xP, yP, Qx, Qy):
    """Per-lane Miller values of the reference kernel body, as host Fp12s."""
    pair, L, B = be.pair, be.fp.L, xP.shape[-1]
    p, L_ref, n, xi0, twist = ref_pp._cfg(be.spec)
    assert L_ref == L
    tw = ref_pp.RowTower(p, L, n, xi0, twist)
    bits = np.asarray(pair.loop_bits, dtype=np.uint32)

    def rows(t):  # (..., L, B) int32 -> (K*L, 1, B) uint32
        return t.numpy().astype(np.uint32).reshape(-1, 1, B)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_fp_rows, ref_pp):
            mp.setattr(mod, "jnp", np)
        mp.setattr(ref_pp, "pl", _FakePl)
        mp.setattr(ref_pp, "jax", _FakeJax)
        mp.setattr(ref_pp, "pltpu", _FakePltpu)
        # every product of a MulBatch in one stacked numpy product (the same
        # values as the TPU's chunks of 12: the chunk is a VMEM knob)
        mp.setattr(ref_pp, "MUL_CHUNK", 1 << 12)
        f = ref_pp._miller_conj_tail(
            tw, len(bits), pair.conj_end, None, _Ref(bits), _Ref(rows(xP)), _Ref(rows(yP)),
            _Ref(rows(Qx)), _Ref(rows(Qy)), _Ref(np.zeros((12 * L, 1, B), np.uint32)),
            _Ref(np.zeros((6 * L, 1, B), np.uint32)),
        )
    limbs = np.stack([np.stack([np.stack([np.stack(f[h][j][c]) for c in range(2)])
                                for j in range(3)]) for h in range(2)])[..., 0, :]
    return be.tw.f12_decode(torch.from_numpy(limbs.astype(np.int64)).to(torch.int32))


def test_check_strategy_runs_the_plain_check_with_the_reference_verdicts(bls, monkeypatch):
    spec, eng, be, g1s, g2s = bls
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    assert xP.shape[-1] == 4
    checks = []
    plain = pc.pairing_check

    def recorder(cfg, *args):
        checks.append(plain(cfg, *args))
        return checks[-1]

    monkeypatch.setattr(pc, "pairing_check", recorder)
    monkeypatch.setenv("MATHLIB_PAIR_FUSED", "check")
    assert be.pair.product_check(xP, yP, Qx, Qy, 2) is True
    assert be.pair.product_check(xP, yP, Qx, Qy, 1) is False
    assert len(checks) == 2
    for (ok, prod), n in zip(checks, (2, 1)):
        assert ok.dtype == torch.bool and ok.shape == ()
        assert prod.shape == (2, 3, 2, be.fp.L, 1) and prod.dtype == torch.int32
        assert bool(ok) == eng.gt_is_one(eng.final_exp(be.tw.f12_decode(prod)[0])), n

    # the default strategy: its host finish of these products (the default's
    # product_miller runs the same plain Miller loops and tree, so the same
    # limbs), and one whole default call through BatchEngine on the True set
    assert [be._host_finish_product(prod) for _, prod in checks] == [True, False]
    monkeypatch.delenv("MATHLIB_PAIR_FUSED")
    assert be.pairing_product_is_one(g1s[:2], g2s[:2]) is True

    # the unreduced products against the reference's Miller values, mod p
    host = be.tw.host
    ref = _ref_miller_values(be, *(t[..., :2].contiguous() for t in (xP, yP, Qx, Qy)))
    assert be.tw.f12_decode(checks[0][1])[0] == reduce(host.f12_mul, ref)
    assert be.tw.f12_decode(checks[1][1])[0] == ref[0]


@pytest.mark.parametrize("entry", ["product", "bls_verify"])
def test_batch_entry_points_reach_pairing_check_under_check(bls, monkeypatch, entry):
    """``pairing_product_is_one`` and ``bls_verify_batch`` under ``check``
    launch the one-launch check and no other pairing kernel: a recorder
    stands in for ``pairing_check`` (whose values the test above holds)."""
    spec, eng, be, g1s, g2s = bls
    calls = []
    one = be.tw.f12_one.to(torch.int32)

    def recorder(cfg, xP, yP, Qx, Qy, nvalid):
        calls.append((xP.shape[-1], nvalid))
        return torch.tensor(True), one

    def forbidden(*a, **k):
        raise AssertionError("a split-strategy kernel ran under check")

    monkeypatch.setattr(pc, "pairing_check", recorder)
    for name in ("miller_lanes", "f12_seg_product", "final_exp"):
        monkeypatch.setattr(pc, name, forbidden)
    monkeypatch.setattr(be.host, "final_exp", forbidden)
    monkeypatch.setenv("MATHLIB_PAIR_FUSED", "check")
    if entry == "product":
        assert be.pairing_product_is_one(g1s, g2s) is True
        assert calls == [(4, 4)]
    else:
        sk = 12345
        pk = eng.g2.mul(eng.gen_g2, sk)
        monkeypatch.setattr(be, "_device_hash_ctx", lambda: None)  # the host hasher: no kernels
        dst = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
        from mathlib_tpu_torch.host.hash_to_curve import get_hasher

        msgs = [b"m-0", b"m-1"]
        sigs = [eng.g1.mul(get_hasher(spec).hash_to_g1(m, dst), sk) for m in msgs]
        monkeypatch.setattr(be, "g1_msm", lambda pts, ks, c=None: pts[0])
        assert be.bls_verify_batch(pk, sigs, msgs, dst) is True
        assert calls == [(2, 2)]


def test_pairing_check_refuses_what_the_kernel_does_not_take():
    """A device other than the CPU or a card, odd L (FP256BN) and a BN curve
    raise ValueError before any launch."""
    from mathlib_tpu_torch.ops.pairing import PairingCtx

    pc.reset_launches()
    spec = get_spec("BLS12_381")
    cfg, L = PairingCtx(spec, "cpu").cfg, 24
    meta = {"device": "meta", "dtype": torch.int32}
    x, q = torch.empty((L, 4), **meta), torch.empty((2, L, 4), **meta)
    with pytest.raises(ValueError):
        pc.pairing_check(cfg, x, x, q, q, 4)
    fp256 = PairingCtx(get_spec("FP256BN"), "cpu").cfg  # L = 17
    x17, q17 = torch.empty((17, 4), **meta), torch.empty((2, 17, 4), **meta)
    with pytest.raises(ValueError, match="L = 16, 18 or 24"):
        pc.pairing_check(fp256, x17, x17, q17, q17, 4)
    bn = PairingCtx(get_spec("BN254"), "cpu").cfg
    x16, q16 = torch.zeros((16, 1), dtype=torch.int32), torch.zeros((2, 16, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="BLS12"):
        pc.pairing_check(bn, x16, x16, q16, q16, 1)
    assert set(pc.launches().values()) == {0}
