"""The port's pairing-product check against the JAX package, on the CPU.

* ``miller_lanes`` (plain version) against the reference kernel body
  ``pairing_pallas._miller_conj_tail`` + ``_mask_pad_to_one``, run on numpy
  rows through the stand-ins of ``tests/test_pairing_pallas.py``: bit-equal
  limbs.  The loop runs over a prefix of the curve's loop bits (both sides
  get the same bits): every iteration runs the same steps, and the whole loop
  is held to the host pairing below and, on the card, to this plain version.
* ``f12_seg_product`` (plain version) against the host tower's product of
  the decoded lanes, canonically.
* ``BatchEngine(device="cpu")``'s verdicts and reduced products against the
  reference's pure-Python ``HostEngine``, and its ``_encode_pairs`` against
  the reference ``BatchEngine._encode_pairs``, word for word.

Nothing here jits the reference's pairing, Miller loop or final exp.
"""

from functools import reduce

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.fp_rows as ref_fp_rows
import mathlib_tpu.ops.kernels.pairing_pallas as ref_pp
from mathlib_tpu.batch import BatchEngine as RefBatchEngine
from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host.engine import HostEngine as RefHostEngine
from mathlib_tpu.ops.pairing import PairingCtx as RefPairingCtx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine, get_batch_engine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.field import ints_to_limbs
from mathlib_tpu_torch.ops.kernels.tower_rows import RowTower, mults_per_step
from mathlib_tpu_torch.ops.pairing import PairingCtx
from mathlib_tpu_torch.ops.tower import TowerCtx
from test_pairing_pallas import _FakeJax, _FakePl, _FakePltpu, _Ref

torch.set_num_threads(1)

LOOP_PREFIX = 5  # loop bits of the shim comparison


def _rand_pairs(eng, spec, n, seed):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(2 * n)]
    return ([eng.g1.mul(eng.gen_g1, k) for k in ks[:n]],
            [eng.g2.mul(eng.gen_g2, k) for k in ks[n:]])


@pytest.fixture
def numpy_pallas(monkeypatch):
    """The reference kernel bodies on numpy rows (as test_pairing_pallas)."""
    monkeypatch.setattr(ref_fp_rows, "jnp", np)
    monkeypatch.setattr(ref_pp, "jnp", np)
    monkeypatch.setattr(ref_pp, "pl", _FakePl)
    monkeypatch.setattr(ref_pp, "jax", _FakeJax)
    monkeypatch.setattr(ref_pp, "pltpu", _FakePltpu)
    monkeypatch.setattr(ref_pp, "MUL_CHUNK", 1 << 12)  # one stacked product a batch


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_miller_lanes_plain_is_bit_equal_to_the_reference_body(curve, numpy_pallas):
    spec = get_spec(curve)
    ref = RefPairingCtx(ref_get_spec(curve))
    pair = PairingCtx(spec, "cpu")
    B, n = 4, 3  # one pad lane
    g1s, g2s = _rand_pairs(get_engine(spec), spec, B, 1)
    be = BatchEngine(spec, "cpu")
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    L = be.fp.L
    bits = np.asarray(ref.loop_bits[:LOOP_PREFIX], dtype=np.uint32)
    assert bits.any() and list(pair.loop_bits) == list(ref.loop_bits)
    assert (pair.conj_end, pair.bn_tail) == (ref.conj_end, ref.bn_tail)

    p, L_ref, n_beta, xi0, twist = ref_pp._cfg(ref_get_spec(curve))
    assert (L_ref, n_beta, xi0, twist) == (L, pair.cfg.tower.n, pair.cfg.tower.xi0,
                                           pair.cfg.tower.twist)
    tw = ref_pp.RowTower(p, L, n_beta, xi0, twist)
    tail = None
    if ref.bn_tail:
        consts = (ref.cx1, ref.cy1, ref.cx2, ref.cy2)
        assert consts == pair.cfg.tail
        tail = tuple((ref_pp._mont_limbs(p, L, c0), ref_pp._mont_limbs(p, L, c1))
                     for c0, c1 in consts)

    def rows(t):  # (..., L, B) int32 -> (K*L, 1, B) uint32
        return t.numpy().astype(np.uint32).reshape(-1, 1, B)

    f = ref_pp._miller_conj_tail(
        tw, len(bits), ref.conj_end, tail, _Ref(bits), _Ref(rows(xP)), _Ref(rows(yP)),
        _Ref(rows(Qx)), _Ref(rows(Qy)), _Ref(np.zeros((12 * L, 1, B), np.uint32)),
        _Ref(np.zeros((6 * L, 1, B), np.uint32)),
    )
    f = ref_pp._mask_pad_to_one(tw, f, np.arange(B)[None, :] < n)
    want = np.stack([np.stack([np.stack([np.stack(f[h][j][c]) for c in range(2)])
                               for j in range(3)]) for h in range(2)])[..., 0, :]

    cfg = pc.MillerCfg(pair.cfg.tc, bits.astype(np.uint8), pair.conj_end, pair.cfg.tail)
    got = pc.miller_lanes(cfg, xP, yP, Qx, Qy, n)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 2, L, B)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seg", [1, 2, 4, 8])
def test_f12_seg_product_is_the_host_product(seg):
    spec = get_spec("BLS12_381")
    tw = TowerCtx(spec, "cpu")
    cfg = PairingCtx(spec, "cpu").cfg
    host = tw.host
    rng = np.random.default_rng(seg)
    B = 8

    def rand():
        return int.from_bytes(rng.bytes(64), "big") % spec.p

    vals = [tuple(tuple((rand(), rand()) for _ in range(3)) for _ in range(2)) for _ in range(B)]
    # Montgomery limbs, every third lane relaxed to x + p (as valid as x)
    R, L = tw.fp.R, tw.fp.L
    flat = [c for v in vals for f6 in v for f2 in f6 for c in f2]  # lane-major
    mont = [c * R % spec.p + (spec.p if i // 12 % 3 == 0 else 0) for i, c in enumerate(flat)]
    arr = np.moveaxis(ints_to_limbs(mont, L).reshape(B, 2, 3, 2, L), 0, -1)
    f = torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32))
    got = pc.f12_seg_product(cfg, f, seg)
    assert got.shape == (2, 3, 2, tw.fp.L, B // seg) and got.dtype == torch.int32
    want = [reduce(host.f12_mul, vals[k * seg : (k + 1) * seg]) for k in range(B // seg)]
    assert tw.f12_decode(got) == want
    with pytest.raises(ValueError):
        pc.f12_seg_product(cfg, f, 3)


@pytest.fixture(scope="module")
def bls_engine():
    spec = get_spec("BLS12_381")
    return spec, BatchEngine(spec, "cpu"), get_engine(spec)


def test_product_check_verdicts_and_values_match_the_reference(bls_engine):
    spec, be, eng = bls_engine
    ref = RefHostEngine(ref_get_spec("BLS12_381"))
    P = eng.g1.mul(eng.gen_g1, 12345)
    G, Q = eng.gen_g2, eng.g2.mul(eng.gen_g2, 777)
    a, b = 1234567, 7654321
    # e(a g1, b g2) e(-ab g1, g2) = 1
    g1s = [eng.g1.mul(eng.gen_g1, a), eng.g1.mul(eng.gen_g1, -a * b % spec.r)]
    g2s = [eng.g2.mul(G, b), G]
    assert be.pairing_product_is_one(g1s, g2s) is True  # through the async resolver

    # with (P, Q) beside them (3 lanes, the tree pads to 4) the product is
    # e(P, Q): the check fails, and the reduced product equals the
    # reference host engine's pairing
    prod = be.pair.product_miller(*be._pair_split_mont(be._encode_pairs(g1s + [P], g2s + [Q])))
    assert prod.shape == (2, 3, 2, be.fp.L, 1)
    assert be._host_finish_product(prod) is False
    assert eng.final_exp(be.tw.f12_decode(prod)[0]) == ref.pairing(P, Q)


def test_grouped_checks_give_the_known_verdicts(bls_engine):
    spec, be, eng = bls_engine
    P = eng.g1.mul(eng.gen_g1, 99)
    nP = eng.g1.neg(P)
    G, Q = eng.gen_g2, eng.g2.mul(eng.gen_g2, 5)
    # four groups of 4 (the host final exps run on the thread pool)
    g1s = [P, nP, P, nP] + [P, P, P, nP] + [P, nP, P, nP] + [P, nP, nP, P]
    g2s = [G] * 4 + [Q, G, G, G] + [G] * 4 + [Q, Q, G, G]
    assert be.pairing_products_are_one(g1s, g2s, 4) == [True, False, True, True]
    for bad in (3, 0, 2048):
        with pytest.raises(ValueError):
            be.pairing_products_are_one(g1s, g2s, bad)
    with pytest.raises(ValueError):
        be.pairing_products_are_one(g1s[:6], g2s[:6], 4)


def test_grouped_checks_of_three_pairs_run_one_check_per_group(bls_engine):
    """A group size that is not a power of two (a BBS+-style three-pair
    check) runs one product check per group, as the reference does: 12
    pairs, group_size=3, four known verdicts."""
    spec, be, eng = bls_engine
    A, B = eng.g1.mul(eng.gen_g1, 7), eng.g1.mul(eng.gen_g1, 11)
    C = eng.g1.neg(eng.g1.add(A, B))  # e(A, G) e(B, G) e(C, G) == 1
    G, Q = eng.gen_g2, eng.g2.mul(eng.gen_g2, 3)
    g1s = [A, B, C] * 4
    g2s = [G, G, G] + [G, G, Q] + [G, G, G] + [Q, G, G]
    assert be.pairing_products_are_one(g1s, g2s, 3) == [True, False, True, False]
    for bad in (0, 5, 24):  # zero, and sizes that do not divide 12
        with pytest.raises(ValueError):
            be.pairing_products_are_one(g1s, g2s, bad)


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_encode_pairs_equals_the_reference_word_for_word(curve):
    spec = get_spec(curve)
    eng = get_engine(spec)
    g1s, g2s = _rand_pairs(eng, spec, 5, 3)
    got = BatchEngine(spec, "cpu")._encode_pairs(g1s, g2s)
    want = np.asarray(RefBatchEngine(ref_get_spec(curve))._encode_pairs(g1s, g2s))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_empty_pairing_batch_returns_an_empty_list(curve):
    """As the reference does: ``mathlib_tpu.batch.BatchEngine(get_spec(
    "BLS12_381")).pairing_batch([], [])`` returns ``[]`` (building the
    reference engine takes about a minute, so its answer is written here).
    Lists of different lengths still raise."""
    be = BatchEngine(get_spec(curve), "cpu")
    assert be.pairing_batch([], []) == []
    with pytest.raises(ValueError):
        be.pairing_batch([], [be.spec.g2_gen])


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
@pytest.mark.parametrize("strategy", [None, "device"])
@pytest.mark.parametrize("group_size", [1, 2])
def test_empty_grouped_checks_return_an_empty_list(curve, strategy, group_size, monkeypatch):
    """No pairs give no verdicts, as the reference's ``pairing_products_are_one``
    gives (G = 0 groups), under both ``MATHLIB_GROUP_FEXP`` strategies."""
    if strategy is None:
        monkeypatch.delenv("MATHLIB_GROUP_FEXP", raising=False)
    else:
        monkeypatch.setenv("MATHLIB_GROUP_FEXP", strategy)
    be = get_batch_engine(get_spec(curve), "cpu")
    assert be.pairing_products_are_one([], [], group_size) == []


def test_final_exp_of_no_lanes_is_a_zero_lane_tensor():
    tw = TowerCtx(get_spec("BLS12_381"), "cpu")
    empty = tw.f12_final_exp(tw.f12_one[..., :0])
    assert empty.shape == (2, 3, 2, tw.fp.L, 0) and empty.dtype == torch.int32


def test_pairing_kernels_refuse_what_they_do_not_take():
    """On a tensor that is neither on the CPU nor usable by the kernels the
    wrappers raise before any launch (here: the meta device)."""
    spec = get_spec("BLS12_381")
    cfg = PairingCtx(spec, "cpu").cfg
    L = cfg.fp.L
    meta = {"device": "meta", "dtype": torch.int32}
    with pytest.raises(ValueError):
        pc.miller_lanes(cfg, *(torch.empty(s, **meta) for s in
                               [(L, 4), (L, 4), (2, L, 4), (2, L, 4)]), 4)
    with pytest.raises(ValueError):
        pc.f12_seg_product(cfg, torch.empty((2, 3, 2, L, 4), **meta), 2)
    odd = get_spec("FP256BN")
    cfg_odd = PairingCtx(odd, "cpu").cfg
    with pytest.raises(ValueError, match="L = 16 or 24"):
        pc.f12_seg_product(cfg_odd, torch.empty((2, 3, 2, cfg_odd.fp.L, 4), **meta), 2)


def test_row_tower_counts_the_products_it_queues():
    """``mults_per_step`` (the basis of the kernels' operation counts) is what
    the plain tower queues, on an M-twist curve with n = 1 and on BLS12-377
    (D-twist, n = 5)."""
    for curve in ("BLS12_381", "BLS12_377"):
        spec = get_spec(curve)
        cfg = PairingCtx(spec, "cpu").cfg
        tw: RowTower = cfg.tower
        counted = []
        mont = tw.fp._mont_mul64

        def counting(a, b, _m=mont):
            counted.append(a.shape[0])
            return _m(a, b)

        tw.fp._mont_mul64 = counting
        try:
            one = tw.f12_one_like(1, "cpu")
            f2 = one[0, 0]
            T = torch.stack([f2, f2, f2], dim=-4)
            x = tw.one
            want = mults_per_step(tw.n, tw.twist)
            for name, run in (
                ("f12_sqr", lambda: tw.f12_sqr(one)),
                ("f12_mul", lambda: tw.f12_mul(one, one)),
                ("f12_sparse_mul", lambda: tw.f12_sparse_mul(one, f2, f2, f2)),
                ("dbl_step", lambda: tw.dbl_step(T, x, x)),
                ("add_step", lambda: tw.add_step(T, f2, f2, x, x)),
            ):
                counted.clear()
                run()
                assert sum(counted) == want[name], (curve, name)
        finally:
            del tw.fp._mont_mul64
