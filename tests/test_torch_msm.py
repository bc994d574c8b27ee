"""The port's MSM main path (mathlib_tpu_torch.ops.msm) against the reference.

The slice as a whole: ``msm_totals`` + ``horner_host`` at c=4 on BLS12-381,
with K=4 at n=16 with colliding digits (long segments and cross-chunk
carries) and with the default K=64 at n=64, plus the ``_limit`` split path.
The port runs on the CPU (each kernel's plain version); the reference on
XLA:CPU.  Both sort stably, so bucket tables and window totals must be equal
limb for limb (tolerance: zero), and the Horner result must equal the host
engine's MSM.

A ``jax.jit`` of the reference's MSM compiles its point additions for
minutes on XLA:CPU, so here the reference's point arithmetic runs as its
Pallas kernel bodies on numpy rows (``BodyG1`` of
``tests/_torch_ref_bodies.py``: the XLA path's RCB formulas in the same
operation order, so the same limbs), reached from the reference's jitted
``bucket_table`` and ``window_totals`` through ``jax.pure_callback``: XLA
compiles only the sorts, gathers and scans.  The bucket table is jitted once
per (n, K) shape, and the split path reuses the n=16 compilation for its
halves.  It is the reference's own code and arithmetic; only the program
boundaries move.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref_bodies import BodyG1
from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.host.engine import get_engine
from mathlib_tpu.ops import msm as ref_msm
from mathlib_tpu.ops.g1 import get_g1_ctx
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops import msm
from mathlib_tpu_torch.ops.g1 import G1Ctx

torch.set_num_threads(1)

C = 4


@pytest.fixture(scope="module")
def env():
    spec = get_spec("BLS12_381")
    ref = get_g1_ctx(spec)
    return get_engine(spec), ref, G1Ctx(spec, "cpu"), BodyG1(ref)


@pytest.fixture(scope="module")
def ref_table(env):
    """The reference's bucket_table, jitted once per (n, K) shape, its point
    arithmetic on the numpy bodies."""
    fn = jax.jit(lambda p, s, K: ref_msm.bucket_table(env[3], p, s, C, K=K), static_argnums=2)
    return lambda P, S, K: np.asarray(fn(jnp.asarray(P), jnp.asarray(S), K))


@pytest.fixture(scope="module")
def ref_totals(env):
    """The reference's window_totals, jitted once, on the numpy bodies."""
    fn = jax.jit(lambda t: ref_msm.window_totals(env[3], t, C))
    return lambda table: np.asarray(fn(jnp.asarray(table)))


def _inputs(eng, n, seed, collide):
    rng = random.Random(seed)
    r = eng.spec.r
    base = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(5)]
    pts = [base[rng.randrange(5)] for _ in range(n)]
    pts[3] = None
    ks = [rng.randrange(r) for _ in range(n)]
    if collide:  # few distinct digits per window: long segments across chunks
        for i in range(0, n, 2):
            ks[i] = rng.randrange(4) * sum(1 << (C * w) for w in range(0, 63, 5))
    return pts, ks


def _host_msm(eng, pts, ks):
    keep = [(P, k) for P, k in zip(pts, ks) if P is not None]
    return eng.g1.msm([P for P, _ in keep], [k for _, k in keep])


# (n, K): K=4 at n=16 gives C=4 chunks per window, so segments cross chunk
# boundaries; n=64 with the default K=64 is one chunk per window
CASES = [(16, 4, True), (64, 64, False)]


@pytest.mark.parametrize("n,K,collide", CASES, ids=["n16-K4-collide", "n64-K64"])
def test_msm_totals_match_reference(env, ref_table, ref_totals, n, K, collide, monkeypatch):
    eng, ref, port, ref_fixed = env
    pts, ks = _inputs(eng, n, seed=n, collide=collide)
    P, S = ref.encode_points(pts), ref.encode_scalars(ks)

    # msm_totals runs the scan once; the bucket table it builds is recorded
    # on its way to window_totals and held to the reference's too
    tables = []
    bucket_table = msm.bucket_table
    monkeypatch.setattr(msm, "bucket_table",
                        lambda *a, **k: tables.append(bucket_table(*a, **k)) or tables[-1])
    totals = msm.msm_totals(port, to_torch(P, "cpu"), to_torch(S, "cpu"), c=C, K=K)
    want_table = ref_table(P, S, K)
    assert len(tables) == 1
    np.testing.assert_array_equal(to_numpy(tables[0]), want_table)

    want_totals = ref_totals(want_table)
    np.testing.assert_array_equal(to_numpy(totals), want_totals)
    assert port.decode_points(totals) == ref.decode_points(want_totals)

    want = _host_msm(eng, pts, ks)
    assert msm.horner_host(port, totals, C) == want
    assert ref_msm.horner_host(ref, want_totals, C) == want


def test_scan_writes_each_step_into_the_capture_buffer(env, ref_table, monkeypatch):
    """The unsigned scan hands add_select each step of its (K, 3, L, W*C)
    capture buffer as out= (K consecutive steps, none copied), and the bucket
    table that comes out is the reference's."""
    eng, ref, port, _ = env
    n, K = 16, 4
    pts, ks = _inputs(eng, n, seed=n, collide=True)
    P, S = ref.encode_points(pts), ref.encode_scalars(ks)
    outs = []
    add_select = port.add_select

    def recording(P_, Q_, sel, out=None):
        outs.append(out)
        got = add_select(P_, Q_, sel, out=out)
        assert out is None or got is out
        return got

    monkeypatch.setattr(port, "add_select", recording)
    table = msm.bucket_table(port, to_torch(P, "cpu"), to_torch(S, "cpu"), C, K=K,
                             capture="dense")
    np.testing.assert_array_equal(to_numpy(table), ref_table(P, S, K))
    steps = outs[:K]  # the scan's; the chunk-summary scans follow without out=
    assert all(o is not None for o in steps) and all(o is None for o in outs[K:])
    stride = steps[0].numel() * steps[0].element_size()
    assert [o.data_ptr() - steps[0].data_ptr() for o in steps] == [s * stride for s in range(K)]


def test_split_path_matches_reference(env, ref_table):
    eng, ref, port, ref_fixed = env
    n, K = 32, 4
    pts, ks = _inputs(eng, n, seed=9, collide=True)
    P, S = ref.encode_points(pts), ref.encode_scalars(ks)
    # a budget this small splits n=32 into two halves of 16 (and no further).
    # The reference's split is the pointwise add of its halves' tables; the
    # halves reuse the n=16, K=4 compilation of test_msm_totals_match_reference.
    limit = 1 << 16
    halves = [ref_table(P[..., i : i + n // 2], S[..., i : i + n // 2], K) for i in (0, n // 2)]
    L, W, B = halves[0].shape[1:]
    flat = [jnp.asarray(t.reshape(3, L, W * B)) for t in halves]
    want = np.asarray(ref_fixed.add(*flat)).reshape(3, L, W, B)
    table = msm.bucket_table(port, to_torch(P, "cpu"), to_torch(S, "cpu"), C, K=K, _limit=limit)
    np.testing.assert_array_equal(to_numpy(table), want)
    assert msm.horner_host(port, msm.window_totals(port, table, C), C) == _host_msm(eng, pts, ks)


@pytest.mark.parametrize("n", [8, 7])
def test_sum_reduce_matches_reference(env, n):
    eng, ref, port, ref_fixed = env
    pts, _ = _inputs(eng, 8, seed=12, collide=False)
    P = ref.encode_points(pts[:n])
    want = np.asarray(type(ref).sum_reduce(ref_fixed, jnp.asarray(P)))
    np.testing.assert_array_equal(to_numpy(port.sum_reduce(to_torch(P, "cpu"))), want)


def test_device_horner_and_naive_oracle(env):
    eng, ref, port, _ = env
    pts, ks = _inputs(eng, 8, seed=11, collide=False)
    P, S = port.encode_points(pts), port.encode_scalars(ks)
    want = _host_msm(eng, pts, ks)
    assert port.decode_point(msm.msm(port, P, S, c=C)) == want
    assert port.decode_point(msm.msm_naive(port, P, S)) == want


def test_digits_windows_and_auto_window_match_reference(env):
    _, ref, port, _ = env
    rng = random.Random(4)
    S = ref.encode_scalars([rng.randrange(ref.spec.r) for _ in range(9)])
    for c in (4, 8, 16):
        nwin = ref_msm.n_windows(ref, c)
        assert msm.n_windows(port, c) == nwin
        want = np.asarray(ref_msm._digits(jnp.asarray(S), c, nwin))
        np.testing.assert_array_equal(to_numpy(msm._digits(to_torch(S, "cpu"), c, nwin)), want)
    for n in (1, 64, 1 << 12, 1 << 16, 1 << 20):
        assert msm.auto_window(n) == ref_msm.auto_window(n)


def test_unported_options_raise(env):
    """What stays unported: the in-scan scatter capture, and a window width
    that does not divide 16 (as in the reference)."""
    _, _, port, _ = env
    P = port.gen.expand(3, port.fp.L, 4)
    S = port.encode_scalars([1, 2, 3, 4])
    for fn in (msm.msm_totals, msm.bucket_table, msm.msm):
        with pytest.raises(NotImplementedError):
            fn(port, P, S, c=C, capture="scatter")
        with pytest.raises(ValueError):
            fn(port, P, S, c=3)
    with pytest.raises(ValueError):  # an unsigned table is not a signed one
        msm.window_totals(port, msm.bucket_table(port, P, S, c=C), C, signed=True)
