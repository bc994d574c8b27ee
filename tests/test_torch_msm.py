"""The port's MSM main path (mathlib_tpu_torch.ops.msm) against the reference.

The slice as a whole: ``msm_totals`` + ``horner_host`` at c=4 on BLS12-381,
with K=4 at n=16 with colliding digits (long segments and cross-chunk
carries) and with the default K=64 at n=64, plus the ``_limit`` split path.
The port runs on the CPU (each kernel's plain version); the reference on
XLA:CPU.  Both sort stably, so bucket tables and window totals must be equal
limb for limb (tolerance: zero), and the Horner result must equal the host
engine's MSM.

A single ``jax.jit`` of the reference's window-sum tail compiles for over a
minute on XLA:CPU (it unrolls ~20 point additions), so the reference's
``window_totals`` and ``sum_reduce`` run eagerly here, with the point
additions and doublings outside the scans each compiled once at a fixed lane
count (``_FixedLaneG1``).  The reference's bucket table is jitted once per
(n, K) shape, and the split path reuses the n=16 compilation for its halves.
It is the reference's own code and arithmetic; only the XLA program
boundaries move.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.host.engine import get_engine
from mathlib_tpu.ops import msm as ref_msm
from mathlib_tpu.ops.g1 import get_g1_ctx
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops import msm
from mathlib_tpu_torch.ops.g1 import G1Ctx

torch.set_num_threads(1)

C = 4


class _FixedLaneG1:
    """The reference G1Ctx with ``add``/``double`` compiled once each at
    ``lanes`` lanes: operands (3, L, n) are zero-padded to a multiple of that
    width, run a slice at a time, and cropped (lanes are independent)."""

    def __init__(self, g1, lanes: int):
        self._g1 = g1
        self._lanes = lanes
        self._add = jax.jit(g1.add)
        self._double = jax.jit(g1.double)

    def __getattr__(self, name):
        return getattr(self._g1, name)

    def _fixed(self, fn, *pts):
        n, w = pts[0].shape[-1], self._lanes
        pad = [(0, 0)] * (pts[0].ndim - 1) + [(0, -n % w)]
        pts = [jnp.pad(p, pad) for p in pts]
        outs = [fn(*[p[..., i : i + w] for p in pts]) for i in range(0, n, w)]
        return jnp.concatenate(outs, axis=-1)[..., :n]

    def add(self, P, Q):
        return self._fixed(self._add, P, Q)

    def double(self, P):
        return self._fixed(self._double, P)


@pytest.fixture(scope="module")
def env():
    spec = get_spec("BLS12_381")
    ref = get_g1_ctx(spec)
    W = ref_msm.n_windows(ref, C)
    return get_engine(spec), ref, G1Ctx(spec, "cpu"), _FixedLaneG1(ref, W << (C - 1))


@pytest.fixture(scope="module")
def ref_table():
    """The reference's bucket_table, jitted once per (n, K) shape."""
    spec = get_spec("BLS12_381")
    ref = get_g1_ctx(spec)
    fn = jax.jit(lambda p, s, K: ref_msm.bucket_table(ref, p, s, C, K=K), static_argnums=2)
    return lambda P, S, K: np.asarray(fn(jnp.asarray(P), jnp.asarray(S), K))


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
def test_msm_totals_match_reference(env, ref_table, n, K, collide):
    eng, ref, port, ref_fixed = env
    pts, ks = _inputs(eng, n, seed=n, collide=collide)
    P, S = ref.encode_points(pts), ref.encode_scalars(ks)

    want_table = ref_table(P, S, K)
    table = msm.bucket_table(port, to_torch(P, "cpu"), to_torch(S, "cpu"), C, K=K)
    np.testing.assert_array_equal(to_numpy(table), want_table)

    ref_totals = np.asarray(ref_msm.window_totals(ref_fixed, jnp.asarray(want_table), C))
    totals = msm.msm_totals(port, to_torch(P, "cpu"), to_torch(S, "cpu"), c=C, K=K)
    np.testing.assert_array_equal(to_numpy(totals), ref_totals)
    assert port.decode_points(totals) == ref.decode_points(ref_totals)

    want = _host_msm(eng, pts, ks)
    assert msm.horner_host(port, totals, C) == want
    assert ref_msm.horner_host(ref, ref_totals, C) == want


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
    _, _, port, _ = env
    P = port.gen.expand(3, port.fp.L, 4)
    S = port.encode_scalars([1, 2, 3, 4])
    for kwargs in ({"signed": True}, {"glv": True}, {"capture": "scatter"}):
        with pytest.raises(NotImplementedError):
            msm.msm_totals(port, P, S, c=C, **kwargs)
    with pytest.raises(NotImplementedError):
        msm.msm_totals(port, P[:2], S, c=C)  # affine (2, L, N) points
    with pytest.raises(NotImplementedError):
        msm.window_totals(port, msm.bucket_table(port, P, S, c=C), C, signed=True)
    with pytest.raises(ValueError):
        msm.bucket_table(port, P, S, c=3)

