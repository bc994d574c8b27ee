"""The MSM options of the port (signed digits, affine points and the mixed
add, the GLV split), the host bridge and ``BatchEngine``'s G1 entry points,
against the port's host engine (exact).

The reference's ``msm``, ``bucket_table`` and ``msm_host_bridge`` are not
jitted here for these options: one such compile costs more than this whole
file.  Instead the bucket tables are held, bucket by bucket, to host sums
of the points each bucket must hold (canonical values), the window totals
to the host's weighted sums, and each MSM to the host engine's.  The
combiners underneath are held to the reference limb for limb in
``test_torch_g1_options.py``.  c = 4, K = 4 at n = 16 with colliding digits
(long segments and cross-chunk carries) and an infinity input.
"""

import random

import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine, get_batch_engine
from mathlib_tpu_torch.curves.params import CurveID
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops import msm
from mathlib_tpu_torch.ops.g1 import G1Ctx

torch.set_num_threads(1)

C, K, N = 4, 4, 16


@pytest.fixture(scope="module")
def env():
    spec = get_spec("BLS12_381")
    return get_engine(spec), G1Ctx(spec, "cpu")


def _inputs(eng, n, seed):
    """n points from 5 distinct ones (one infinity input) and scalars whose
    every other digit collides."""
    rng = random.Random(seed)
    r = eng.spec.r
    base = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(5)]
    pts = [base[rng.randrange(5)] for _ in range(n)]
    pts[3] = None
    ks = [rng.randrange(r) for _ in range(n)]
    for i in range(0, n, 2):
        ks[i] = rng.randrange(4) * sum(1 << (C * w) for w in range(0, 63, 5))
    return pts, ks


def _host_msm(eng, pts, ks):
    keep = [(P, k) for P, k in zip(pts, ks) if P is not None]
    return eng.g1.msm([P for P, _ in keep], [k for _, k in keep])


def _host_digits(k, nwin, signed):
    """Window digits of k as signed ints (the balanced recoding when signed)."""
    out, carry = [], 0
    for w in range(nwin):
        t = ((k >> (C * w)) & ((1 << C) - 1)) + carry
        carry = int(signed and t > 1 << (C - 1))
        out.append(t - (carry << C))
    return out + ([carry] if signed else [])


def _host_buckets(eng, pts, ks, nwin, signed):
    """bucket[w][b]: the host sum of the points (negated for negative
    digits) whose window-w digit owns bucket b."""
    B, lo = (1 << (C - 1), 1) if signed else (1 << C, 0)
    out = [[None] * B for _ in range(nwin + signed)]
    for P, k in zip(pts, ks):
        for w, d in enumerate(_host_digits(k, nwin, signed)):
            if P is not None and lo <= abs(d) < lo + B:
                out[w][abs(d) - lo] = eng.g1.add(out[w][abs(d) - lo], eng.g1.neg(P) if d < 0 else P)
    return out


@pytest.mark.parametrize("signed,affine", [(True, False), (False, True), (True, True)],
                         ids=["signed", "mixed", "signed-mixed"])
def test_bucket_tables_and_msm_equal_the_host(env, signed, affine):
    eng, g1 = env
    pts, ks = _inputs(eng, N, seed=1)
    P = g1.encode_points_affine(pts) if affine else g1.encode_points(pts)
    # affine callers zero the scalars of infinity inputs: (0, 0) is no point
    ks_in = [0 if Q is None else k for Q, k in zip(pts, ks)] if affine else ks
    S = g1.encode_scalars(ks_in)
    nwin = msm.n_windows(g1, C)
    table = msm.bucket_table(g1, P, S, C, signed=signed, K=K)
    W = msm.n_windows(g1, C, signed=signed, nbits=g1.nbits)  # r < 2^255: no carry window
    want = _host_buckets(eng, pts, ks_in, nwin, signed)
    assert all(x is None for row in want[W:] for x in row)
    want = want[:W]
    assert table.shape == (3, g1.fp.L, W, len(want[0]))
    got = g1.decode_points(table.movedim(-2, 0).reshape(W, 3, g1.fp.L, -1))
    flat_want = [x for row in want for x in row]
    lo = 0 if signed else 1  # unsigned bucket 0 holds digit 0: computed, never read
    assert [x for i, x in enumerate(got) if i % len(want[0]) >= lo] == [
        x for i, x in enumerate(flat_want) if i % len(want[0]) >= lo]
    totals = msm.window_totals(g1, table, C, signed=signed)
    host_tot = [None] * W
    for w, row in enumerate(want):
        for b, Sb in enumerate(row):
            if Sb is not None:
                host_tot[w] = eng.g1.add(host_tot[w], eng.g1.mul(Sb, b + (1 if signed else 0)))
    assert g1.decode_points(totals) == host_tot
    assert msm.horner_host(g1, totals, C) == _host_msm(eng, pts, ks)


@pytest.mark.parametrize("signed,affine", [(False, False), (True, True)], ids=["glv", "glv-signed-mixed"])
def test_glv_msm_equals_the_host(env, signed, affine):
    eng, g1 = env
    pts, ks = _inputs(eng, N, seed=2)
    ks[5] = eng.spec.r - 1
    if affine:
        P, ks_in = g1.encode_points_affine(pts), [0 if Q is None else k for Q, k in zip(pts, ks)]
    else:  # projective: msm zeroes the scalar of the infinity input itself
        P, ks_in = g1.encode_points(pts), ks
    totals = msm.msm_totals(g1, P, g1.encode_scalars(ks_in), c=C, K=K, signed=signed, glv=True)
    assert totals.shape[-1] == msm.n_windows(g1, C, signed, nbits=128)
    assert msm.horner_host(g1, totals, C) == _host_msm(eng, pts, ks)


def test_host_bridge_pads_and_equals_the_host(env):
    eng, g1 = env
    spec = eng.spec
    rng = random.Random(3)
    pts = [eng.g1.mul(eng.gen_g1, rng.randrange(1, spec.r)) for _ in range(70)]
    pts[5] = pts[40] = None
    ks = [rng.randrange(spec.r) for _ in range(70)]
    assert msm.auto_window(128, g1.nbits) == C and msm.auto_glv(spec, 128)
    assert msm.msm_host_bridge(spec, pts, ks, device="cpu") == _host_msm(eng, pts, ks)
    assert not msm.auto_glv(get_spec("BN254"), 64) and not msm.auto_glv(spec, (1 << 17) + 1)


def test_batch_engine_g1_entry_points_equal_the_host(env):
    eng, _ = env
    spec = eng.spec
    be = BatchEngine.for_curve(CurveID.BLS12_381_BBS, device="cpu")
    assert be is get_batch_engine(spec, "cpu") and be.spec is spec
    assert be._msm_params(16, None, None) == (C, True)
    rng = random.Random(4)
    pts = [eng.g1.mul(eng.gen_g1, rng.randrange(1, spec.r)) for _ in range(12)] + [None]
    ks = [rng.randrange(spec.r) for _ in range(13)]
    assert be.g1_msm(pts, ks) == _host_msm(eng, pts, ks)  # GLV, through g1_msm_device
    got = be.g1_scalar_mul(pts[:3] + [None], [ks[0], 0, spec.r - 1, 5])
    assert got == [eng.g1.mul(pts[0], ks[0]), None, eng.g1.neg(pts[2]), None]
    bn = BatchEngine.for_curve(CurveID.BN254, device="cpu")
    assert bn.spec is get_spec("BN254") and bn._msm_params(16, None, None) == (C, False)
    with pytest.raises(ValueError):  # the GLV split takes BLS12 curves only
        bn.g1_msm([bn.spec.g1_gen], [1], glv=True)
