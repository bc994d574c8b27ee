"""The G1 options of the port against the reference, limb for limb
(tolerance: zero).

* The plain versions of the four kernels of this slice (``dbladd``,
  ``addselneg``, ``maddsel``, ``maddselneg``) against the reference's Pallas
  kernel BODIES run on numpy rows (the ``Ref`` shim, as
  ``tests/test_pallas_kernels.py`` runs them), on BLS12-381, BN254 and
  BLS12-377, with the edge lanes P = inf, P = lift(Q), P = -lift(Q), relaxed [p, 2p) inputs
  and Q = (0, 0).  The mixed add follows ``_madd_rows``, whose relaxed limbs
  differ from the reference's XLA fallback (lift, then the full add); the
  XLA fallback is compared canonically.
* ``to_affine_rows``, ``eq``, the affine codecs and ``sum_reduce_axis``
  against the reference's; ``mul2`` against the reference host engine.
* ``_signed_digits``/``n_windows(signed)``, and ``GlvCtx`` (constants,
  ``split``, ``endo_points``) on BLS12-381 and BLS12-377.
* ``FpCtx.mont_mul`` and the G1 products reach the ``mont_mul`` wrapper;
  the plain versions of the kernels do not.

The reference's kernel bodies run on numpy rows (``tests/_torch_ref_bodies.py``),
also where its XLA code adds points (the reference's own code and
arithmetic; only the program boundaries move): no Pallas interpret mode,
no XLA compile of a point addition, and no jit of a whole reference MSM.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.g1_pallas as g1p_mod
from _torch_ref_bodies import BodyG1, Ref, numpy_bodies
from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host.engine import get_engine as ref_get_engine
from mathlib_tpu.ops import msm as ref_msm
from mathlib_tpu.ops.g1 import get_g1_ctx as ref_get_g1_ctx
from mathlib_tpu.ops.kernels.fp_rows import RowCtx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops import msm
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import fp_cuda, g1_cuda

torch.set_num_threads(1)

LANES = 8  # lanes of the affine, eq, mixed-add and GLV cases


def _ctx(name):
    spec = get_spec(name)
    return get_engine(spec), ref_get_g1_ctx(ref_get_spec(name)), G1Ctx(spec, "cpu")


def _edge_lanes(eng, seed, n=16):
    """n lanes of host points (P, Q): generic, P = inf, P = Q, P = -Q, and
    Q = inf on projective inputs."""
    rng = random.Random(seed)
    r = eng.spec.r
    pool = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(6)]
    P = [pool[rng.randrange(6)] for _ in range(n)]
    Q = [pool[rng.randrange(6)] for _ in range(n)]
    for off in range(0, n - 3, 8):
        P[off + 1] = None
        P[off + 2] = Q[off + 2]
        P[off + 3] = eng.g1.neg(Q[off + 3])
    return P, Q


def _masks(n, seed):
    rng = np.random.default_rng(seed)
    sel = rng.random(n) < 0.75
    neg = rng.random(n) < 0.5
    sel[0] = False
    for off in range(0, n - 3, 8):  # the edge lanes are added, with and without negation
        sel[off + 1 : off + 4] = True
        neg[off + 2 : off + 4] = off > 0
    return sel, neg


@pytest.mark.parametrize("name", ["BLS12_381", "BN254", "BLS12_377"])
def test_plain_kernels_equal_the_reference_bodies(name):
    eng, ref, port = _ctx(name)
    p, L, b3 = port.spec.p, port.fp.L, port.F.b3
    rows = RowCtx(p, L)
    one_limbs = tuple(int(v) for v in to_numpy(port.fp.one_mont)[:, 0])
    P, Q = _edge_lanes(eng, seed=L)
    n = len(P)
    sel, neg = _masks(n, seed=L)
    # relaxed [0, 2p) projective inputs: the port's plain add of encoded lanes
    Pt = port.add(port.encode_points(P), port.encode_points([eng.gen_g1] * n))
    Pt = port.add(Pt, port.encode_points([eng.g1.neg(eng.gen_g1)] * n))
    assert port.decode_points(Pt) == P
    Qt = port.encode_points(Q[:12] + [None] * 4)
    Qa_host = Q[:14] + [None, None]  # (0, 0) on two lanes, one selected
    sel[14], sel[15] = True, False
    Qa = port.encode_points_affine(Qa_host)
    np.testing.assert_array_equal(to_numpy(Qa), ref.encode_points_affine(Qa_host))
    assert port.decode_points_affine(Qa) == Qa_host
    s_t, n_t = torch.from_numpy(sel), torch.from_numpy(neg)

    def body(kernel, *arrays, one=False):
        o = Ref(np.zeros((3, L, 1, n), dtype=np.uint32))
        refs = [Ref(np.ascontiguousarray(a)[..., None, :]) for a in arrays]
        with numpy_bodies():
            kernel(rows, b3, *((one_limbs,) if one else ()), *refs, o)
        return o.arr[:, :, 0, :]

    P4, Q4, Qa4 = to_numpy(Pt), to_numpy(Qt), to_numpy(Qa)
    s4, n4 = sel.astype(np.uint32)[None], neg.astype(np.uint32)[None]
    F = port.F
    cases = {
        "dbladd": (g1_cuda.dbladd_plain(F, Pt, Qt, s_t), body(g1p_mod._dbladd_kernel, P4, Q4, s4)),
        "addselneg": (g1_cuda.addselneg_plain(F, Pt, Qt, s_t, n_t),
                      body(g1p_mod._addselneg_kernel, P4, Q4, s4, n4)),
        "maddsel": (g1_cuda.maddsel_plain(F, Pt, Qa, s_t),
                    body(g1p_mod._maddsel_kernel, P4, Qa4, s4, one=True)),
        "maddselneg": (g1_cuda.maddselneg_plain(F, Pt, Qa, s_t, n_t),
                       body(g1p_mod._maddselneg_kernel, P4, Qa4, s4, n4, one=True)),
    }
    for kname, (got, want) in cases.items():
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=kname)
    # the G1Ctx entry points run the same plain versions on CPU tensors
    np.testing.assert_array_equal(to_numpy(port.dbl_add_select(Pt, Qt, s_t)), cases["dbladd"][1])
    np.testing.assert_array_equal(to_numpy(port.madd_select_neg(Pt, Qa, s_t, n_t)),
                                  cases["maddselneg"][1])
    # against the host group law (the lanes where Q is a curve point)
    Qn = [eng.g1.neg(q) if g else q for q, g in zip(Qa_host, neg)]
    want = [eng.g1.add(a, q) if s else q for a, q, s in zip(P, Qn, sel)]
    assert port.decode_points(cases["maddselneg"][0])[:14] == want[:14]
    Qp = [eng.g1.neg(q) if g and q else q for q, g in zip(Q[:12] + [None] * 4, neg)]
    assert port.decode_points(cases["addselneg"][0]) == [
        eng.g1.add(a, q) if s else q for a, q, s in zip(P, Qp, sel)]
    dbl = [eng.g1.add(a, a) for a in P]
    assert port.decode_points(cases["dbladd"][0]) == [
        eng.g1.add(d, q) if s else d for d, q, s in zip(dbl, Q[:12] + [None] * 4, sel)]


def test_mixed_add_equals_the_reference_xla_fallback_canonically():
    """The reference's XLA ``madd_select`` lifts Q and runs the full add: the
    same points as ``_madd_rows``, other relaxed limbs."""
    eng, ref, port = _ctx("BLS12_381")
    P, Q = _edge_lanes(eng, seed=3, n=LANES)
    sel, _ = _masks(LANES, seed=3)
    Pt, Qa = port.encode_points(P), port.encode_points_affine(Q)
    want = type(ref).madd_select(_bodies(ref), jnp.asarray(to_numpy(Pt)),
                                 jnp.asarray(to_numpy(Qa)), sel)
    got = port.madd_select(Pt, Qa, torch.from_numpy(sel))
    want_xy = to_torch(np.asarray(_jitted(ref, "to_affine_rows")(want)), "cpu")
    assert torch.equal(port.fp.canon(port.to_affine_rows(got)), port.fp.canon(want_xy))
    assert port.decode_points(got) == [eng.g1.add(a, q) if s else q for a, q, s in zip(P, Q, sel)]


_BODIES = {}
_JITTED = {}


def _jitted(ref, name):
    """One jit of a reference method per context, shared by the tests (at
    one shape it compiles once)."""
    key = (ref.spec.name, name)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(getattr(ref, name))
    return _JITTED[key]


def _bodies(ref):
    """One BodyG1 per reference context, shared by the tests."""
    return _BODIES.setdefault(ref.spec.name, BodyG1(ref))


def test_affine_eq_and_axis_reduction_equal_the_reference():
    eng, ref, port = _ctx("BLS12_381")
    P, Q = _edge_lanes(eng, seed=5, n=LANES)
    Pt = port.add(port.encode_points(P), port.encode_points(Q))  # relaxed, with inf lanes
    assert port.decode_points(Pt) == [eng.g1.add(a, b) for a, b in zip(P, Q)]
    S = to_numpy(Pt)
    np.testing.assert_array_equal(to_numpy(port.to_affine_rows(Pt)),
                                  np.asarray(_jitted(ref, "to_affine_rows")(S)))
    assert port.decode_points_affine(port.to_affine_rows(Pt)) == port.decode_points(Pt)
    x, y = port.to_affine(Pt)
    assert torch.equal(torch.stack([x, y], dim=-3), port.to_affine_rows(Pt))
    Qt = port.encode_points([eng.g1.add(a, b) for a, b in zip(P, Q)])
    Rt = torch.roll(Qt, 1, dims=-1)
    for other in (Qt, Rt):
        want = np.asarray(jax.jit(ref.eq)(S, to_numpy(other)))
        got = port.eq(Pt, other).numpy()
        np.testing.assert_array_equal(got, want)
    assert port.eq(Pt, Qt).all() and not port.eq(Pt, Rt).all()
    # three batches along a leading axis: an odd count, and a P + (-P) lane
    stack = torch.stack([Pt, port.neg(Pt), port.encode_points(Q)])
    want = np.asarray(type(ref).sum_reduce_axis(_bodies(ref), jnp.asarray(to_numpy(stack)), 0))
    np.testing.assert_array_equal(to_numpy(port.sum_reduce_axis(stack, 0)), want)
    assert port.decode_points(port.sum_reduce_axis(stack.movedim(0, 1), 1)) == Q
    assert port.decode_points(port.sub(Pt, Pt)) == [None] * LANES


def test_mul2_equals_the_reference_host_engine():
    spec = get_spec("BN254")
    eng, ref_eng, port = get_engine(spec), ref_get_engine(ref_get_spec("BN254")), G1Ctx(spec, "cpu")
    rng = random.Random(7)
    r = spec.r
    P = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(4)]
    Q = [P[1], eng.g1.neg(P[2]), None, eng.gen_g1]
    e = [0, rng.randrange(r), rng.randrange(r), r - 1]
    f = [rng.randrange(r), 0, rng.randrange(r), rng.randrange(r)]
    got = port.mul2(port.encode_points(P), port.encode_scalars(e),
                    port.encode_points(Q), port.encode_scalars(f))
    want = [ref_eng.g1.add(ref_eng.g1.mul(a, x), ref_eng.g1.mul(b, y) if b else None)
            for a, x, b, y in zip(P, e, Q, f)]
    assert port.decode_points(got) == want


def test_signed_digits_and_windows_equal_the_reference():
    spec = get_spec("BLS12_381")
    ref, port = ref_get_g1_ctx(ref_get_spec("BLS12_381")), G1Ctx(spec, "cpu")
    rng = random.Random(8)
    # a scalar that fills the top window of 128 bits (the GLV halves): all
    # digits at the top of the range carry into the extra window
    ks = [0, 1, spec.r - 1, (1 << 128) - 1, sum(9 << (4 * w) for w in range(32))]
    ks += [rng.randrange(spec.r) for _ in range(4)]
    S = port.encode_scalars(ks)
    Sn = jnp.asarray(to_numpy(S))
    for c, nbits in ((4, None), (8, None), (16, None), (4, 128), (8, 128)):
        nwin = -(-(nbits or port.nbits) // c)
        for signed in (False, True):
            assert msm.n_windows(port, c, signed, nbits) == ref_msm.n_windows(ref, c, signed, nbits)
        absd, neg = msm._signed_digits(S, c, nwin, nbits=nbits)
        ra, rn = ref_msm._signed_digits(Sn, c, nwin, nbits=nbits)
        np.testing.assert_array_equal(absd.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(rn))
        # the digits give the scalar back (mod 2^nbits for the 128-bit halves)
        val = [sum((-a if g else a) << (c * w) for w, (a, g) in enumerate(zip(col_a, col_n)))
               for col_a, col_n in zip(absd.T.tolist(), neg.T.tolist())]
        mod = 1 << (nbits or 16 * S.shape[0])
        assert [v % mod for v in val] == [k % spec.r % mod for k in ks]
    assert msm.n_windows(port, 8, True, 128) == 17


@pytest.mark.parametrize("name", ["BLS12_381", "BLS12_377"])
def test_glv_split_and_endomorphism_equal_the_reference(name):
    eng, ref, port = _ctx(name)
    spec = port.spec
    gl, rgl = msm.get_glv_ctx(port), ref_msm.get_glv_ctx(ref)
    assert (gl.lam, gl.beta, gl.nbits, gl.shift_limbs) == (rgl.lam, rgl.beta, rgl.nbits,
                                                           rgl.shift_limbs)
    np.testing.assert_array_equal(gl.mu, rgl.mu)
    np.testing.assert_array_equal(gl.lam_limbs, rgl.lam_limbs)
    np.testing.assert_array_equal(to_numpy(gl.beta_mont), np.asarray(rgl.beta_mont))
    rng = random.Random(name)
    ks = [0, 1, gl.lam - 1, gl.lam, gl.lam + 1, spec.r - 1] + [rng.randrange(spec.r) for _ in range(10)]
    S = port.encode_scalars(ks)
    k1, k2 = gl.split(S)
    r1, r2 = jax.jit(rgl.split)(jnp.asarray(to_numpy(S)))
    np.testing.assert_array_equal(to_numpy(k1), np.asarray(r1))
    np.testing.assert_array_equal(to_numpy(k2), np.asarray(r2))
    for k, a, b in zip(ks, msm_ints(k1), msm_ints(k2)):
        assert k == b * gl.lam + a and a < 1 << 128 and b < 1 << 128
    P, _ = _edge_lanes(eng, seed=9, n=LANES)
    Pt = port.encode_points(P)
    phi = gl.endo_points(Pt)
    np.testing.assert_array_equal(to_numpy(phi), np.asarray(jax.jit(rgl.endo_points)(to_numpy(Pt))))
    assert port.decode_points(phi) == [eng.g1.mul(x, gl.lam) if x else None for x in P]
    phi_affine = gl.endo_points(port.encode_points_affine(P))
    assert port.decode_points_affine(phi_affine) == port.decode_points(phi)


def msm_ints(limbs):
    """(SL, N) 16-bit limbs -> N ints."""
    a = to_numpy(limbs).astype(object)
    return [sum(int(a[i, j]) << (16 * i) for i in range(a.shape[0])) for j in range(a.shape[1])]


def test_the_field_product_goes_to_the_mont_mul_wrapper(monkeypatch):
    """FpCtx.mont_mul (sqr, from_mont), G1Ctx.eq/to_affine and GLV's
    endomorphism reach ``fp_cuda.mont_mul`` -- the kernel on a card; the
    plain versions of the G1 kernels never do, on any device."""
    spec = get_spec("BLS12_381")
    port = G1Ctx(spec, "cpu")
    calls = []
    real = fp_cuda.mont_mul

    def spy(fp, a, b):
        calls.append(tuple(torch.broadcast_shapes(a.shape, b.shape)))
        return real(fp, a, b)

    monkeypatch.setattr(fp_cuda, "mont_mul", spy)
    P = port.encode_points([port.spec.g1_gen, None, port.spec.g1_gen])
    fp = port.fp
    x = P[0]
    for fn in (lambda: fp.mont_mul(x, P[1]), lambda: fp.sqr(x), lambda: fp.from_mont(x),
               lambda: port.eq(P, P), lambda: port.to_affine_rows(P),
               lambda: msm.get_glv_ctx(port).endo_points(P)):
        calls.clear()
        fn()
        assert calls, fn
    assert fp.mont_mul(x, fp.one_mont.to(torch.int32)).shape == x.shape  # (L, 1) broadcasts
    calls.clear()
    F, sel, neg = port.F, torch.tensor([True, False, True]), torch.tensor([False, True, True])
    Qa = port.encode_points_affine([spec.g1_gen] * 3)
    for out in (g1_cuda.add_plain(F, P, P), g1_cuda.double_plain(F, P),
                g1_cuda.addsel_plain(F, P, P, sel), g1_cuda.dbladd_plain(F, P, P, sel),
                g1_cuda.addselneg_plain(F, P, P, sel, neg), g1_cuda.maddsel_plain(F, P, Qa, sel),
                g1_cuda.maddselneg_plain(F, P, Qa, sel, neg),
                g1_cuda.smul_plain(F, P[..., :1], port.encode_scalars([5]), 4)):
        assert out.shape == P.shape or out.shape[-1] == 1
    assert calls == []
    assert F.plain.plain is F.plain and F.plain._mul == fp.mont_mul_plain
