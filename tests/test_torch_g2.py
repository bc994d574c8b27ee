"""Port ``G2Ctx`` and the plain versions of the four G2 point kernels against
the reference, on the CPU (tolerance: zero).

* ``g2_cuda.add_plain``, ``double_plain``, ``addsel_plain`` and
  ``dblsel_plain`` against the reference's Pallas kernel BODIES
  (``g2_pallas._add_kernel``, ``_double_kernel``, ``_addsel_kernel``,
  ``_dblsel_kernel``) run on numpy rows (``tests/_torch_ref_bodies.py``, as
  ``tests/test_pallas_kernels.py`` runs them), limb for limb, on BLS12-381
  and FP256BN (the two curves in the reference's gate), with edge lanes
  (infinity on either side and both, P = Q, P = -Q, relaxed [p, 2p) inputs)
  and a mixed selection mask.  This also holds ``weier.add_complete`` /
  ``double_complete`` over ``Row2Adapter`` to RCB Algs 7/9 in the bodies'
  order, and the Karatsuba product to ``Row2Ctx.mul``.
* ``Row2Adapter.mul_b3``'s four branches against ``Row2Ctx.mul_b3``.
* ``G2Ctx``'s codecs and constants against the reference's, word for word
  (``convert.check_constants`` on a ``G2Ctx`` pair).
* ``is_inf``, ``eq``, ``select``, ``neg``, ``sub``, ``to_affine`` and
  ``sum_reduce`` canonically against the host engine, and the ``weier``
  fallback of BN254 and BLS12-377 (add, double, a short ladder of
  ``dbl_add_select``) likewise.
"""

import random

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.g1_pallas as ref_g1p
import mathlib_tpu.ops.kernels.g2_pallas as ref_g2p
from _torch_ref_bodies import Ref, numpy_kernel_bodies
from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.ops.g2 import G2Ctx as RefG2Ctx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.convert import check_constants, to_numpy
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.g2 import G2Ctx
from mathlib_tpu_torch.ops.kernels import g2_cuda

torch.set_num_threads(1)

CURVES = ["BLS12_381", "BN254", "BLS12_377", "FP256BN"]


def _ctx(name):
    spec = get_spec(name)
    return get_engine(spec), G2Ctx(spec, "cpu")


def _lanes(eng, seed, n=12):
    """n lanes (P, Q) of host points: generic, P = inf, Q = inf, both inf,
    P = Q, P = -Q, then generic."""
    rng = random.Random(seed)
    pool = [eng.g2.mul(eng.gen_g2, rng.randrange(1, eng.spec.r)) for _ in range(4)]
    P = [pool[rng.randrange(4)] for _ in range(n)]
    Q = [pool[rng.randrange(4)] for _ in range(n)]
    P[1] = None
    Q[2] = None
    P[3] = Q[3] = None
    P[4] = Q[4]
    P[5] = eng.g2.neg(Q[5])
    return P, Q


def _rows(t):
    """(3, 2, L, B) limbs -> the bodies' (3, 2L, 1, B) rows."""
    a = to_numpy(t)
    return a.reshape(3, 2 * a.shape[2], 1, a.shape[-1])


@pytest.mark.parametrize("name", ["BLS12_381", "FP256BN"])
def test_point_plain_versions_are_bit_equal_to_the_reference_bodies(name):
    eng, g2 = _ctx(name)
    F, L = g2.rows, g2.fp.L
    assert F.b3 == RefG2Ctx(ref_get_spec(name))._pallas_b3
    left, right = _lanes(eng, 0xBEEF)
    # relaxed inputs: P = left + right by the plain add, Q = right
    P = g2_cuda.add_plain(F, g2.encode_points(left), g2.encode_points(right))
    Q = g2.encode_points(right)
    n = P.shape[-1]
    sel = np.array([i % 4 != 2 for i in range(n)])
    sel[1:6] = True
    selt = torch.from_numpy(sel)
    rows = ref_g2p.Row2Ctx(g2.spec.p, L, F.b3, ref_g1p._mm_stacked)

    def body(kernel, *arrays):
        out = Ref(np.zeros_like(_rows(P)))
        with numpy_kernel_bodies(ref_g1p, ref_g2p):
            kernel(rows, *[Ref(a) for a in arrays], out)
        return out.arr.reshape(3, 2, L, n)

    s = sel.astype(np.uint32).reshape(1, 1, n)
    cases = [
        (g2_cuda.add_plain(F, P, Q), body(ref_g2p._add_kernel, _rows(P), _rows(Q))),
        (g2_cuda.double_plain(F, P), body(ref_g2p._double_kernel, _rows(P))),
        (g2_cuda.addsel_plain(F, P, Q, selt), body(ref_g2p._addsel_kernel, _rows(P), _rows(Q), s)),
        (g2_cuda.dblsel_plain(F, P, Q, selt), body(ref_g2p._dblsel_kernel, _rows(P), _rows(Q), s)),
    ]
    for got, want in cases:
        np.testing.assert_array_equal(to_numpy(got), want)
    # and canonically: the sums of the edge lanes are the host engine's
    sums = [eng.g2.add(a, b) for a, b in zip(left, right)]
    assert g2.decode_points(P) == sums
    assert g2.decode_points(cases[0][0]) == [eng.g2.add(a, b) for a, b in zip(sums, right)]


@pytest.mark.parametrize("b3", [(5, 0), (0, 7), (3, 5), (12, 12)])
def test_row2_products_equal_the_reference_row2ctx(b3):
    """mul_b3's four branches and the Karatsuba product, on relaxed values."""
    spec = get_spec("BLS12_381")
    g2 = G2Ctx(spec, "cpu")
    F = g2_cuda.Row2Adapter(g2.fp, b3)
    L = g2.fp.L
    rng = random.Random(1)
    # relaxed Montgomery values in [0, 2p), p and 2p - 1 among them
    vals = [[rng.randrange(2 * spec.p) for _ in range(4)] for _ in range(2)]
    vals[0][0], vals[1][1] = 2 * spec.p - 1, spec.p
    a = np.array([[[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in comp] for comp in vals],
                 dtype=np.uint32)  # (2, B, L)
    a = np.moveaxis(a, -1, 1)  # (2, L, B)
    b = a[:, :, ::-1].copy()
    rows = ref_g2p.Row2Ctx(spec.p, L, b3)

    def split(x):
        return ([x[0, k][None, :] for k in range(L)], [x[1, k][None, :] for k in range(L)])

    with numpy_kernel_bodies(ref_g1p, ref_g2p):
        m3 = rows.mul_b3(split(a))
        mm = rows.mul(split(a), split(b))
    for got, want in ((F.mul_b3(torch.from_numpy(a.astype(np.int32))), m3),
                      (F.mul_many([torch.from_numpy(a.astype(np.int32))],
                                  [torch.from_numpy(b.astype(np.int32))])[0], mm)):
        np.testing.assert_array_equal(to_numpy(got),
                                      np.array([[r[0] for r in comp] for comp in want]))


@pytest.mark.parametrize("name", CURVES)
def test_codecs_and_constants_equal_the_reference(name):
    eng, g2 = _ctx(name)
    ref = RefG2Ctx(ref_get_spec(name))
    check_constants(g2, ref)
    left, right = _lanes(eng, 3, n=6)
    enc = g2.encode_points(left)
    np.testing.assert_array_equal(to_numpy(enc), ref.encode_points(left))
    assert g2.decode_points(enc) == left
    assert g2.decode_point(enc[..., 4]) == left[4]
    ks = [0, 1, eng.spec.r - 1, eng.spec.r + 7, 12345]
    np.testing.assert_array_equal(to_numpy(g2.encode_scalars(ks)), ref.encode_scalars(ks))
    assert g2.nbits == ref.nbits


def test_check_constants_reports_a_g2_gate_mismatch():
    spec = get_spec("BN254")
    g2 = G2Ctx(spec, "cpu")
    g2.rows = g2_cuda.Row2Adapter(g2.fp, (1, 1))
    with pytest.raises(ValueError, match="the kernels' gate"):
        check_constants(g2, RefG2Ctx(ref_get_spec("BN254")))


@pytest.mark.parametrize("name", ["BLS12_381", "BN254"])
def test_group_helpers_against_the_host(name):
    eng, g2 = _ctx(name)
    left, right = _lanes(eng, 7, n=8)
    P = g2.add(g2.encode_points(left), g2.encode_points(right))  # relaxed
    Q = g2.encode_points(right)
    sums = [eng.g2.add(a, b) for a, b in zip(left, right)]
    assert g2.is_inf(P).tolist() == [s is None for s in sums]
    assert g2.eq(P, g2.encode_points(sums)).all()
    assert g2.eq(P, Q).tolist() == [s == b for s, b in zip(sums, right)]
    mask = torch.tensor([1, 0, 1, 0, 0, 1, 1, 0], dtype=torch.bool)
    assert g2.decode_points(g2.select(mask, P, Q)) == [
        s if m else b for s, b, m in zip(sums, right, mask.tolist())]
    assert g2.decode_points(g2.neg(P)) == [eng.g2.neg(s) for s in sums]
    assert g2.decode_points(g2.sub(P, Q)) == [eng.g2.add(s, eng.g2.neg(b))
                                              for s, b in zip(sums, right)]
    x, y = g2.to_affine(P)
    xs, ys = g2.tw.fp.decode(x), g2.tw.fp.decode(y)
    assert [None if s is None else ((int(xs[0, i]), int(xs[1, i])), (int(ys[0, i]), int(ys[1, i])))
            for i, s in enumerate(sums)] == sums
    assert all(int(v) == 0 for i, s in enumerate(sums) if s is None for v in (*xs[:, i], *ys[:, i]))
    total = None
    for s in sums[:7]:
        total = eng.g2.add(total, s)
    assert g2.decode_points(g2.sum_reduce(P[..., :7])) == [total]


@pytest.mark.parametrize("name", ["BN254", "BLS12_377"])
def test_weier_fallback_against_the_host(name):
    """Outside the kernels' gate: add, double, add_select and a 6-bit ladder
    of dbl_add_select from infinity, all on weier over Fp2Adapter."""
    eng, g2 = _ctx(name)
    assert g2.rows is None
    left, right = _lanes(eng, 11, n=8)
    P, Q = g2.encode_points(left), g2.encode_points(right)
    S = g2.add(P, Q)
    sums = [eng.g2.add(a, b) for a, b in zip(left, right)]
    assert g2.decode_points(S) == sums
    assert g2.decode_points(g2.double(S)) == [eng.g2.add(s, s) for s in sums]
    sel = torch.tensor([1, 1, 0, 1, 0, 1, 1, 1], dtype=torch.bool)
    assert g2.decode_points(g2.add_select(S, Q, sel)) == [
        eng.g2.add(s, b) if m else b for s, b, m in zip(sums, right, sel.tolist())]
    ks = [0, 1, 63, 37, 20, 5, 44, 9]
    K = g2.encode_scalars(ks)
    acc = g2.inf.expand(S.shape)
    for i in range(5, -1, -1):
        acc = g2.dbl_add_select(acc, S, g2_cuda.scalar_bit(K, i))
    assert g2.decode_points(acc) == [eng.g2.mul_any(s, k) if s else None
                                     for s, k in zip(sums, ks)]
