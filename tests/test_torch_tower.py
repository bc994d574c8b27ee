"""The port's ``TowerCtx`` (plain PyTorch Fp2/Fp6/Fp12) on relaxed [0, 2p)
inputs: the Fp2 layer (with the predicates and helpers G2 uses) and the
codecs against the JAX package's, limb for limb (each test's reference ops
in one jit); Fp6 and Fp12 against the exact host tower; the affine G2 codecs
against the reference's, word for word.

BLS12-381 has beta = -1, BLS12-377 beta = -5, so both ``mul_int`` chains of
``f2_mul`` are covered.
"""

import jax
import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.ops.g2 import G2Ctx as RefG2Ctx
from mathlib_tpu.ops.tower import TowerCtx as RefTowerCtx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.field import ints_to_limbs
from mathlib_tpu_torch.ops.g2 import G2Ctx
from mathlib_tpu_torch.ops.tower import TowerCtx

torch.set_num_threads(1)
B = 3


@pytest.fixture(params=["BLS12_381", "BLS12_377"])
def towers(request):
    spec = get_spec(request.param)
    return spec, RefTowerCtx(ref_get_spec(request.param)), TowerCtx(spec, "cpu")


def _relaxed(spec, shape, seed):
    """Random limbs of values in [0, 2p), shaped shape[:-1] + (L, B)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    L = -(-(spec.p.bit_length() + 2) // 16)
    vals = [int.from_bytes(rng.bytes(64), "big") % (2 * spec.p) for _ in range(n)]
    arr = ints_to_limbs(vals, L).reshape(shape + (L,))
    return np.ascontiguousarray(np.moveaxis(arr, -1, -2))


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want, dtype=np.uint32))


def _host(tw, arr, coeffs):
    """(..., L, B) limbs -> per-lane host tower elements of ``coeffs`` shape."""
    d = tw.fp.decode(arr)  # (..., B) ints
    lanes = np.moveaxis(d, -1, 0)

    def nest(x, depth):
        if depth == len(coeffs):
            return int(x)
        return tuple(nest(x[i], depth + 1) for i in range(coeffs[depth]))

    return [nest(lane, 0) for lane in lanes]


def test_fp2_ops_and_codecs_equal_the_reference(towers):
    spec, ref, tw = towers
    a2, b2 = _relaxed(spec, (2, B), 1), _relaxed(spec, (2, B), 2)
    A2, B2 = to_torch(a2, "cpu"), to_torch(b2, "cpu")
    # the reference's seven ops in one jit (one XLA compile, not an eager
    # compile of every primitive they run)
    want = jax.jit(lambda a, b: (ref.f2_add(a, b), ref.f2_sub(a, b), ref.f2_neg(a),
                                 ref.f2_conj(a), ref.f2_mul(a, b), ref.f2_sqr(a),
                                 ref.f2_mul_xi(a)))(a2, b2)
    got = (tw.f2_add(A2, B2), tw.f2_sub(A2, B2), tw.f2_neg(A2), tw.f2_conj(A2),
           tw.f2_mul(A2, B2), tw.f2_sqr(A2), tw.f2_mul_xi(A2))
    for g, w in zip(got, want):
        _same(g, w)
    _same(tw.f2_encode((11, 13)), ref.f2_encode((11, 13)))
    a = _relaxed(spec, (2, 3, 2, B), 5)
    assert tw.f12_decode(to_torch(a, "cpu")) == ref.f12_decode(a)
    host = ref.f12_decode(a)[0]
    _same(tw.f12_encode(host), ref.f12_encode(host))
    _same(tw.f12_one, ref.f12_one)


def test_fp2_helpers_equal_the_reference(towers):
    """f2_one, f2_zero, f2_mul_fp, and the predicates on relaxed values: an
    element is zero as (0, 0), (p, 0), (0, p) or (p, p)."""
    spec, ref, tw = towers
    a2, b2 = _relaxed(spec, (2, B + 4), 7), _relaxed(spec, (2, B + 4), 8)
    p_limbs = to_numpy(tw.fp.p_limbs)[:, 0]
    for lane, (c0, c1) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        a2[:, :, lane] = 0
        a2[0, :, lane] = p_limbs if c0 else 0
        a2[1, :, lane] = p_limbs if c1 else 0
    b2[..., B] = a2[..., B]  # a lane with a == b
    A2, B2 = to_torch(a2, "cpu"), to_torch(b2, "cpu")
    s1 = _relaxed(spec, (B + 4,), 9)
    _same(tw.f2_one, ref.f2_one)
    _same(tw.f2_zero, ref.f2_zero)
    mask = np.array([1, 0, 1, 1, 0, 0, 1], dtype=bool)
    w_mul, w_zero, w_eq, w_sel = jax.jit(  # one XLA compile for the four
        lambda a, b, s, m: (ref.f2_mul_fp(a, s), ref.f2_is_zero(a), ref.f2_eq(a, b),
                            ref.f2_select(m, a, b)))(a2, b2, s1, mask)
    _same(tw.f2_mul_fp(A2, to_torch(s1, "cpu")), w_mul)
    np.testing.assert_array_equal(tw.f2_is_zero(A2).numpy(), np.asarray(w_zero))
    assert tw.f2_is_zero(A2).tolist()[:4] == [True] * 4
    np.testing.assert_array_equal(tw.f2_eq(A2, B2).numpy(), np.asarray(w_eq))
    assert tw.f2_eq(A2, B2).tolist()[B]
    _same(tw.f2_select(torch.from_numpy(mask), A2, B2), w_sel)


def test_fp6_and_fp12_ops_equal_the_host_tower(towers):
    spec, ref, tw = towers
    h = tw.host
    a6, b6 = _relaxed(spec, (3, 2, B), 3), _relaxed(spec, (3, 2, B), 4)
    A6, B6 = to_torch(a6, "cpu"), to_torch(b6, "cpu")
    ha, hb = _host(tw, a6, (3, 2)), _host(tw, b6, (3, 2))
    assert _host(tw, tw.f6_mul(A6, B6), (3, 2)) == list(map(h.f6_mul, ha, hb))
    assert _host(tw, tw.f6_sqr(A6), (3, 2)) == [h.f6_mul(x, x) for x in ha]
    assert _host(tw, tw.f6_add(A6, B6), (3, 2)) == list(map(h.f6_add, ha, hb))
    assert _host(tw, tw.f6_sub(A6, B6), (3, 2)) == list(map(h.f6_sub, ha, hb))
    assert _host(tw, tw.f6_mul_v(A6), (3, 2)) == list(map(h.f6_mul_v, ha))
    a, b = _relaxed(spec, (2, 3, 2, B), 5), _relaxed(spec, (2, 3, 2, B), 6)
    A, Bt = to_torch(a, "cpu"), to_torch(b, "cpu")
    fa, fb = tw.f12_decode(A), tw.f12_decode(Bt)
    assert tw.f12_decode(tw.f12_mul(A, Bt)) == list(map(h.f12_mul, fa, fb))
    assert tw.f12_decode(tw.f12_sqr(A)) == [h.f12_mul(x, x) for x in fa]
    assert tw.f12_decode(tw.f12_conj(A)) == list(map(h.f12_conj, fa))
    a2 = a6[0]
    want = [h.f2_mul(x, (5, 7)) for x in _host(tw, a2, (2,))]
    assert _host(tw, tw.f2_mul_const(to_torch(a2, "cpu"), (5, 7)), (2,)) == want
    # is_one on one, a relaxed one (0 + p in a coefficient) and a non-one
    one = to_numpy(tw.f12_one).astype(np.int64)
    relaxed_one = one.copy()
    relaxed_one[0, 1, 1] = to_numpy(tw.fp.p_limbs)
    mix = np.concatenate([one, relaxed_one, a[..., :1].astype(np.int64)], axis=-1)
    assert tw.f12_is_one(to_torch(mix, "cpu")).tolist() == [True, True, False]


def test_g2_codecs_equal_the_reference(towers):
    spec, _, _ = towers
    eng = get_engine(spec)
    pts = [eng.g2.mul(eng.gen_g2, k) for k in (3, 5)] + [None]
    g2 = G2Ctx(spec, "cpu")
    got = g2.encode_points(pts)
    _same(got, RefG2Ctx(ref_get_spec(spec.name)).encode_points(pts))
    assert g2.decode_points(got) == pts
