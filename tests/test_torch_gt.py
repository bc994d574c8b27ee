"""The port's Gt helpers on ``TowerCtx`` against the JAX package's, on the CPU.

``f12_zero``, ``f12_add``, ``f12_sub``, ``f12_neg`` and ``f12_select``
against the reference's, limb for limb, on relaxed [0, 2p) inputs (the
reference's five in one jit).  ``f12_pow_bits`` (the ``f12_pow`` kernel's
plain version here), ``f12_pow_scalars`` and ``_f12_exp_pos`` against the
exact host tower's ``f12_pow``, canonically, with exponents 0 and 1 among
them.  The reference's own scan of these powers is slow-marked in its tests
and is not run here.
"""

import random

import jax
import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.ops.tower import TowerCtx as RefTowerCtx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops.field import ints_to_limbs
from mathlib_tpu_torch.ops.kernels import pairing_cuda
from mathlib_tpu_torch.ops.tower import TowerCtx

torch.set_num_threads(1)
B = 3


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


@pytest.fixture(scope="module")
def bls():
    spec = get_spec("BLS12_381")
    tw = TowerCtx(spec, "cpu")
    rng = random.Random(21)
    rand = lambda: rng.randrange(spec.p)  # noqa: E731
    vals = [tuple(tuple((rand(), rand()) for _ in range(3)) for _ in range(2)) for _ in range(B)]
    return spec, tw, vals, torch.cat([tw.f12_encode(v) for v in vals], dim=-1)


def _bits_le(e: int) -> np.ndarray:
    return np.array([(e >> i) & 1 for i in range(e.bit_length())], dtype=np.uint8)


def _scalar_limbs(ks, limbs: int) -> torch.Tensor:
    """Per-lane scalars as (S, B) plain 16-bit limbs."""
    return torch.from_numpy(np.ascontiguousarray(ints_to_limbs(ks, limbs).T.astype(np.int32)))


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_gt_helpers_equal_the_reference(curve):
    spec = get_spec(curve)
    ref, tw = RefTowerCtx(ref_get_spec(curve)), TowerCtx(spec, "cpu")
    a, b = _relaxed(spec, (2, 3, 2, B + 1), 1), _relaxed(spec, (2, 3, 2, B + 1), 2)
    mask = np.array([1, 0, 1, 0], dtype=bool)
    want = jax.jit(lambda a, b, m: (ref.f12_add(a, b), ref.f12_sub(a, b), ref.f12_neg(a),
                                    ref.f12_select(m, a, b)))(a, b, mask)
    A, Bt = to_torch(a, "cpu"), to_torch(b, "cpu")
    got = (tw.f12_add(A, Bt), tw.f12_sub(A, Bt), tw.f12_neg(A),
           tw.f12_select(torch.from_numpy(mask), A, Bt))
    for g, w in zip(got, want):
        _same(g, w)
    _same(tw.f12_zero, ref.f12_zero)


@pytest.mark.parametrize("e", [0, 1, 2, (1 << 64) - 12345], ids=["zero", "one", "two", "64bit"])
def test_f12_pow_bits_equals_the_host_pow(bls, e):
    spec, tw, vals, a = bls
    pairing_cuda.reset_launches()
    got = tw.f12_pow_bits(a, _bits_le(e))
    assert got.shape == a.shape and got.dtype == torch.int32
    assert tw.f12_decode(got) == [tw.host.f12_pow(v, e) for v in vals]
    assert pairing_cuda.launches().get("f12_pow", 0) == 0  # the plain version, here


def test_f12_pow_bits_takes_leading_zeros_leading_dims_and_no_lanes(bls):
    spec, tw, vals, a = bls
    e = 0b1011
    bits = np.concatenate([_bits_le(e), np.zeros(3, np.uint8)])  # high zero bits
    stacked = tw.f12_pow_bits(torch.stack([a, tw.f12_neg(a)]), bits)
    assert stacked.shape == (2,) + a.shape
    assert tw.f12_decode(stacked[0]) == [tw.host.f12_pow(v, e) for v in vals]
    assert tw.f12_decode(stacked[1]) == [tw.host.f12_pow(tw.host.f12_neg(v), e) for v in vals]
    assert tw.f12_decode(tw.f12_pow_bits(a, np.zeros(0, np.uint8))) == [tw.host.F12_ONE] * B
    assert tw.f12_pow_bits(a[..., :0], bits).shape == a[..., :0].shape


@pytest.mark.parametrize("nbits", [12, None], ids=["12bit", "full"])
def test_f12_pow_scalars_equals_the_host_pow(bls, nbits):
    """Per-lane scalars with 0 and 1 among them: 12 bits on three lanes, and
    the reference's default trip count (r's bit length) on two."""
    spec, tw, vals, a = bls
    rng = random.Random(nbits or 0)
    if nbits is None:
        ks, a, vals = [0, rng.randrange(spec.r)], a[..., :2], vals[:2]
    else:
        ks = [1, 0, rng.randrange(1 << nbits)]
    S = _scalar_limbs(ks, -(-spec.r.bit_length() // 16))
    got = tw.f12_pow_scalars(a, S, nbits)
    assert tw.f12_decode(got) == [tw.host.f12_pow(v, k) for v, k in zip(vals, ks)]


@pytest.mark.parametrize("e", [0, 1, 13, None], ids=["zero", "one", "13", "abs_x"])
def test_f12_exp_pos_equals_the_host_pow(bls, e):
    """The unrolled chain: e = 0 gives a back, as the reference's does."""
    spec, tw, vals, a = bls
    e = abs(spec.x) if e is None else e
    want = vals if e == 0 else [tw.host.f12_pow(v, e) for v in vals]
    assert tw.f12_decode(tw._f12_exp_pos(a, e)) == want
