"""Port ``FpCtx`` (mathlib_tpu_torch) against the reference ``FpCtx`` (JAX).

Same seeded inputs through both, on XLA:CPU and torch on the CPU; every
comparison is exact limb equality (tolerance: zero).  Inputs are raw relaxed
limbs in [0, 2p) and include 0, 1, p-1, p and 2p-1.
"""

import random

import jax
import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.ops.field import FpCtx as RefFpCtx
from mathlib_tpu.ops.field import int_to_limbs
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops.field import FpCtx

torch.set_num_threads(1)

# BLS12-381 p (L=24) and r (L=17, odd), BN254 p (L=16)
FIELDS = [("BLS12_381", "p"), ("BLS12_381", "r"), ("BN254", "p")]


@pytest.fixture(params=FIELDS, ids=lambda f: f"{f[0]}-{f[1]}")
def fields(request):
    name, which = request.param
    p = getattr(get_spec(name), which)
    return RefFpCtx(p), FpCtx(p, "cpu")


def _relaxed(p: int, L: int, seed: int) -> np.ndarray:
    """(L, 16) relaxed limbs: the edge values, then seeded values in [0, 2p)."""
    rng = random.Random(seed)
    vals = [0, 1, p - 1, p, 2 * p - 1] + [rng.randrange(2 * p) for _ in range(11)]
    return np.stack([int_to_limbs(v, L) for v in vals], axis=1)


def _pair(fields):
    ref, _ = fields
    a = _relaxed(ref.p, ref.L, seed=1)
    b = np.roll(a, 3, axis=1)  # every edge value meets every other kind
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "eq"])
def test_binary_ops_match_reference(fields, op):
    ref, port = fields
    a, b = _pair(fields)
    want = np.asarray(jax.jit(getattr(ref, op))(a, b))
    got = to_numpy(getattr(port, op)(to_torch(a, "cpu"), to_torch(b, "cpu")))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("op", ["neg", "sqr", "canon", "to_mont", "from_mont", "is_zero"])
def test_unary_ops_match_reference(fields, op):
    ref, port = fields
    a, _ = _pair(fields)
    want = np.asarray(jax.jit(getattr(ref, op))(a))
    got = to_numpy(getattr(port, op)(to_torch(a, "cpu")))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_mul_int_matches_reference(fields):
    ref, port = fields
    a, _ = _pair(fields)
    for n in (0, 1, 3, 8, 12, ref.p - 5):  # p - 5 takes the -(p - n) path
        want = np.asarray(jax.jit(ref.mul_int, static_argnums=1)(a, n))
        got = to_numpy(port.mul_int(to_torch(a, "cpu"), n))
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_select_matches_reference(fields):
    ref, port = fields
    a, b = _pair(fields)
    mask = np.arange(a.shape[-1]) % 3 == 0
    want = np.asarray(ref.select(mask, a, b))
    got = to_numpy(port.select(torch.from_numpy(mask), to_torch(a, "cpu"), to_torch(b, "cpu")))
    np.testing.assert_array_equal(got, want)


def test_codecs_match_reference(fields):
    ref, port = fields
    rng = random.Random(2)
    p = ref.p
    vals = [0, 1, p - 1, p, 2 * p + 3] + [rng.randrange(p) for _ in range(7)]
    np.testing.assert_array_equal(to_numpy(port.encode(vals)), ref.encode(vals))
    np.testing.assert_array_equal(to_numpy(port.encode(vals[3])), ref.encode(vals[3]))
    grid = np.array(vals, dtype=object).reshape(3, 4)
    np.testing.assert_array_equal(to_numpy(port.encode(grid)), ref.encode(grid))
    np.testing.assert_array_equal(to_numpy(port.encode_plain(vals)), ref.encode_plain(vals))
    enc = ref.encode(vals)
    assert list(port.decode(to_torch(enc, "cpu"))) == list(ref.decode(enc))
    assert list(port.decode(port.encode(grid)).reshape(-1)) == [v % p for v in vals]
