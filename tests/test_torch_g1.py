"""Port ``G1Ctx`` (mathlib_tpu_torch) against the reference ``G1Ctx`` (JAX).

These are the G1 operations that carry the four CUDA kernels (add, double,
add_select, scalar_mul; ``sum_reduce`` is tested with the MSM).  On CPU
tensors the port runs each kernel's plain PyTorch version, and the reference
runs its XLA path.  Same seeded points
through both, with infinity, P == Q and P == -Q lanes; every comparison is
exact limb equality (tolerance: zero), plus a decode against the host engine.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.host.engine import get_engine
from mathlib_tpu.ops.g1 import get_g1_ctx
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops.g1 import G1Ctx

torch.set_num_threads(1)


@pytest.fixture(params=["BLS12_381", "BN254"], scope="module")
def ctx(request):
    spec = get_spec(request.param)
    return get_engine(spec), get_g1_ctx(spec), G1Ctx(spec, "cpu")


@pytest.fixture(scope="module")
def bls():
    spec = get_spec("BLS12_381")
    return get_engine(spec), get_g1_ctx(spec), G1Ctx(spec, "cpu")


def _lanes(eng, seed):
    """Eight (P, Q) lanes: generic, P == Q, P == -Q, inf + Q, P + inf,
    inf + inf, and two more generic pairs."""
    rng = random.Random(seed)
    P, Q, R, S = (eng.g1.mul(eng.gen_g1, rng.randrange(1, eng.spec.r)) for _ in range(4))
    left = [P, P, P, None, P, None, R, S]
    right = [Q, P, eng.g1.neg(P), Q, None, None, S, R]
    return left, right


def _relaxed_inputs(eng, ref, port, seed=0):
    """Point limbs with relaxed [p, 2p) representatives: the reference's own
    add of the encoded lanes, fed to both sides as numpy."""
    left, right = _lanes(eng, seed)
    a, b = ref.encode_points(left), ref.encode_points(right)
    np.testing.assert_array_equal(to_numpy(port.encode_points(left)), a)
    s = np.asarray(jax.jit(ref.add)(a, b))
    return left, right, a, b, s


def test_constants_and_codecs(ctx):
    eng, ref, port = ctx
    np.testing.assert_array_equal(to_numpy(port.gen), ref.gen)
    np.testing.assert_array_equal(to_numpy(port.inf), ref.inf)
    left, _ = _lanes(eng, seed=5)
    enc = port.encode_points(left)
    assert port.decode_points(enc) == left
    assert port.decode_point(enc[..., 1]) == left[1]
    ks = [0, 1, eng.spec.r - 1, eng.spec.r + 7, 12345]
    np.testing.assert_array_equal(to_numpy(port.encode_scalars(ks)), ref.encode_scalars(ks))


def test_add_and_double_match_reference(ctx):
    eng, ref, port = ctx
    left, right, a, b, s = _relaxed_inputs(eng, ref, port)
    got = port.add(to_torch(a, "cpu"), to_torch(b, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), s)
    assert port.decode_points(got) == [eng.g1.add(x, y) for x, y in zip(left, right)]
    # relaxed inputs
    want = np.asarray(jax.jit(ref.double)(s))
    np.testing.assert_array_equal(to_numpy(port.double(to_torch(s, "cpu"))), want)
    want = np.asarray(jax.jit(ref.add)(s, a))
    np.testing.assert_array_equal(to_numpy(port.add(to_torch(s, "cpu"), to_torch(a, "cpu"))), want)


def test_add_select_matches_reference(ctx):
    eng, ref, port = ctx
    _, _, a, b, s = _relaxed_inputs(eng, ref, port)
    sel = np.array([1, 1, 0, 1, 0, 1, 1, 0], dtype=bool)
    want = np.asarray(jax.jit(ref.add_select)(s, b, sel))
    got = port.add_select(to_torch(s, "cpu"), to_torch(b, "cpu"), torch.from_numpy(sel))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_dbl_add_select_neg_is_inf_match_reference(bls):
    eng, ref, port = bls
    _, _, a, b, s = _relaxed_inputs(eng, ref, port, seed=1)
    sel = np.array([0, 1, 1, 1, 0, 1, 0, 1], dtype=bool)
    want = np.asarray(jax.jit(ref.dbl_add_select)(s, a, sel))
    got = port.dbl_add_select(to_torch(s, "cpu"), to_torch(a, "cpu"), torch.from_numpy(sel))
    np.testing.assert_array_equal(to_numpy(got), want)
    want = np.asarray(ref.neg(jnp.asarray(s)))
    np.testing.assert_array_equal(to_numpy(port.neg(to_torch(s, "cpu"))), want)
    want = np.asarray(ref.is_inf(jnp.asarray(s)))
    np.testing.assert_array_equal(port.is_inf(to_torch(s, "cpu")).numpy(), want)


def test_scalar_mul_matches_reference(bls):
    eng, ref, port = bls
    r = eng.spec.r
    rng = random.Random(3)
    ks = [0, 1, r - 1, 2] + [rng.randrange(r) for _ in range(4)]
    base = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(7)] + [None]
    pts, scs = ref.encode_points(base), ref.encode_scalars(ks)
    want = np.asarray(jax.jit(ref.scalar_mul)(pts, scs))
    got = port.scalar_mul(to_torch(pts, "cpu"), to_torch(scs, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert port.decode_points(got) == [eng.g1.mul(P, k) if P else None for P, k in zip(base, ks)]

