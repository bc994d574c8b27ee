"""Port ``G1Ctx`` (mathlib_tpu_torch) against the reference ``G1Ctx`` (JAX).

These are the G1 operations that carry the CUDA kernels of the MSM main path
(add, double, add_select, dbl_add_select, scalar_mul; ``sum_reduce`` is
tested with the MSM, the slice's options in ``test_torch_g1_options.py``).
On CPU tensors the port runs each kernel's plain PyTorch version, and the
reference runs its XLA path.  Same seeded points through both, with
infinity, P == Q and P == -Q lanes; every comparison is exact limb equality
(tolerance: zero), plus a decode against the host engine.

The reference's ``add`` and ``double`` are jitted once on BLS12-381 at the
tests' 8 lanes and shared (``_Jitted``); on BN254, which runs no ladder
here, they are the reference's Pallas bodies on numpy rows
(``tests/_torch_ref_bodies.py``: the RCB formulas in the XLA path's
operation order, the same limbs).  Its ``add_select``, ``dbl_add_select``
and the steps of its ``scalar_mul`` ladder run as they are on top of them.
The reference's own code and arithmetic: only the XLA program boundaries
move (one jit of its whole ladder compiles for longer than this file runs).
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.g1_pallas as g1p_mod
from _torch_ref_bodies import BodyG1
from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.host.engine import get_engine
from mathlib_tpu.ops.g1 import get_g1_ctx
from mathlib_tpu_torch.convert import to_numpy, to_torch
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import g1_cuda

torch.set_num_threads(1)


class _Jitted:
    """The reference G1Ctx with ``add`` and ``double`` jitted (BLS12-381,
    whose ladder runs them 255 times), or run as the reference's Pallas
    bodies on numpy rows (BN254: a few calls, no XLA program to compile);
    its other methods run as they are, calling these."""

    def __init__(self, g1):
        self._g1 = g1
        if g1.spec.name == "BLS12_381":
            self.add = jax.jit(g1.add)
            self.double = jax.jit(g1.double)
        else:
            body = BodyG1(g1)
            self.add = lambda P, Q: body.host(g1p_mod._add_kernel, *np.broadcast_arrays(P, Q))
            self.double = lambda P: body.host(g1p_mod._double_kernel, P)

    def __getattr__(self, name):
        attr = getattr(type(self._g1), name, None)
        if callable(attr):
            return types.MethodType(attr, self)
        return getattr(self._g1, name)

    def scalar_mul(self, P, scalars):
        """The reference's ``scalar_mul`` ladder (XLA path), its scan body
        run once per bit: dbl_add_select on bit nbits-1-t, from infinity."""
        acc = jnp.broadcast_to(jnp.asarray(self.inf), self._acc_shape(P, scalars))
        for t in range(self.nbits):
            bit = self._scalar_bit(scalars, self.nbits - 1 - t)
            acc = self.dbl_add_select(acc, P, bit.astype(bool))
        return acc


_JITTED = {}


def _ref_ctx(spec):
    if spec.name not in _JITTED:
        _JITTED[spec.name] = _Jitted(get_g1_ctx(spec))
    return _JITTED[spec.name]


@pytest.fixture(params=["BLS12_381", "BN254"], scope="module")
def ctx(request):
    spec = get_spec(request.param)
    return get_engine(spec), _ref_ctx(spec), G1Ctx(spec, "cpu")


@pytest.fixture(scope="module")
def bls():
    spec = get_spec("BLS12_381")
    return get_engine(spec), _ref_ctx(spec), G1Ctx(spec, "cpu")


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
    s = np.asarray(ref.add(a, b))
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
    want = np.asarray(ref.double(s))
    np.testing.assert_array_equal(to_numpy(port.double(to_torch(s, "cpu"))), want)
    want = np.asarray(ref.add(s, a))
    np.testing.assert_array_equal(to_numpy(port.add(to_torch(s, "cpu"), to_torch(a, "cpu"))), want)


def test_add_select_matches_reference(ctx):
    eng, ref, port = ctx
    _, _, a, b, s = _relaxed_inputs(eng, ref, port)
    sel = np.array([1, 1, 0, 1, 0, 1, 1, 0], dtype=bool)
    want = np.asarray(ref.add_select(s, b, sel))
    got = port.add_select(to_torch(s, "cpu"), to_torch(b, "cpu"), torch.from_numpy(sel))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_add_and_add_select_write_into_out(ctx):
    """add_plain and addsel_plain (the kernels' plain versions, which the CPU
    wrappers run) with out= a step of a (K, 3, L, n) capture buffer: they
    return that tensor, holding the reference's values, and leave the other
    steps alone."""
    eng, ref, port = ctx
    _, _, a, b, s = _relaxed_inputs(eng, ref, port)
    sel = np.array([1, 1, 0, 1, 0, 1, 1, 0], dtype=bool)
    S, B, A = (to_torch(x, "cpu") for x in (s, b, a))
    ys = torch.full((3,) + S.shape, -1, dtype=torch.int32)
    got = g1_cuda.addsel_plain(port.F, S, B, torch.from_numpy(sel), out=ys[1])
    assert got.data_ptr() == ys[1].data_ptr()
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.add_select(s, b, sel)))
    assert torch.equal(got, g1_cuda.addsel_plain(port.F, S, B, torch.from_numpy(sel)))
    got = g1_cuda.add_plain(port.F, ys[1], A, out=ys[2])
    assert got.data_ptr() == ys[2].data_ptr()
    np.testing.assert_array_equal(to_numpy(got), np.asarray(ref.add(to_numpy(ys[1]), a)))
    assert torch.equal(got, g1_cuda.add_plain(port.F, ys[1], A))
    # G1Ctx.add_select passes out= through to the wrapper
    assert port.add_select(S, B, torch.from_numpy(sel), out=ys[0]).data_ptr() == ys[0].data_ptr()
    assert torch.equal(ys[0], ys[1])


def test_add_wrappers_refuse_a_bad_out(ctx):
    """out must be a contiguous (3, L, n) int32 tensor of the result's shape
    on the operands' device that overlaps neither operand; the wrappers and
    their plain versions raise for anything else."""
    eng, ref, port = ctx
    _, _, a, b, _ = _relaxed_inputs(eng, ref, port)
    shape = a.shape
    n = shape[-1]
    flat = torch.zeros(2 * a.size, dtype=torch.int32)
    P = flat[: a.size].view(shape).copy_(to_torch(a, "cpu"))
    Q = to_torch(b, "cpu")
    sel = torch.ones(n, dtype=torch.bool)
    bad = {
        "overlaps P": flat[a.size // 2 : a.size // 2 + a.size].view(shape),
        "is Q": Q,
        "not contiguous": torch.empty(shape[:-1] + (2 * n,), dtype=torch.int32)[..., ::2],
        "wrong shape": torch.empty(shape[:-1] + (n + 1,), dtype=torch.int32),
        "batched": torch.empty((1,) + shape, dtype=torch.int32),
        "wrong dtype": torch.empty(shape, dtype=torch.int64),
    }
    calls = (lambda o: g1_cuda.add(port.F, P, Q, out=o),
             lambda o: g1_cuda.addsel(port.F, P, Q, sel, out=o),
             lambda o: g1_cuda.add_plain(port.F, P, Q, out=o),
             lambda o: g1_cuda.addsel_plain(port.F, P, Q, sel, out=o))
    for why, out in bad.items():
        for call in calls:
            with pytest.raises(TypeError if why == "wrong dtype" else ValueError):
                call(out)
    # a buffer beside P in the same storage is fine
    ok = flat[a.size :].view(shape)
    assert torch.equal(g1_cuda.add(port.F, P, Q, out=ok), g1_cuda.add_plain(port.F, P, Q))


# the signed and mixed scan combiners: plain version, G1Ctx method, the
# reference's kernel body, whether Q is affine, whether it takes neg
_COMBINERS = {
    "addselneg": (g1_cuda.addselneg_plain, "add_select_neg", g1p_mod._addselneg_kernel, False,
                  True),
    "maddsel": (g1_cuda.maddsel_plain, "madd_select", g1p_mod._maddsel_kernel, True, False),
    "maddselneg": (g1_cuda.maddselneg_plain, "madd_select_neg", g1p_mod._maddselneg_kernel, True,
                   True),
}
_SEL = np.array([1, 1, 0, 1, 0, 1, 1, 0], dtype=bool)
_NEG = np.array([1, 0, 1, 1, 0, 0, 1, 1], dtype=bool)


def _combiner_operands(eng, ref, port, combiner):
    """The relaxed sums s, Q (affine for the mixed adds) and the masks of a
    combiner, numpy."""
    _, right, _, b, s = _relaxed_inputs(eng, ref, port)
    _, _, _, affine, signed = _COMBINERS[combiner]
    q = np.asarray(ref.encode_points_affine(right)) if affine else b
    return s, q, (_SEL, _NEG) if signed else (_SEL,)


@pytest.mark.parametrize("combiner", list(_COMBINERS))
def test_signed_and_mixed_combiners_write_into_out(ctx, combiner):
    """addselneg_plain, maddsel_plain and maddselneg_plain (which the CPU
    wrappers run) with out= a step of a (K, 3, L, n) capture buffer: they
    return that tensor, holding the values of the reference's kernel body,
    and leave the other steps alone; G1Ctx passes out= through."""
    eng, ref, port = ctx
    plain, method, body, _, _ = _COMBINERS[combiner]
    s, q, masks = _combiner_operands(eng, ref, port, combiner)
    S, Q = to_torch(s, "cpu"), to_torch(q, "cpu")
    mt = [torch.from_numpy(m) for m in masks]
    ys = torch.full((3,) + S.shape, -1, dtype=torch.int32)
    got = plain(port.F, S, Q, *mt, out=ys[1])
    assert got.data_ptr() == ys[1].data_ptr()
    np.testing.assert_array_equal(to_numpy(got), BodyG1(ref._g1).host(body, s, q, *masks))
    assert torch.equal(got, plain(port.F, S, Q, *mt))
    assert getattr(port, method)(S, Q, *mt, out=ys[2]).data_ptr() == ys[2].data_ptr()
    assert torch.equal(ys[2], ys[1])
    assert bool((ys[0] == -1).all())


@pytest.mark.parametrize("combiner", list(_COMBINERS))
def test_signed_and_mixed_combiners_refuse_a_bad_out(ctx, combiner):
    """The combiners' wrappers and plain versions refuse an out that is not
    a contiguous (3, L, n) int32 tensor of the result's shape, or that
    overlaps P or Q."""
    eng, ref, port = ctx
    plain = _COMBINERS[combiner][0]
    s, q, masks = _combiner_operands(eng, ref, port, combiner)
    shape, n = s.shape, s.shape[-1]
    flat = torch.zeros(2 * s.size, dtype=torch.int32)
    P = flat[: s.size].view(shape).copy_(to_torch(s, "cpu"))
    qflat = torch.zeros(q.size + s.size, dtype=torch.int32)
    Q = qflat[: q.size].view(q.shape).copy_(to_torch(q, "cpu"))
    mt = [torch.from_numpy(m) for m in masks]
    bad = {
        "overlaps P": flat[s.size // 2 : s.size // 2 + s.size].view(shape),
        "overlaps Q": qflat[q.size // 2 : q.size // 2 + s.size].view(shape),
        "not contiguous": torch.empty(shape[:-1] + (2 * n,), dtype=torch.int32)[..., ::2],
        "wrong shape": torch.empty(shape[:-1] + (n + 1,), dtype=torch.int32),
        "batched": torch.empty((1,) + shape, dtype=torch.int32),
        "wrong dtype": torch.empty(shape, dtype=torch.int64),
    }
    for why, out in bad.items():
        for call in (getattr(g1_cuda, combiner), plain):
            with pytest.raises(TypeError if why == "wrong dtype" else ValueError):
                call(port.F, P, Q, *mt, out=out)
    # a buffer beside P in the same storage is fine
    ok = flat[s.size :].view(shape)
    assert torch.equal(getattr(g1_cuda, combiner)(port.F, P, Q, *mt, out=ok),
                       plain(port.F, P, Q, *mt))


def _split_dbl_model(P, p, L, b3):
    """``split_dbl`` (csrc/g1_split_kernels.cu) on one lane's Python ints,
    warp by warp: the first layer's four products, each warp's middle values
    by ``rcb_dbl``'s operations in its order and its second-layer product,
    then X3, Y3, Z3 as warps 0-2 form them (relaxed [0, 2p) arithmetic, the
    CIOS product's REDC output)."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R

    def mul(a, b):
        t = a * b
        return (t + (t * npf % R) * p) // R

    def add(a, b):
        return a + b - 2 * p if a + b >= 2 * p else a + b

    def sub(a, b):
        return a - b + 2 * p if a < b else a - b

    def small(a, m):  # fp_mul_small: the add chain, MSB first
        acc = a
        for bit in bin(m)[3:]:
            acc = add(acc, acc)
            if bit == "1":
                acc = add(acc, a)
        return acc

    X, Y, Z = P
    t0, t1, zz, xy = mul(Y, Y), mul(Y, Z), mul(Z, Z), mul(X, Y)

    def mid(w):  # warp w's operands of the second layer
        if w in (1, 3):
            return (small(zz, b3) if w == 1 else t1), small(t0, 8)
        t2 = small(zz, b3)
        t0m = sub(t0, add(add(t2, t2), t2))
        return t0m, add(t0, t2) if w == 2 else xy

    dxa, dya, dyb, dz = (mul(*mid(w)) for w in range(4))
    return add(dxa, dxa), add(dya, dyb), dz


def test_split_dbl_model_equals_double_plain(ctx):
    """The four-warp doubling's order of operations, modelled on Python ints,
    equals ``double_plain`` limb for limb (held to the reference's doubling
    in ``test_add_and_double_match_reference``) on random points, their
    negations, infinity and relaxed [p, 2p) limbs."""
    eng, _, port = ctx
    left, right = _lanes(eng, seed=4)
    pts = port.encode_points(left + [eng.g1.neg(x) if x else None for x in left])
    pts = torch.cat([pts, port.add(pts[..., :8], port.encode_points(right))], dim=-1)
    L, p = port.fp.L, port.fp.p
    ints = lambda t: (t.to(torch.int64).numpy().astype(object)  # noqa: E731
                      * np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
                      ).sum(axis=1).T.tolist()
    want = ints(g1_cuda.double_plain(port.F, pts))
    assert [list(_split_dbl_model(P, p, L, port.F.b3)) for P in ints(pts)] == want


def test_dbl_add_select_neg_is_inf_match_reference(bls):
    eng, ref, port = bls
    _, _, a, b, s = _relaxed_inputs(eng, ref, port, seed=1)
    sel = np.array([0, 1, 1, 1, 0, 1, 0, 1], dtype=bool)
    want = np.asarray(ref.dbl_add_select(s, a, sel))
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
    want = np.asarray(ref.scalar_mul(pts, scs))
    got = port.scalar_mul(to_torch(pts, "cpu"), to_torch(scs, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert port.decode_points(got) == [eng.g1.mul(P, k) if P else None for P, k in zip(base, ks)]

