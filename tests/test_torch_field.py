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
from mathlib_tpu_torch.ops.kernels import fp_cuda

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


BINARY = ["add", "sub", "mont_mul", "eq"]
UNARY = ["neg", "sqr", "canon", "to_mont", "from_mont", "is_zero"]
_REF_OUT = {}


def _ref_out(fields, op):
    """The reference's output of ``op`` on the seeded inputs: every binary
    and unary op of a field in one jit (one XLA compile a field, not ten),
    made at the field's first test and shared by its other cases."""
    ref, _ = fields
    if ref.p not in _REF_OUT:
        a, b = _pair(fields)
        outs = jax.jit(lambda x, y: ([getattr(ref, o)(x, y) for o in BINARY]
                                     + [getattr(ref, o)(x) for o in UNARY]))(a, b)
        _REF_OUT[ref.p] = {o: np.asarray(v) for o, v in zip(BINARY + UNARY, outs)}
    return _REF_OUT[ref.p][op]


@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_match_reference(fields, op):
    ref, port = fields
    a, b = _pair(fields)
    want = _ref_out(fields, op)
    got = to_numpy(getattr(port, op)(to_torch(a, "cpu"), to_torch(b, "cpu")))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("op", UNARY)
def test_unary_ops_match_reference(fields, op):
    ref, port = fields
    a, _ = _pair(fields)
    want = _ref_out(fields, op)
    got = to_numpy(getattr(port, op)(to_torch(a, "cpu")))
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_mul_int_matches_reference(fields):
    ref, port = fields
    a, _ = _pair(fields)
    ns = (0, 1, 3, 8, 12, ref.p - 5)  # p - 5 takes the -(p - n) path
    # the reference's six chains in one jit (one compile, not six)
    wants = jax.jit(lambda x: tuple(ref.mul_int(x, n) for n in ns))(a)
    for n, want in zip(ns, wants):
        got = to_numpy(port.mul_int(to_torch(a, "cpu"), n))
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"n={n}")


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


def _mont_group_model(a, b, p, L):
    """``mont_mul_group_kernel`` (csrc/fp_kernels.cu) for one element on
    Python ints, thread by thread: G = 4 threads, thread g holding words
    [g K, g K + K) of the CIOS accumulator and an overlap word at g K + K
    (K = NW / G); per word b_i, m_i from thread 0's lowest word (shuffled to
    all), each thread's PTX chains over its words (low halves, then high
    halves one word up, for a_j b_i and m_i p_j), the shift taking thread
    g + 1's lowest word into thread g's overlap; then the overlap words
    carried up a thread a round.  Returns the NW result words as one int."""
    NW, M, G = L // 2, (1 << 32) - 1, 4
    K = NW // G
    R = 1 << (32 * NW)
    np0 = (-pow(p, -1, R)) % (1 << 32)
    aw, bw, pw = ([(v >> (32 * j)) & M for j in range(NW)] for v in (a, b, p))
    t = [[0] * (K + 1) for _ in range(G)]
    for i in range(NW):
        m = ((t[0][0] + aw[0] * bw[i]) * np0) & M
        X = []
        for g in range(G):
            x, pg = aw[g * K:(g + 1) * K], pw[g * K:(g + 1) * K]
            # four carry chains over positions 0..K+1, as the kernel's PTX
            w, c = list(t[g][:K]) + [t[g][K], 0], 0
            for j in range(K):  # low halves of a_j b_i into 0..K-1, carry on
                s = w[j] + ((x[j] * bw[i]) & M) + c
                w[j], c = s & M, s >> 32
            s = w[K] + c
            w[K], w[K + 1] = s & M, s >> 32
            c = 0
            for j in range(K):  # high halves into 1..K
                s = w[j + 1] + ((x[j] * bw[i]) >> 32) + c
                w[j + 1], c = s & M, s >> 32
            w[K + 1] += c
            c = 0
            for j in range(K):  # low halves of m p_j
                s = w[j] + ((m * pg[j]) & M) + c
                w[j], c = s & M, s >> 32
            s = w[K] + c
            w[K], w[K + 1] = s & M, w[K + 1] + (s >> 32)
            c = 0
            for j in range(K):  # high halves of m p_j
                s = w[j + 1] + ((m * pg[j]) >> 32) + c
                w[j + 1], c = s & M, s >> 32
            w[K + 1] += c
            X.append(w)
        assert X[0][0] == 0  # the word that leaves
        for g in range(G):
            above = X[g + 1][0] if g + 1 < G else 0
            top = X[g][K] + above
            t[g] = X[g][1:K] + [top & M, X[g][K + 1] + (top >> 32)]
    for r in range(1, G):  # the overlap word of thread r - 1 into thread r
        c = t[r - 1][K]
        for j in range(K + 1):
            s = t[r][j] + c
            t[r][j], c = s & M, s >> 32
    assert t[G - 1][K] == 0
    return sum(t[g][j] << (32 * (g * K + j)) for g in range(G) for j in range(K))


@pytest.mark.parametrize("name", ["BLS12_381", "BN254"])
def test_mont_group_model_equals_mont_mul_plain(name):
    """The grouped Montgomery product (four threads an element), modelled on
    Python ints, equals ``mont_mul_plain`` on the edge values 0, 1, p - 1,
    p, 2p - 1 against each other and on random relaxed values, elementwise
    and with one (L, 1) constant operand, at L = 24 and 16."""
    p = get_spec(name).p
    port = FpCtx(p, "cpu")
    L = port.L
    rng = random.Random(7)
    edge = [0, 1, p - 1, p, 2 * p - 1]
    a = [x for x in edge for _ in edge] + [rng.randrange(2 * p) for _ in range(7)]
    b = [y for _ in edge for y in edge] + [rng.randrange(2 * p) for _ in range(7)]
    c = rng.randrange(2 * p)
    limbs = lambda vs: torch.from_numpy(  # noqa: E731
        np.stack([int_to_limbs(v, L) for v in vs], axis=1).astype(np.int32))
    for bs, bt in ((b, limbs(b)), ([c] * len(a), limbs([c]))):
        got = [_mont_group_model(x, y, p, L) for x, y in zip(a, bs)]
        want = fp_cuda.mont_mul_plain(port, limbs(a), bt).to(torch.int64).numpy().astype(object)
        assert got == list((want * np.array([1 << (16 * k) for k in range(L)],
                                            dtype=object)[:, None]).sum(axis=0))
