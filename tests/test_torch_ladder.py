"""The six-warp ladder behind ``g1_cuda.smul`` and ``g1_cuda.smul_static``
(``g1_smul_ladder_kernel`` in ``csrc/g1_split_kernels.cu``, per-lane scalars
or, with STATIC, one bit string for every lane), modelled on Python integers
in the kernel's order of operations, against ``smul_plain`` and
``smul_static_plain``.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py`` holds it to
``smul_plain`` there).  Here its schedule is checked without one: per bit the
doubling's two layers of products (warps 0-3), the block's shortcut where no
lane has the bit, the add's two layers (warps 0-5), and the select that the
next step's first layer and the final store make by reading the accumulator
from the doubling's or the add's slots.  Every field operation is the
kernel's relaxed [0, 2p) one; ``smul_plain`` is held to the reference's
ladder in ``tests/test_torch_g1.py``.  Tolerance: exact limb equality.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import g1_cuda

torch.set_num_threads(1)


def _field(p, L):
    """The kernels' relaxed field operations on Python ints: the CIOS
    product's REDC output, add and sub kept in [0, 2p), and fp_mul_small's
    add chain."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R

    def mul(a, b):
        t = a * b
        return (t + (t * npf % R) * p) // R

    def add(a, b):
        return a + b - 2 * p if a + b >= 2 * p else a + b

    def sub(a, b):
        return a - b + 2 * p if a < b else a - b

    def small(a, m):
        acc = a
        for bit in bin(m)[3:]:
            acc = add(acc, acc)
            if bit == "1":
                acc = add(acc, a)
        return acc

    return mul, add, sub, small


def _steps(p, L, b3):
    """The kernels' layers on Python ints: dbl(X, Y, Z) gives the doubling's
    second layer d = (dxa, dya, dz, dyb) (its first layer on warps 0-3,
    the middle values, the second layer), add(P1, P2) the add's second layer
    g = (xa, xb, ya, yb, za, zb) (its first layer on warps 0-5, rcb_mid,
    the second layer), and point(d, g, use_sum) the point the kernels'
    LadderPoint reads from them: D = (dxa + dxa, dya + dyb, dz), or A = D + Q
    from g."""
    mul, add, sub, small = _field(p, L)

    def dbl(X, Y, Z):
        t0, t1, zz, xy = mul(Y, Y), mul(Y, Z), mul(Z, Z), mul(X, Y)
        z3t = small(t0, 8)
        t2 = small(zz, b3)
        t0m = sub(t0, add(add(t2, t2), t2))
        y3t = add(t0, small(zz, b3))
        return [mul(t0m, xy), mul(small(zz, b3), z3t), mul(t1, z3t), mul(t0m, y3t)]

    def add_pts(P1, P2):
        (X1, Y1, Z1), (X2, Y2, Z2) = P1, P2
        t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
        s3 = mul(add(X1, Y1), add(X2, Y2))
        s4 = mul(add(Y1, Z1), add(Y2, Z2))
        s5 = mul(add(X1, Z1), add(X2, Z2))
        t3 = sub(s3, add(t0, t1))
        t4 = sub(s4, add(t1, t2))
        lnb = small(sub(s5, add(t0, t2)), b3)
        t0_3 = add(add(t0, t0), t0)
        z3t = add(t1, small(t2, b3))
        t1m = sub(t1, small(t2, b3))
        return [mul(t3, t1m), mul(t4, lnb), mul(t1m, z3t), mul(lnb, t0_3),
                mul(z3t, t4), mul(t0_3, t3)]

    def point(d, g, use_sum):
        if use_sum:
            return sub(g[0], g[1]), add(g[2], g[3]), add(g[4], g[5])
        return add(d[0], d[0]), add(d[1], d[3]), d[2]

    return dbl, add_pts, point


def _ladder_model(Q, ks, nbits, p, L, b3, block=32, bits=None):
    """``g1_smul_ladder_kernel`` on lanes of Python ints: Q a list of (X, Y,
    Z), ks the scalars, ``block`` lanes a block; with ``bits`` (the STATIC
    kernel) ks is unused and step b's bit is bits[nbits - 1 - b], MSB-first,
    for every lane.  Each lane keeps the
    doubling's second layer d = (dxa, dya, dz, dyb), the add's second layer
    g = (xa, xb, ya, yb, za, zb) and its last bit, and reads acc from them as
    the kernel's LadderPoint does.  Returns the points and how many
    (block, bit) steps skipped the add and ran it."""
    dbl, add_pts, point = _steps(p, L, b3)
    one = (1 << (16 * L)) % p
    n = len(Q)
    d = [[0, one, 0, 0] for _ in range(n)]  # acc = infinity, as a D
    g = [[0] * 6 for _ in range(n)]
    bit = [False] * n
    skipped = added = 0
    for b in range(nbits - 1, -1, -1):
        for i in range(n):  # the doubling, from acc
            d[i] = dbl(*point(d[i], g[i], bit[i]))
        for lo in range(0, n, block):
            lanes = range(lo, min(lo + block, n))
            got = {i: bits[nbits - 1 - b] == 1 if bits else (ks[i] >> b) & 1 == 1
                   for i in lanes}
            for i in lanes:
                bit[i] = got[i]
            if not any(got.values()):  # no lane of the block adds: acc = D
                skipped += 1
                continue
            added += 1
            for i in lanes:  # the add, D + Q
                g[i] = add_pts(point(d[i], g[i], False), Q[i])
    return [point(d[i], g[i], bit[i]) for i in range(n)], skipped, added


def _dbladd_model(P, Q, sel, p, L, b3, block=32):
    """``g1_dbladd_kernel`` on lanes of Python ints: P and Q lists of (X, Y,
    Z) (staged into the slots), sel a list of bools, ``block`` lanes a
    block.  The doubling's layers read P; a block none of whose lanes has
    sel skips the add, the others run D + Q; each lane stores LadderPoint
    {d, g, sel}.  Returns the points and how many blocks skipped the add and
    ran it."""
    dbl, add_pts, point = _steps(p, L, b3)
    n = len(P)
    d = [dbl(*P[i]) for i in range(n)]
    g = [None] * n  # unwritten: a read of the add's slots fails
    skipped = added = 0
    for lo in range(0, n, block):
        lanes = range(lo, min(lo + block, n))
        if not any(sel[i] for i in lanes):
            skipped += 1
            continue
        added += 1
        for i in lanes:
            g[i] = add_pts(point(d[i], g[i], False), Q[i])
    return [point(d[i], g[i], sel[i]) for i in range(n)], skipped, added


def _ints(t, L):
    """(3, L, B) limbs -> [(X, Y, Z)] Python ints per lane."""
    w = np.array([1 << (16 * k) for k in range(L)], dtype=object)
    v = (t.to(torch.int64).numpy().astype(object) * w[None, :, None]).sum(axis=1)
    return [tuple(v[:, i]) for i in range(v.shape[1])]


@pytest.fixture(params=["BLS12_381", "BN254"], scope="module")
def ladder_case(request):
    """Eight lanes of one curve: relaxed [p, 2p) limbs (sums of two encoded
    points), Q at infinity on one lane, scalars 0, 1, r - 1 and random; and
    smul_plain's output over the full nbits."""
    spec = get_spec(request.param)
    eng, g1 = get_engine(spec), G1Ctx(spec, "cpu")
    rng = random.Random(14)
    pts = [eng.g1.mul(eng.gen_g1, rng.randrange(1, spec.r)) for _ in range(16)]
    Q = g1_cuda.add_plain(g1.F, g1.encode_points(pts[:8]), g1.encode_points(pts[8:]))
    Q[..., 3] = g1.inf[..., 0]
    ks = [0, 1, spec.r - 1] + [rng.randrange(spec.r) for _ in range(5)]
    want = g1_cuda.smul_plain(g1.F, Q, g1.encode_scalars(ks), g1.nbits)
    return g1, Q, ks, want


@pytest.mark.parametrize("block", [32, 2])
def test_ladder_model_equals_smul_plain(ladder_case, block):
    """The ladder's schedule on Python ints equals smul_plain limb for limb,
    at the kernel's 32-lane blocks (one block here) and at 2-lane blocks,
    where the block of scalars 0 and 1 takes the shortcut at every bit but
    the last: both paths are taken in each case."""
    g1, Q, ks, want = ladder_case
    L, p = g1.fp.L, g1.fp.p
    got, skipped, added = _ladder_model(_ints(Q, L), ks, g1.nbits, p, L, g1.F.b3, block)
    assert got == _ints(want, L)
    assert skipped > 0 and added > 0
    assert any(v[0] != 0 and v[0] < p for v in _ints(Q, L)) and any(
        c >= p for v in _ints(Q, L) for c in v)  # canonical and relaxed limbs both occur


@pytest.mark.parametrize("ladder_case", ["BLS12_381"], indirect=True)
@pytest.mark.parametrize("scalar", ["h_eff", "255-bit"])
def test_static_ladder_model_equals_smul_static_plain(ladder_case, scalar):
    """The STATIC ladder's schedule on Python ints (the step's bit read from
    one MSB-first bit string, the add's layers skipped at its zero bits)
    equals smul_static_plain limb for limb on BLS12-381's eight lanes (Q at
    infinity on one, relaxed limbs), for h_eff (64 bits, 7 ones: the
    cofactor clearing of ``hash_to_g1_batch(sign="none")``) and a 255-bit
    scalar."""
    g1, Q, _, _ = ladder_case
    L, p = g1.fp.L, g1.fp.p
    if scalar == "h_eff":
        bits = [int(b) for b in bin(0xD201000000010001)[2:]]
        assert len(bits) == 64 and sum(bits) == 7
    else:
        k = int.from_bytes(np.random.default_rng(17).bytes(32), "big")
        bits = [int(b) for b in bin(k % (1 << 255) | (1 << 254))[2:]]
        assert len(bits) == 255
    want = g1_cuda.smul_static_plain(g1.F, Q, bits)
    got, skipped, added = _ladder_model(_ints(Q, L), None, len(bits), p, L, g1.F.b3, bits=bits)
    assert got == _ints(want, L)
    assert (skipped, added) == (len(bits) - sum(bits), sum(bits))
    assert g1.decode_points(want)[3] is None


def _dbladd_lanes(g1, eng, spec, rng):
    """Ten lanes P, Q of one curve in relaxed limbs (each a host point plus
    infinity by the plain add) and sel, for 2-lane blocks: lanes 0-1 random
    pairs, neither selected; 2-3 P = infinity, Q = infinity, both selected;
    4-5 both at infinity, 2P = Q; 6-7 2P = -Q, a random pair; 8-9 random."""
    pts = [eng.g1.mul(eng.gen_g1, rng.randrange(1, spec.r)) for _ in range(12)]
    A = [pts[0], pts[1], None, pts[2], None, pts[3], pts[4], pts[5], pts[6], pts[7]]
    B = [pts[8], pts[9], pts[10], None, None, eng.g1.add(pts[3], pts[3]),
         eng.g1.neg(eng.g1.add(pts[4], pts[4])), pts[11], pts[0], pts[6]]
    inf = g1.encode_points([None] * len(A))
    P, Q = g1.add(g1.encode_points(A), inf), g1.add(g1.encode_points(B), inf)
    sel = [False, False, True, True, True, True, True, False, False, True]
    return P, Q, sel, A, B


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_dbladd_model_equals_dbladd_plain(curve):
    """dbladd's one bit of the ladder (P and Q staged, the doubling's layers
    from P, the block shortcut, the add, the select of LadderPoint) on
    Python ints equals dbladd_plain limb for limb on the edge lanes (P or Q
    or both at infinity, 2P = Q, 2P = -Q) and random pairs, in 2-lane
    blocks (one with no lane selected, one with both) and in one 32-lane
    block; and canonically the host engine's 2P + Q or 2P."""
    spec = get_spec(curve)
    eng, g1 = get_engine(spec), G1Ctx(spec, "cpu")
    L, p = g1.fp.L, g1.fp.p
    P, Q, sel, A, B = _dbladd_lanes(g1, eng, spec, random.Random(19))
    want = g1_cuda.dbladd_plain(g1.F, P, Q, torch.tensor(sel))
    for block, shortcut in ((2, 1), (32, 0)):
        got, skipped, added = _dbladd_model(_ints(P, L), _ints(Q, L), sel, p, L, g1.F.b3, block)
        assert got == _ints(want, L), block
        assert (skipped, added) == (shortcut, -(-len(sel) // block) - shortcut)
    host = [eng.g1.add(eng.g1.add(a, a), b) if s else eng.g1.add(a, a)
            for a, b, s in zip(A, B, sel)]
    assert g1.decode_points(want) == host
    assert any(c >= p for v in _ints(P, L) + _ints(Q, L) for c in v)  # relaxed limbs occur
