"""The G2 ladder body behind ``g2_cuda.smul`` and ``g2_cuda.smul_static``
(``g2_ladder_kernel`` in ``csrc/g2_smul_kernels.cu``), and the add,
doubling, addsel and dblsel kernels on its steps behind ``g2_cuda.add``,
``g2_cuda.double``, ``g2_cuda.addsel`` and ``g2_cuda.dblsel``
(``g2_add_kernel``, ``g2_double_kernel``, ``g2_addsel_kernel`` in
``csrc/g2_point_kernels.cu``, ``g2_dblsel_kernel`` in
``csrc/g2_dblsel_kernels.cu``; the step code they share in
``csrc/g2_step.cuh``), modelled on Python integers in the kernels' order of
operations and on their slot layouts.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py`` holds them
to the plain versions there).  Here their schedule is checked without one:
one half of a ladder bit (``half_bit``) is the doubling's or the add's first
layer of base-field products (each Fp2 product split into its three
Karatsuba pieces, one a worker), the Fp2 products combined from the pieces,
the middle values formed from those, the second layer, and the result.  Per
bit the ladder runs the doubling into the other point buffer, the block's
shortcut where no lane has the bit, then the add and the select acc = bit ?
A : D that writes into the accumulator's buffer; the add and doubling
kernels stage P (and Q), run their half once and store every lane's result.
Every field operation is the kernel's relaxed [0, 2p) one.  Held limb for
limb against ``smul_plain`` and ``smul_static_plain`` on short bit strings
(those are held to the reference's kernel bodies in
``tests/test_torch_g2_ladders.py``), canonically against the host engine at
full length, and limb for limb against ``add_plain`` and ``double_plain``
(held to the reference's ``_add_kernel`` and ``_double_kernel`` bodies in
``tests/test_torch_g2.py``); the dblsel kernel (``g2_dblsel_kernel``: P
and Q staged into the ladder's slots, one bit with acc read from P) limb
for limb against ``dblsel_plain`` (held to ``_dblsel_kernel``'s body
there); the addsel kernel (``g2_addsel_kernel``: the add's body with the
select at its store, a block with no lane selected storing Q) limb for
limb against ``addsel_plain`` (held to ``_addsel_kernel``'s body there).
Tolerance: exact.
"""

import random
from typing import NamedTuple

import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.hash import get_hash_g2_ctx
from mathlib_tpu_torch.ops.kernels import g2_cuda

torch.set_num_threads(1)

# the Fp2 operands of each layer's products, as the kernel's tables: the
# first layers' point operands (0-2 a coordinate, 3 X + Y, 4 Y + Z, 5 X + Z)
# [h][e], h = 0 the doubling, 1 the add; the second layers' values as
# ("F", e) a first-layer Fp2 product or ("M", m) a middle value
PT_A = ((1, 1, 2, 0), (0, 1, 2, 3, 4, 5))
PT_B = ((1, 2, 2, 1), (0, 1, 2, 3, 4, 5))
MID_A = ((("M", 0), ("M", 1), ("M", 0), ("F", 1)),
         (("M", 0), ("M", 1), ("M", 5), ("M", 2), ("M", 4), ("M", 3)))
MID_B = ((("F", 3), ("M", 2), ("M", 3), ("M", 2)),
         (("M", 5), ("M", 2), ("M", 4), ("M", 3), ("M", 1), ("M", 0)))


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


class Slots(NamedTuple):
    """Where a block's shared slots start (``Slots`` in ``csrc/g2_step.cuh``):
    the point buffers, Q, a layer's products K, the first layer's Fp2
    products F, the middle values M, and the slot count."""

    pt: int
    q: int
    k: int
    f: int
    m: int
    n: int


LADDER = Slots(0, 12, 18, 36, 48, 60)  # acc and D, Q, K 18, F 12, M 12
ADD = Slots(0, 6, 12, 30, 42, 54)  # P, Q, K 18, F 12, M 12 (the add and addsel)
DBL = Slots(0, 0, 6, 18, 26, 34)  # P, K 12, F 8, M 8 (no Q)


class _HalfBit:
    """``half_bit`` on one lane's slots: a list of ``S.n`` Python ints, None
    where nothing was written yet (so a read of such a slot fails).  Each
    step computes every worker's value from the slots, then writes them all:
    the barrier after it."""

    def __init__(self, p, L, b3, S):
        self.mul, self.add, self.sub, self.small = _field(p, L)
        self.b3, self.S = b3, S

    def kara(self, sm, e, j):  # component j of Fp2 product e from its pieces
        K = self.S.k
        t0, t1 = sm[K + 3 * e], sm[K + 3 * e + 1]
        return self.sub(t0, t1) if j == 0 else self.sub(sm[K + 3 * e + 2], self.add(t0, t1))

    def b3_comp(self, a0, a1, j):  # f2_mul_b3's branches
        (c0, c1), add, sub, small = self.b3, self.add, self.sub, self.small
        if c1 == 0:
            return small(a1 if j else a0, c0)
        if c0 == 0:
            return small(a0, c1) if j else sub(0, small(a1, c1))
        if c0 == c1:
            return small(add(a0, a1) if j else sub(a0, a1), c0)
        if j == 0:
            return sub(small(a0, c0), small(a1, c1))
        return add(small(a1, c0), small(a0, c1))

    def pt_get(self, sm, P, x, j):  # coordinate x < 3, or X + Y, Y + Z, X + Z
        if x < 3:
            return sm[P + 2 * x + j]
        c0, c1 = (1 if x == 4 else 0), (1 if x == 3 else 2)
        return self.add(sm[P + 2 * c0 + j], sm[P + 2 * c1 + j])

    def piece(self, get, pc):  # Karatsuba piece: a0, a1, a0 + a1
        return get(pc) if pc < 2 else self.add(get(0), get(1))

    def value(self, ref, j):  # the slot of a second-layer operand's component j
        kind, idx = ref
        return (self.S.f if kind == "F" else self.S.m) + 2 * idx + j

    def product(self, sm, h, lay, x, A):
        e, pc = divmod(x, 3)
        if lay == 0:
            B = A if h == 0 else self.S.q
            a = self.piece(lambda j: self.pt_get(sm, A, PT_A[h][e], j), pc)
            b = self.piece(lambda j: self.pt_get(sm, B, PT_B[h][e], j), pc)
        else:
            a = self.piece(lambda j: sm[self.value(MID_A[h][e], j)], pc)
            b = self.piece(lambda j: sm[self.value(MID_B[h][e], j)], pc)
        return self.mul(a, b)

    def dbl_mid(self, sm, m, j):  # t0m, t2, z3t, y3t from t0, t1, zz, xy
        F, add, sub = self.S.f, self.add, self.sub
        if m == 2:
            return self.small(sm[F + j], 8)
        t2 = self.b3_comp(sm[F + 4], sm[F + 5], j)
        if m == 1:
            return t2
        return add(sm[F + j], t2) if m == 3 else sub(sm[F + j], add(add(t2, t2), t2))

    def add_mid(self, sm, m, j):  # t3, t4, lnb, t0_3, z3t, t1m from t0, t1, t2, s3, s4, s5
        F, add, sub = self.S.f, self.add, self.sub
        if m < 2:
            return sub(sm[F + 2 * (m + 3) + j], add(sm[F + 2 * m + j], sm[F + 2 * (m + 1) + j]))
        if m == 2:
            ln = [sub(sm[F + 10 + c], add(sm[F + c], sm[F + 4 + c])) for c in (0, 1)]
            return self.b3_comp(ln[0], ln[1], j)
        if m == 3:
            return add(add(sm[F + j], sm[F + j]), sm[F + j])
        t2b = self.b3_comp(sm[F + 4], sm[F + 5], j)
        return add(sm[F + 2 + j], t2b) if m == 4 else sub(sm[F + 2 + j], t2b)

    def point_out(self, sm, h, c, j):
        add, kara = self.add, self.kara
        if h == 0:
            if c == 0:
                return add(kara(sm, 0, j), kara(sm, 0, j))
            return add(kara(sm, 1, j), kara(sm, 2, j)) if c == 1 else kara(sm, 3, j)
        a, b = kara(sm, 2 * c, j), kara(sm, 2 * c + 1, j)
        return self.sub(a, b) if c == 0 else add(a, b)

    def run(self, sm, h, A, take=True, keep=0):
        """Steps 1-5 of the doubling (h = 0) of the point in slots A, or the
        add (h = 1) of the points in slots A and Q; returns the six
        components of the result where take holds, else slots keep's."""
        S = self.S
        nx, nf = (12, 8) if h == 0 else (18, 12)
        mid = self.dbl_mid if h == 0 else self.add_mid
        # 1. the first layer, one product a worker
        sm[S.k:S.k + nx] = [self.product(sm, h, 0, x, A) for x in range(nx)]
        # 2. its Fp2 products
        sm[S.f:S.f + nf] = [self.kara(sm, v >> 1, v & 1) for v in range(nf)]
        # 3. the middle values
        sm[S.m:S.m + nf] = [mid(sm, v >> 1, v & 1) for v in range(nf)]
        # 4. the second layer
        sm[S.k:S.k + nx] = [self.product(sm, h, 1, x, A) for x in range(nx)]
        # 5. the result, or slots keep
        if take:
            return [self.point_out(sm, h, v >> 1, v & 1) for v in range(6)]
        return sm[keep:keep + 6]


def _lane_slots(S):
    return [None] * S.n


def _ladder_model(Q, p, L, b3, block, ks=None, nbits=0, bits=None):
    """``g2_ladder_kernel`` on lanes of Python ints: Q a list of six ints per
    lane (coordinate c's component j at 2c + j); per-lane scalars ks over
    nbits bits (MSB first), or one MSB-first bit list shared by every lane;
    ``block`` lanes a block.  Each lane has the kernel's slots (``LADDER``):
    two point buffers, Q, a layer's 18 products K, the first layer's Fp2
    products F and the middle values M.  Returns the points and how many
    (block, bit) steps skipped the add and ran it."""
    S = LADDER
    half = _HalfBit(p, L, b3, S)
    one = (1 << (16 * L)) % p
    n = len(Q)
    sms = [_lane_slots(S) for _ in range(n)]
    for i in range(n):  # Q; acc = infinity
        sms[i][S.q:S.q + 6] = Q[i]
        sms[i][S.pt:S.pt + 6] = [0, 0, one, 0, 0, 0]
    cur = [0] * ((n + block - 1) // block)
    steps = len(bits) if bits is not None else nbits
    skipped = added = 0
    for blk, lo in enumerate(range(0, n, block)):
        lanes = range(lo, min(lo + block, n))
        for step in range(steps):
            A, D = S.pt + 6 * cur[blk], S.pt + 6 * (cur[blk] ^ 1)
            lane_bit = {}
            for i in lanes:  # D = 2 acc into the other buffer; the lanes' bits
                sms[i][D:D + 6] = half.run(sms[i], 0, A)
                if bits is not None:
                    lane_bit[i] = bits[step] == 1
                else:
                    lane_bit[i] = (ks[i] >> (nbits - 1 - step)) & 1 == 1
            if not any(lane_bit.values()):  # acc = D
                cur[blk] ^= 1
                skipped += 1
                continue
            added += 1
            for i in lanes:  # acc = bit ? D + Q : D, into acc's buffer
                sms[i][A:A + 6] = half.run(sms[i], 1, D, take=lane_bit[i], keep=D)
    return ([sms[i][S.pt + 6 * cur[i // block]:][:6] for i in range(n)], skipped, added)


def _step_model(P, p, L, b3, Q=None):
    """``g2_add_kernel`` (Q given) or ``g2_double_kernel`` (Q None) on lanes
    of Python ints: each lane's P (and Q) staged into the kernel's slots
    (``ADD``: 54, ``DBL``: 34), the add's or the doubling's five steps once,
    every lane taking the result (no select), which goes straight out."""
    S = ADD if Q is not None else DBL
    half = _HalfBit(p, L, b3, S)
    out = []
    for i, lane in enumerate(P):
        sm = _lane_slots(S)
        sm[S.pt:S.pt + 6] = lane
        if Q is not None:
            sm[S.q:S.q + 6] = Q[i]
        out.append(half.run(sm, 0 if Q is None else 1, S.pt))
        assert len(sm) == S.n  # no step wrote past the layout's slots
    return out


def _dblsel_model(P, Q, sel, p, L, b3, block):
    """``g2_dblsel_kernel`` on lanes of Python ints: each lane's P staged
    into point buffer 0 and Q into the Q slots of the ladder's layout
    (``LADDER``, no scalar limbs; its unwritten slots stay None), the
    doubling's half into buffer 1 (D), then per block of ``block`` lanes:
    none selected, every lane stores D; else the add's half D + Q, whose
    step 5 gives sel ? A : D.  Returns the points and how many blocks
    skipped the add and ran it."""
    S = LADDER
    half = _HalfBit(p, L, b3, S)
    D = S.pt + 6
    sms = []
    for i, lane in enumerate(P):
        sm = _lane_slots(S)
        sm[S.pt:S.pt + 6] = lane
        sm[S.q:S.q + 6] = Q[i]
        sm[D:D + 6] = half.run(sm, 0, S.pt)
        sms.append(sm)
    out = [None] * len(P)
    skipped = added = 0
    for lo in range(0, len(P), block):
        lanes = range(lo, min(lo + block, len(P)))
        if not any(sel[i] for i in lanes):  # out = D
            skipped += 1
            for i in lanes:
                out[i] = sms[i][D:D + 6]
            continue
        added += 1
        for i in lanes:
            out[i] = half.run(sms[i], 1, D, take=sel[i], keep=D)
    assert all(len(sm) == S.n for sm in sms)  # no step wrote past the layout's slots
    return out, skipped, added


def _addsel_model(P, Q, sel, p, L, b3, block):
    """``g2_addsel_kernel`` (the add's body with the select) on lanes of
    Python ints: each lane's P and Q staged into the add's slots (``ADD``),
    then per block of ``block`` lanes: none selected, every lane stores Q
    after staging (no add); else the add's half, whose step 5 gives
    sel ? A : Q, Q read back from its slots after the add's four steps.
    Returns the points and how many blocks skipped the add and ran it."""
    S = ADD
    half = _HalfBit(p, L, b3, S)
    out = [None] * len(P)
    skipped = added = 0
    for lo in range(0, len(P), block):
        lanes = range(lo, min(lo + block, len(P)))
        sms = {i: _lane_slots(S) for i in lanes}
        for i in lanes:
            sms[i][S.pt:S.pt + 6] = P[i]
            sms[i][S.q:S.q + 6] = Q[i]
        if not any(sel[i] for i in lanes):  # out = Q
            skipped += 1
            for i in lanes:
                out[i] = sms[i][S.q:S.q + 6]
            continue
        added += 1
        for i in lanes:
            out[i] = half.run(sms[i], 1, S.pt, take=sel[i], keep=S.q)
            assert len(sms[i]) == S.n  # no step wrote past the layout's slots
    return out, skipped, added


def _ints(t, L):
    """(3, 2, L, B) limbs -> per lane six Python ints, 2c + j."""
    v = t.to(torch.int64).reshape(6, L, -1).tolist()
    return [[sum(v[q][m][i] << (16 * m) for m in range(L)) for q in range(6)]
            for i in range(t.shape[-1])]


def _limbs(lanes, L):
    """Per lane six Python ints -> (3, 2, L, B) int32 limbs."""
    rows = [[[(lane[q] >> (16 * m)) & 0xFFFF for lane in lanes] for m in range(L)]
            for q in range(6)]
    return torch.tensor(rows, dtype=torch.int32).reshape(3, 2, L, len(lanes))


@pytest.fixture(scope="module")
def g2_case():
    """Eight BLS12-381 lanes: relaxed limbs (sums of two encoded points), Q
    at infinity on one lane; the hash context's two cofactor bit strings."""
    spec = get_spec("BLS12_381")
    eng, ctx = get_engine(spec), get_hash_g2_ctx(spec, "cpu")
    g2 = ctx.g2
    rng = random.Random(15)
    pts = [eng.g2.mul(eng.gen_g2, rng.randrange(1, spec.r)) for _ in range(16)]
    Q = g2_cuda.add_plain(g2.rows, g2.encode_points(pts[:8]), g2.encode_points(pts[8:]))
    Q[..., 5] = g2.inf[..., 0]
    host = [eng.g2.add(a, b) for a, b in zip(pts[:8], pts[8:])]
    host[5] = None
    return eng, ctx, Q, host


@pytest.mark.parametrize("block", [32, 2])
def test_g2_ladder_model_equals_smul_plain(g2_case, block):
    """12-bit scalars 0, 0, 1, 2^12 - 1 and random: at 2-lane blocks the
    first block never adds (the shortcut at every bit), at 32 every step
    adds somewhere; limb for limb against smul_plain."""
    eng, ctx, Q, _ = g2_case
    g2, fp = ctx.g2, ctx.fp
    nbits = 12
    rng = random.Random(block)
    ks = [0, 0, 1, (1 << nbits) - 1] + [rng.randrange(1 << nbits) for _ in range(4)]
    want = g2_cuda.smul_plain(g2.rows, Q, g2.encode_scalars(ks), nbits)
    got, skipped, added = _ladder_model(_ints(Q, fp.L), fp.p, fp.L, g2.rows.b3, block, ks=ks,
                                        nbits=nbits)
    assert got == _ints(want, fp.L)
    assert added > 0 and (skipped >= nbits if block == 2 else skipped == 0)
    assert any(c >= fp.p for lane in _ints(Q, fp.L) for c in lane)  # relaxed limbs occur


@pytest.mark.parametrize("which", [1, 2])
def test_g2_static_model_equals_smul_static_plain(g2_case, which):
    """The first 16 bits of each cofactor string, shared by every lane (a
    zero bit skips the add for the whole block); limb for limb against
    smul_static_plain."""
    eng, ctx, Q, _ = g2_case
    g2, fp = ctx.g2, ctx.fp
    bits = [int(b) for b in (ctx.x_bits_1 if which == 1 else ctx.x_bits_2)[:16]]
    want = g2_cuda.smul_static_plain(g2.rows, Q, bits)
    got, skipped, added = _ladder_model(_ints(Q, fp.L), fp.p, fp.L, g2.rows.b3, 32, bits=bits)
    assert got == _ints(want, fp.L)
    assert skipped == bits.count(0) and added == bits.count(1)


@pytest.mark.parametrize("which", ["smul", "static1", "static2"])
def test_g2_ladder_model_at_full_length_equals_the_host_engine(g2_case, which):
    """The per-lane ladder over r.bit_length() bits (k = r - 1, 0 and
    random) and each whole cofactor string, against the host engine's
    ``mul`` on the decoded points."""
    eng, ctx, Q, host = g2_case
    g2, fp, r = ctx.g2, ctx.fp, ctx.g2.spec.r
    lanes = [0, 1, 5, 6]
    q = [_ints(Q, fp.L)[i] for i in lanes]
    if which == "smul":
        rng = random.Random(151)
        ks = [r - 1, 0, rng.randrange(r), rng.randrange(r)]
        got, _, _ = _ladder_model(q, fp.p, fp.L, g2.rows.b3, 32, ks=ks, nbits=g2.nbits)
    else:
        bits = [int(b) for b in (ctx.x_bits_1 if which == "static1" else ctx.x_bits_2)]
        ks = [int("".join(map(str, bits)), 2)] * len(lanes)
        got, _, _ = _ladder_model(q, fp.p, fp.L, g2.rows.b3, 32, bits=bits)
    want = [eng.g2.mul_any(host[i], k) for i, k in zip(lanes, ks)]
    assert g2.decode_points(_limbs(got, fp.L)) == want


@pytest.fixture(scope="module")
def edge_lanes():
    """Ten BLS12-381 lane pairs P, Q in relaxed limbs (each a host point plus
    infinity by the plain add): P = Q (the same limbs, and the same point in
    other limbs), P = -Q, P or Q or both at infinity, and random pairs."""
    spec = get_spec("BLS12_381")
    eng, g2 = get_engine(spec), get_hash_g2_ctx(spec, "cpu").g2
    rng = random.Random(18)
    pts = [eng.g2.mul(eng.gen_g2, rng.randrange(1, spec.r)) for _ in range(6)]
    A = [pts[0], pts[1], pts[2], None, pts[3], None, pts[4], pts[5], pts[1], pts[3]]
    B = [pts[0], pts[1], eng.g2.neg(pts[2]), pts[3], None, None, pts[5], pts[4], pts[2], pts[0]]
    inf = g2.encode_points([None] * len(A))
    P = g2_cuda.add_plain(g2.rows, g2.encode_points(A), inf)
    Q = g2_cuda.add_plain(g2.rows, g2.encode_points(B), inf)
    Q[..., 0] = P[..., 0]  # lane 0: P = Q limb for limb
    Q[..., 1] = g2.encode_points(B[1:2])[..., 0]  # lane 1: the same point in other limbs
    return eng, g2, P, Q, A, B


@pytest.mark.parametrize("kernel", ["add", "double"])
def test_g2_add_and_double_models_equal_the_plain_versions(edge_lanes, kernel):
    """g2_add_kernel's and g2_double_kernel's single launch (staging, the
    five steps, the direct store) limb for limb against add_plain and
    double_plain on the edge lanes, relaxed limbs in [p, 2p) among inputs and
    outputs; and canonically against the host engine."""
    eng, g2, P, Q, A, B = edge_lanes
    fp = g2.fp
    p, q = _ints(P, fp.L), _ints(Q, fp.L)
    if kernel == "add":
        got = _step_model(p, fp.p, fp.L, g2.rows.b3, Q=q)
        want = g2_cuda.add_plain(g2.rows, P, Q)
        host = [eng.g2.add(a, b) for a, b in zip(A, B)]
    else:
        got = _step_model(p, fp.p, fp.L, g2.rows.b3)
        want = g2_cuda.double_plain(g2.rows, P)
        host = [eng.g2.add(a, a) for a in A]
    assert got == _ints(want, fp.L)
    assert g2.decode_points(_limbs(got, fp.L)) == host
    for lanes in (p, q, got):  # relaxed limbs occur
        assert any(c >= fp.p for lane in lanes for c in lane)


def test_g2_dblsel_model_equals_dblsel_plain():
    """g2_dblsel_kernel's one launch (P and Q staged into the ladder's
    slots, the doubling, the block shortcut, the add's half storing
    sel ? A : D) limb for limb against dblsel_plain on BLS12-381 lanes in
    relaxed limbs: random pairs, P or Q or both at infinity, 2P = Q and
    2P = -Q, in 2-lane blocks (one with no lane selected, one with both)
    and one 32-lane block; and canonically against the host engine."""
    spec = get_spec("BLS12_381")
    eng, g2 = get_engine(spec), get_hash_g2_ctx(spec, "cpu").g2
    fp = g2.fp
    rng = random.Random(19)
    pts = [eng.g2.mul(eng.gen_g2, rng.randrange(1, spec.r)) for _ in range(12)]
    A = [pts[0], pts[1], None, pts[2], None, pts[3], pts[4], pts[5], pts[6], pts[7]]
    B = [pts[8], pts[9], pts[10], None, None, eng.g2.add(pts[3], pts[3]),
         eng.g2.neg(eng.g2.add(pts[4], pts[4])), pts[11], pts[0], pts[6]]
    sel = [False, False, True, True, True, True, True, False, False, True]
    inf = g2.encode_points([None] * len(A))
    P = g2_cuda.add_plain(g2.rows, g2.encode_points(A), inf)
    Q = g2_cuda.add_plain(g2.rows, g2.encode_points(B), inf)
    want = g2_cuda.dblsel_plain(g2.rows, P, Q, torch.tensor(sel))
    p, q = _ints(P, fp.L), _ints(Q, fp.L)
    for block, shortcut in ((2, 1), (32, 0)):
        got, skipped, added = _dblsel_model(p, q, sel, fp.p, fp.L, g2.rows.b3, block)
        assert got == _ints(want, fp.L), block
        assert (skipped, added) == (shortcut, -(-len(sel) // block) - shortcut)
    host = [eng.g2.add(eng.g2.add(a, a), b) if s else eng.g2.add(a, a)
            for a, b, s in zip(A, B, sel)]
    assert g2.decode_points(want) == host
    assert any(c >= fp.p for lane in p + q for c in lane)  # relaxed limbs occur


@pytest.mark.parametrize("flip", [False, True])
def test_g2_addsel_model_equals_addsel_plain(edge_lanes, flip):
    """g2_addsel_kernel's one launch (P and Q staged into the add's slots,
    the block shortcut that stores Q, the add's half storing sel ? A : Q)
    limb for limb against addsel_plain on the edge lanes (P = Q, P = -Q,
    infinity on either side, relaxed limbs in [p, 2p) among inputs and
    outputs), each lane selected under one of the two selections: in 2-lane
    blocks (blocks with no lane selected, and with both) and one 32-lane
    block; and canonically against the host engine."""
    eng, g2, P, Q, A, B = edge_lanes
    fp = g2.fp
    sel = [True, True, True, True, False, False, True, False, False, True]
    if flip:
        sel = [not s for s in sel]
    want = g2_cuda.addsel_plain(g2.rows, P, Q, torch.tensor(sel))
    p, q = _ints(P, fp.L), _ints(Q, fp.L)
    for block, shortcut in ((2, 2 if flip else 1), (32, 0)):
        got, skipped, added = _addsel_model(p, q, sel, fp.p, fp.L, g2.rows.b3, block)
        assert got == _ints(want, fp.L), block
        assert (skipped, added) == (shortcut, -(-len(sel) // block) - shortcut)
    host = [eng.g2.add(a, b) if s else b for a, b, s in zip(A, B, sel)]
    assert g2.decode_points(_limbs(got, fp.L)) == host
    for lanes in (p, q, got):  # relaxed limbs occur
        assert any(c >= fp.p for lane in lanes for c in lane)
