"""The G2 ladder body behind ``g2_cuda.smul`` and ``g2_cuda.smul_static``
(``g2_ladder_kernel`` in ``csrc/g2_smul_kernels.cu``), modelled on Python
integers in the kernel's order of operations.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py`` holds it to
the plain versions there).  Here its schedule is checked without one: per
bit the doubling's first layer of base-field products (each Fp2 product
split into its three Karatsuba pieces, one a worker), the Fp2 products
combined from the pieces, the middle values formed from those, the second
layer, the doubled point D, the block's shortcut where no lane has the bit,
the add's five steps, and the select acc = bit ? A : D that writes into the
accumulator's buffer.  Every field operation is the kernel's relaxed
[0, 2p) one.  Held limb for limb against ``smul_plain`` and
``smul_static_plain`` on short bit strings (those are held to the reference's
kernel bodies in ``tests/test_torch_g2_ladders.py``), and canonically against
the host engine at full length.  Tolerance: exact.
"""

import random

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


def _ladder_model(Q, p, L, b3, block, ks=None, nbits=0, bits=None):
    """``g2_ladder_kernel`` on lanes of Python ints: Q a list of six ints per
    lane (coordinate c's component j at 2c + j); per-lane scalars ks over
    nbits bits (MSB first), or one MSB-first bit list shared by every lane;
    ``block`` lanes a block.  Each lane has the kernel's slots: two point
    buffers, Q, a layer's 18 products K, the first layer's Fp2 products F
    and the middle values M.  Returns the points and how many (block, bit)
    steps skipped the add and ran it."""
    mul, add, sub, small = _field(p, L)
    one = (1 << (16 * L)) % p
    n = len(Q)
    pt = [[[0, 0, one, 0, 0, 0], [0] * 6] for _ in range(n)]
    K = [[0] * 18 for _ in range(n)]
    Fv = [[0] * 12 for _ in range(n)]
    M = [[0] * 12 for _ in range(n)]
    cur = [0] * ((n + block - 1) // block)

    def kara(i, e, j):  # component j of Fp2 product e from its pieces
        t0, t1 = K[i][3 * e], K[i][3 * e + 1]
        return sub(t0, t1) if j == 0 else sub(K[i][3 * e + 2], add(t0, t1))

    def b3_comp(a0, a1, j):  # f2_mul_b3's branches
        c0, c1 = b3
        if c1 == 0:
            return small(a1 if j else a0, c0)
        if c0 == 0:
            return small(a0, c1) if j else sub(0, small(a1, c1))
        if c0 == c1:
            return small(add(a0, a1) if j else sub(a0, a1), c0)
        if j == 0:
            return sub(small(a0, c0), small(a1, c1))
        return add(small(a1, c0), small(a0, c1))

    def pt_get(P, x, j):  # coordinate x < 3, or X + Y, Y + Z, X + Z
        if x < 3:
            return P[2 * x + j]
        c0, c1 = (1 if x == 4 else 0), (1 if x == 3 else 2)
        return add(P[2 * c0 + j], P[2 * c1 + j])

    def piece(get, pc):  # Karatsuba piece: a0, a1, a0 + a1
        return get(pc) if pc < 2 else add(get(0), get(1))

    def value(i, ref, j):  # a second-layer operand's component j
        kind, idx = ref
        return (Fv if kind == "F" else M)[i][2 * idx + j]

    def product(i, h, lay, x, c):
        e, pc = divmod(x, 3)
        if lay == 0:
            A = pt[i][c if h == 0 else c ^ 1]
            B = A if h == 0 else Q[i]
            a = piece(lambda j: pt_get(A, PT_A[h][e], j), pc)
            b = piece(lambda j: pt_get(B, PT_B[h][e], j), pc)
        else:
            a = piece(lambda j: value(i, MID_A[h][e], j), pc)
            b = piece(lambda j: value(i, MID_B[h][e], j), pc)
        return mul(a, b)

    def dbl_mid(i, m, j):  # t0m, t2, z3t, y3t from t0, t1, zz, xy
        F = Fv[i]
        if m == 2:
            return small(F[j], 8)
        t2 = b3_comp(F[4], F[5], j)
        if m == 1:
            return t2
        return add(F[j], t2) if m == 3 else sub(F[j], add(add(t2, t2), t2))

    def add_mid(i, m, j):  # t3, t4, lnb, t0_3, z3t, t1m from t0, t1, t2, s3, s4, s5
        F = Fv[i]
        if m < 2:
            return sub(F[2 * (m + 3) + j], add(F[2 * m + j], F[2 * (m + 1) + j]))
        if m == 2:
            ln = [sub(F[10 + c], add(F[c], F[4 + c])) for c in (0, 1)]
            return b3_comp(ln[0], ln[1], j)
        if m == 3:
            return add(add(F[j], F[j]), F[j])
        t2b = b3_comp(F[4], F[5], j)
        return add(F[2 + j], t2b) if m == 4 else sub(F[2 + j], t2b)

    def point_out(i, h, c, j):
        if h == 0:
            if c == 0:
                return add(kara(i, 0, j), kara(i, 0, j))
            return add(kara(i, 1, j), kara(i, 2, j)) if c == 1 else kara(i, 3, j)
        a, b = kara(i, 2 * c, j), kara(i, 2 * c + 1, j)
        return sub(a, b) if c == 0 else add(a, b)

    steps = len(bits) if bits is not None else nbits
    skipped = added = 0
    for blk, lo in enumerate(range(0, n, block)):
        lanes = range(lo, min(lo + block, n))
        for step in range(steps):
            c = cur[blk]
            lane_bit = {}
            for h in (0, 1):
                if h == 1 and not any(lane_bit.values()):  # acc = D
                    cur[blk] ^= 1
                    skipped += 1
                    break
                nx, nf = (12, 8) if h == 0 else (18, 12)
                mid = dbl_mid if h == 0 else add_mid
                for i in lanes:  # 1. the first layer, one product a worker
                    K[i][:nx] = [product(i, h, 0, x, c) for x in range(nx)]
                for i in lanes:  # 2. its Fp2 products
                    Fv[i][:nf] = [kara(i, v >> 1, v & 1) for v in range(nf)]
                for i in lanes:  # 3. the middle values
                    M[i][:nf] = [mid(i, v >> 1, v & 1) for v in range(nf)]
                for i in lanes:  # 4. the second layer
                    K[i][:nx] = [product(i, h, 1, x, c) for x in range(nx)]
                if h == 0:  # 5. D into the other buffer; the lanes' bits
                    for i in lanes:
                        pt[i][c ^ 1] = [point_out(i, 0, v >> 1, v & 1) for v in range(6)]
                        if bits is not None:
                            lane_bit[i] = bits[step] == 1
                        else:
                            lane_bit[i] = (ks[i] >> (nbits - 1 - step)) & 1 == 1
                else:  # 5. acc = bit ? A : D
                    added += 1
                    for i in lanes:
                        if lane_bit[i]:
                            pt[i][c] = [point_out(i, 1, v >> 1, v & 1) for v in range(6)]
                        else:
                            pt[i][c] = list(pt[i][c ^ 1])
    return [pt[i][cur[i // block]] for i in range(n)], skipped, added


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
