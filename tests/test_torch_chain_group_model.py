"""The grouped chain kernels behind ``fp_cuda.fp_pow`` and ``hash_cuda.hash_g1``
(``fp_pow_group_kernel`` in ``csrc/fp_kernels.cu``, ``hash_g1_kernel`` in
``csrc/hash_kernels.cu``), modelled on Python integers.

The CUDA kernels run only on a card (``tests/test_torch_cuda.py`` holds them
to the plain versions there).  Here their schedules are checked without one.
Every product is the group product of ``csrc/fp_group.cuh`` (four threads
in fp_pow's chain, two in hash_g1's), modelled thread by thread
(``_group_mul``: each thread's slice of the CIOS accumulator, m from thread
0's lowest word, the shift taking the next word from the thread above, the
overlap words carried up at the end, every word checked to fit 32 bits),
and that model is held to the word-level model of
``tests/test_torch_field.py``.  The hash kernel's model runs each lane's
phases as the kernel does: which group makes which product, the four window
tables and every value in shared slots at the kernel's places (the tables
share their memory with the later phases' slots), and a barrier between
phases: a group sees its own writes and what was written before the last
barrier, and a slot one group writes while another reads or writes it in
the same phase fails the model.  Held limb for limb against ``fp_pow_plain``
and ``hash_g1_plain`` (those are held to the reference's kernel bodies in
``tests/test_torch_final_exp.py`` and ``tests/test_torch_hash_bodies.py``).
Tolerance: exact.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.ops.field import FpCtx
from mathlib_tpu_torch.ops.hash import get_hash_g1_ctx
from mathlib_tpu_torch.ops.kernels import fp_cuda, hash_cuda
from test_torch_field import _mont_group_model

torch.set_num_threads(1)

GROUPS = 4  # hash_g1: groups (warps) a lane
POW_G, HASH_G = 4, 2  # threads a product: fp_pow_group_kernel, hash_g1_kernel
M32 = (1 << 32) - 1


def _group_mul(a, b, p, L, G):
    """``fp_mul_group<NW, G>`` on Python ints, thread by thread: thread g
    holds the K = NW / G words [g K, g K + K) of a and p and an accumulator
    t_g of K words and an overlap word.  Per word b_i: m_i from thread 0's
    lowest words, X_g = t_g + a_g b_i + m_i p_g (K + 2 words), then t_g the
    words of X_g from the second on plus thread g + 1's lowest word at its
    top; at the end each overlap word carried into the thread above.  Every
    word the kernel keeps in a 32-bit register is checked to fit one."""
    NW = L // 2
    K = NW // G
    W = 32 * K
    np0 = (-pow(p, -1, 1 << 32)) & M32
    xs = [(a >> (W * g)) & ((1 << W) - 1) for g in range(G)]
    ps = [(p >> (W * g)) & ((1 << W) - 1) for g in range(G)]
    t = [0] * G
    for i in range(NW):
        bi = (b >> (32 * i)) & M32
        m = (((t[0] & M32) + (xs[0] & M32) * bi) * np0) & M32
        X = [t[g] + xs[g] * bi + m * ps[g] for g in range(G)]
        assert X[0] & M32 == 0 and all(x >> (W + 64) == 0 for x in X)
        t = [(X[g] >> 32) + ((X[g + 1] & M32) << (W - 32) if g + 1 < G else 0)
             for g in range(G)]
        assert all(v >> (W + 32) == 0 for v in t)
    for r in range(1, G):
        t[r] += t[r - 1] >> W
        assert t[r] >> (W + 32) == 0
    assert t[G - 1] >> W == 0
    return sum((t[g] & ((1 << W) - 1)) << (W * g) for g in range(G))


def _field(p, L, G):
    """The kernels' linear operations on Python ints: add and sub kept in
    [0, 2p), fp_mul_small's add chain, canon, and the product over G
    threads."""

    def mul(a, b):
        return _group_mul(a, b, p, L, G)

    def add(a, b):
        return a + b - 2 * p if a + b >= 2 * p else a + b

    def sub(a, b):
        return a - b + 2 * p if a < b else a - b

    def small(a, n):
        acc = a
        for bit in bin(n)[3:]:
            acc = add(acc, acc)
            if bit == "1":
                acc = add(acc, a)
        return acc

    def canon(a):
        return a - p if a >= p else a

    return mul, add, sub, small, canon


def _ints(t, L):
    """(..., L, B) limbs -> per lane ints (the last axis)."""
    arr = t.to(torch.int64).reshape(-1, L, t.shape[-1]).numpy().astype(object)
    w = np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
    return [list((a * w).sum(axis=0)) for a in arr]


def _limbs(vals, L):
    return torch.tensor([[(v >> (16 * k)) & 0xFFFF for v in vals] for k in range(L)],
                        dtype=torch.int32)


@pytest.mark.parametrize("name", ["BLS12_381", "BN254"])
def test_group_mul_model_equals_the_word_model(name):
    """``_group_mul`` over four threads equals ``_mont_group_model`` (the
    word-level model of the same product, held to ``mont_mul_plain`` in
    test_torch_field.py), and over two threads the same, on 0, 1, p - 1, p,
    2p - 1 against each other and on random relaxed values."""
    p = get_spec(name).p
    L = FpCtx(p, "cpu").L
    rng = random.Random(16)
    edge = [0, 1, p - 1, p, 2 * p - 1]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(2 * p), rng.randrange(2 * p)) for _ in range(8)]
    want = [_mont_group_model(x, y, p, L) for x, y in pairs]
    for G in (4, 2):
        assert [_group_mul(x, y, p, L, G) for x, y in pairs] == want, G


def _pow_group_model(a, bits, p, L, one):
    """``fp_pow_group_kernel``'s chain for one element: acc = 1 (R mod p),
    then per MSB-first bit acc = acc acc and, at a one-bit, acc = acc a, on
    the product over four threads."""
    acc = one
    for bit in bits:
        acc = _group_mul(acc, acc, p, L, POW_G)
        if bit:
            acc = _group_mul(acc, a, p, L, POW_G)
    return acc


@pytest.mark.parametrize("name", ["BLS12_381", "BN254"])
def test_fp_pow_group_model_equals_fp_pow_plain(name):
    """The grouped fp_pow chain equals ``fp_pow_plain`` at L = 24 and 16 on
    0, 1, p - 1, p, 2p - 1 and random relaxed values, for the exponents
    p - 2 and (p + 1)/4."""
    p = get_spec(name).p
    fp = FpCtx(p, "cpu")
    L = fp.L
    rng = random.Random(L)
    vals = [0, 1, p - 1, p, 2 * p - 1] + [rng.randrange(2 * p) for _ in range(2)]
    one = _ints(fp.one_mont, L)[0][0]
    for e in (p - 2, (p + 1) // 4):
        bits = [int(b) for b in bin(e)[2:]]
        want = _ints(fp_cuda.fp_pow_plain(fp, _limbs(vals, L), bits), L)[0]
        assert [_pow_group_model(v, bits, p, L, one) for v in vals] == want, e


# ------------------------------------------------------------- hash_g1 ----
# the kernel's union: the window tables (16 slots a group) share their memory
# with the later phases' slots, at these places
_LATE = {"ev": 0, "pt": 8, "f": 14, "s": 20, "df": 26, "d": 30, "sum": 34}
_LATE_WIDTH = {"ev": 4, "pt": 3}


def _place(name, *idx):
    """The shared memory a slot names: ("u", n) inside the union."""
    if name == "tab":
        return ("u", 16 * idx[0] + idx[1])
    if name in _LATE:
        if name in _LATE_WIDTH:
            return ("u", _LATE[name] + _LATE_WIDTH[name] * idx[0] + idx[1])
        return ("u", _LATE[name] + idx[0])
    return (name, *idx)


class _Shared:
    """One lane's shared slots under the block's barriers."""

    def __init__(self):
        self.mem = {}
        self.barrier()

    def barrier(self):
        if hasattr(self, "writes"):
            for g, ws in self.writes.items():
                for h in range(GROUPS):
                    if h != g:
                        clash = set(ws) & (set(self.writes[h]) | self.reads[h])
                        assert not clash, f"groups {g} and {h} race on {clash}"
                self.mem.update(ws)
        self.writes = {g: {} for g in range(GROUPS)}
        self.reads = {g: set() for g in range(GROUPS)}

    def get(self, g, *name):
        place = _place(*name)
        if place in self.writes[g]:
            return self.writes[g][place]
        self.reads[g].add(place)
        return self.mem[place]

    def put(self, g, v, *name):
        self.writes[g][_place(*name)] = v


def _hash_model(ctx, u0, u1, sign):
    """``hash_g1_kernel`` for one lane (Montgomery ints u0, u1), phase by
    phase, group by group, as the kernel's code runs them; returns the
    relaxed (X, Y, Z) ints."""
    fp = ctx.fp
    p, L = fp.p, fp.L
    mul, add, sub, small, canon = _field(p, L, HASH_G)
    one = _ints(fp.one_mont, L)[0][0]
    c = {k: _ints(v, L)[0][0] for k, v in ctx.consts().items()}
    iso = [[_ints(cf, L)[0][0] for cf in cs] for cs in ctx.iso]
    inv_bits, sqrt_bits = (list(map(int, b)) for b in hash_cuda.chain_bits(p))
    h_bits = [int(b) for b in ctx.h_bits]
    b3 = ctx.g1.F.b3
    S = _Shared()

    def pow_win4(g, a, bits, tab):  # the group's table in its 16 slots
        S.put(g, one, "tab", tab, 0)
        S.put(g, a, "tab", tab, 1)
        e = a
        for j in range(2, 16):
            e = mul(e, a)
            S.put(g, e, "tab", tab, j)
        head = len(bits) % 4
        d = 0
        for bit in bits[:head]:
            d = 2 * d + bit
        acc = S.get(g, "tab", tab, d)
        for i in range(head, len(bits), 4):
            d = bits[i] * 8 + bits[i + 1] * 4 + bits[i + 2] * 2 + bits[i + 3]
            for _ in range(4):
                acc = mul(acc, acc)
            acc = mul(acc, S.get(g, "tab", tab, d))
        return acc

    def sgn(v):
        s = canon(mul(v, 1))
        return s & 1 if sign == "parity" else int(s <= p - s)

    # A. map w's head (w < 2); the sign of u_{w - 2}
    for w in range(GROUPS):
        m = w & 1
        u = (u0, u1)[m]
        if w >= 2:
            S.put(w, sgn(u), "su", m)
            continue
        t1 = mul(mul(u, u), c["Z"])
        t2 = add(mul(t1, t1), t1)
        x1 = mul(add(pow_win4(w, t2, inv_bits, m), one), c["negB_over_A"])
        if canon(t2) == 0:
            x1 = c["B_over_ZA"]
        S.put(w, x1, "x1", m)
        gx1 = add(mul(add(mul(x1, x1), c["A"]), x1), c["B"])
        S.put(w, gx1, "gx1", m)
        S.put(w, mul(t1, x1), "x2", m)
        S.put(w, mul(gx1, mul(t1, mul(t1, t1))), "gx2", m)
    S.barrier()
    # B. the square root of g(x1) (s = 0) or g(x2) (s = 1) of map m
    for w in range(GROUPS):
        m, s = w >> 1, w & 1
        y = pow_win4(w, S.get(w, "gx2" if s else "gx1", m), sqrt_bits, w)
        S.put(w, y, "y", m, s)
        if s == 0:
            S.put(w, int(canon(mul(y, y)) == canon(S.get(w, "gx1", m))), "sq", m)
        S.put(w, sgn(y), "sy", m, s)
    S.barrier()
    # C. Horner: yn, xd (w even) or yd, xn (w odd) of map m
    for w in range(GROUPS):
        m = w >> 1
        x = S.get(w, "x1", m) if S.get(w, "sq", m) else S.get(w, "x2", m)
        for q in ((3, 0) if w & 1 else (2, 1)):
            acc = iso[q][-1]
            for cf in reversed(iso[q][:-1]):
                acc = add(mul(acc, x), cf)
            S.put(w, acc, "ev", m, q)
    S.barrier()
    # D. the points
    for w in range(GROUPS):
        m = w & 1

        def ev(q, w=w, m=m):
            return S.get(w, "ev", m, q)

        if w < 2:
            e2 = mul(ev(2), ev(1))
            sq = S.get(w, "sq", m)
            y = S.get(w, "y", m, 0 if sq else 1)
            if S.get(w, "su", m) != S.get(w, "sy", m, 0 if sq else 1):
                y = sub(0, y)
            S.put(w, mul(y, e2), "pt", m, 1)
        else:
            S.put(w, mul(ev(0), ev(3)), "pt", m, 0)
            S.put(w, mul(ev(1), ev(3)), "pt", m, 2)
    S.barrier()

    def point(w, form, *name):  # HashPoint: coordinate cc of a point in slots
        def get(cc):
            if form == 0:
                return S.get(w, *name, cc)
            if form == 1:  # dxa, dya, dz, dyb
                r = S.get(w, *name, cc)
                return add(r, r) if cc == 0 else add(r, S.get(w, *name, 3)) if cc == 1 else r
            a, b = S.get(w, *name, 2 * cc), S.get(w, *name, 2 * cc + 1)
            return sub(a, b) if cc == 0 else add(a, b)
        return get

    def add_mid(w, i):
        t0, t1, t2, s3, s4, s5 = (S.get(w, "f", j) for j in range(6))
        return [sub(s3, add(t0, t1)), sub(s4, add(t1, t2)), small(sub(s5, add(t0, t2)), b3),
                add(add(t0, t0), t0), add(t1, small(t2, b3)), sub(t1, small(t2, b3))][i]

    mid_a, mid_b = (0, 1, 5, 2, 4, 3), (5, 2, 4, 3, 1, 0)  # kT3 = 0 ... kT1m = 5

    def add_layers(A, B):  # the add's two layers, group w making products w, w + 4
        for w in range(GROUPS):
            P1, P2 = point(w, *A), point(w, *B)
            for e in range(w, 6, 4):
                if e < 3:
                    r = mul(P1(e), P2(e))
                else:
                    c0, c1 = (1 if e == 4 else 0), (1 if e == 3 else 2)
                    r = mul(add(P1(c0), P1(c1)), add(P2(c0), P2(c1)))
                S.put(w, r, "f", e)
        S.barrier()
        for w in range(GROUPS):
            for e in range(w, 6, 4):
                S.put(w, mul(add_mid(w, mid_a[e]), add_mid(w, mid_b[e])), "s", e)
        S.barrier()

    add_layers((0, "pt", 0), (0, "pt", 1))
    for w in range(3):
        S.put(w, point(w, 2, "s")(w), "sum", w)
    S.barrier()
    # the cofactor ladder
    acc = (0, "sum")
    for bit in h_bits[1:]:
        for w in range(GROUPS):
            P = point(w, *acc)
            a, b = [(1, 1), (1, 2), (2, 2), (0, 1)][w]
            S.put(w, mul(P(a), P(b)), "df", w)
        S.barrier()
        for w in range(GROUPS):
            t0, t1, zz, xy = (S.get(w, "df", j) for j in range(4))
            z3t, t2 = small(t0, 8), small(zz, b3)
            t0m = sub(t0, add(add(t2, t2), t2))
            r = [mul(t0m, xy), mul(t2, z3t), mul(t0m, add(t0, t2)), mul(t1, z3t)][w]
            S.put(w, r, "d", [0, 1, 3, 2][w])
        S.barrier()
        acc = (1, "d")
        if bit:
            add_layers(acc, (0, "sum"))
            acc = (2, "s")
    out = [point(w, *acc)(w) for w in range(3)]
    if ctx.h_neg:
        out[1] = sub(0, out[1])
    return out


def test_hash_g1_model_equals_hash_g1_plain():
    """The hash kernel's schedule equals ``hash_g1_plain`` limb for limb
    under both signs, on the lanes (u0, u1) = (0, 1) (t2 = 0 at u0),
    (p - 1, u) with u != 0 and t2 = 0, and a random pair."""
    ctx = get_hash_g1_ctx(get_spec("BLS12_381"), "cpu")
    p, L = ctx.fp.p, ctx.fp.L
    rng = random.Random(5)
    t2_zero = pow(-pow(11, -1, p) % p, (p + 1) // 4, p)  # Z = 11: Z u^2 = -1
    us0 = [0, p - 1, rng.randrange(p)]
    us1 = [1, t2_zero, rng.randrange(p)]
    u0, u1 = ctx.fp.encode(us0), ctx.fp.encode(us1)
    m0, m1 = _ints(u0, L)[0], _ints(u1, L)[0]
    for sign in hash_cuda.SIGNS:
        want = _ints(hash_cuda.hash_g1_plain(ctx, u0, u1, sign), L)
        got = [_hash_model(ctx, a, b, sign) for a, b in zip(m0, m1)]
        assert [list(c) for c in zip(*got)] == want, sign
