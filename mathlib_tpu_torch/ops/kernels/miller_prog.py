"""The Miller loop as layered programs for the split Miller kernels
(``csrc/miller_split_kernels.cu``).

One lane's Miller loop is a chain of 7,786 base-field products at BLS12-381,
but each step of it is a few layers of products that do not depend on each
other: the reference stacks each such layer into one ``MulBatch``
(``mathlib_tpu/ops/kernels/pairing_pallas.py RowTower``).  This module traces
one doubling iteration (``dbl_step``, ``f12_sqr``, ``f12_sparse_mul``), one
doubling iteration followed by an addition step, the end of the loop (the
conjugation and the BN chord steps), and one addition step alone (the
``add_step`` kernel: the BN tail of ``miller_ft``), operation for operation as
``tower_rows.RowTower`` (the plain versions' tower) computes them, into a graph of base-field adds, subs,
negations and Montgomery products, and schedules each graph for a block of
``K`` workers:

* the products fall into layers by their depth in products, each layer one
  phase of the program; a product with slack moves to an earlier layer that
  has room (earliest deadline first), so a layer fills whole rounds of ``K``;
* the linear steps between them (Karatsuba's sums and recombinations,
  ``mul_xi``, the small multiples, the step formulas) run as tasks in the
  phases between two layers.  A task computes one value into shared memory
  from values already there (``d = x - y`` is one instruction), and every
  value has a slot.  A task that reads a value stored in the same phase runs
  on the worker that stored it, after it; otherwise it goes to a later phase.

A phase ends at a barrier, and no worker reads or writes a slot that another
worker writes in the same phase (``check_races``).  The slots are shared
memory of G lanes each; the loop's state (f, T, P, Q and the BN tail's
constants) keeps fixed slots across programs, the values in between take
free slots by their lifetimes.

The programs compute what ``tower_rows.RowTower`` computes, add for add and
product for product, so the relaxed [0, 2p) limbs that come out are those of
the plain versions (``pairing_cuda``):
``emulate`` runs a program on Python integers, and the tests hold it to
``miller_lanes_plain`` and ``miller_ft_plain``.

Instructions: a thread holds one value of NW words in registers, ``acc``;
an instruction word is

    bits 0-3 op, bit 4 load, bit 5 store, bits 8-15 x, 16-23 y, 24-31 d

and runs: acc = S[x] if load; then the op; then S[d] = acc if store:

    ADD    acc = acc + S[y]      SUB    acc = acc - S[y]
    MUL    acc = acc * S[y] (Montgomery)
    DBL    acc = acc + acc       NEG    acc = 0 - acc
    NOP    nothing

so ``d = x + y`` is one instruction.  The scheduler emits LD s / ST s steps
and fuses each into its neighbour (``encode``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

ADD, SUB, MUL, DBL, NEG, NOP, LD, ST = range(8)  # LD, ST: before encode
LOAD, STORE = 16, 32

# fixed slots of the loop's state (the order of the kernels' (12, L, B) f,
# (6, L, B) T, and of TowerConsts.tail)
F_SLOT, T_SLOT, XP_SLOT, YP_SLOT, QX_SLOT, QY_SLOT, TAIL_SLOT = 0, 12, 18, 19, 20, 22, 24
N_STATE = 32
ADD_STATE = 24  # the add_step kernel's state: no tail constants


class Graph:
    """Base-field values of one lane: leaves (slots), adds, subs, negations
    and products, with identical nodes shared."""

    def __init__(self):
        self.nodes: List[Tuple] = []
        self.memo: Dict[Tuple, int] = {}

    def _node(self, key: Tuple) -> int:
        if key not in self.memo:
            self.memo[key] = len(self.nodes)
            self.nodes.append(key)
        return self.memo[key]

    def leaf(self, slot: int) -> int:
        return self._node(("leaf", slot))

    def add(self, a: int, b: int) -> int:
        return self._node(("add", min(a, b), max(a, b)))  # fp_add is symmetric

    def sub(self, a: int, b: int) -> int:
        return self._node(("sub", a, b))

    def neg(self, a: int) -> int:
        return self._node(("neg", a))

    def mul(self, a: int, b: int) -> int:
        return self._node(("mul", min(a, b), max(a, b)))  # so is REDC(a b)


class Tower:
    """``tower_rows.RowTower`` on graph nodes: f2 = 2 nodes, f6 = 3 f2,
    f12 = 2 f6; every function in its order of operations."""

    def __init__(self, g: Graph, n: int, xi0: int, twist_m: bool):
        self.g, self.n, self.xi0, self.twist_m = g, n, xi0, twist_m

    # fp
    def small(self, a, m):  # fp_mul_small: the add chain, MSB first
        g, acc = self.g, a
        for bit in range(m.bit_length() - 2, -1, -1):
            acc = g.add(acc, acc)
            if (m >> bit) & 1:
                acc = g.add(acc, a)
        return acc

    # f2
    def f2_add(self, a, b):
        return (self.g.add(a[0], b[0]), self.g.add(a[1], b[1]))

    def f2_sub(self, a, b):
        return (self.g.sub(a[0], b[0]), self.g.sub(a[1], b[1]))

    def f2_neg(self, a):
        return (self.g.neg(a[0]), self.g.neg(a[1]))

    def f2_small(self, a, m):
        return (self.small(a[0], m), self.small(a[1], m))

    def f2_mul_xi(self, a):
        g = self.g
        na1 = self.small(a[1], self.n)
        if self.xi0 == 0:
            return (g.neg(na1), a[0])
        x0, x1 = self.small(a[0], self.xi0), self.small(a[1], self.xi0)
        return (g.sub(x0, na1), g.add(x1, a[0]))

    def f2_mul(self, a, b):
        g = self.g
        t0, t1 = g.mul(a[0], b[0]), g.mul(a[1], b[1])
        t2 = g.mul(g.add(a[0], a[1]), g.add(b[0], b[1]))
        r1 = g.sub(t2, g.add(t0, t1))
        return (g.sub(t0, self.small(t1, self.n)), r1)

    def f2_sqr(self, a):
        g = self.g
        if self.n == 1:
            m = g.mul(a[0], a[1])
            r0 = g.mul(g.add(a[0], a[1]), g.sub(a[0], a[1]))
        else:
            s0, s1, m = g.mul(a[0], a[0]), g.mul(a[1], a[1]), g.mul(a[0], a[1])
            r0 = g.sub(s0, self.small(s1, self.n))
        return (r0, g.add(m, m))

    def f2_mul_fp(self, a, x):
        return (self.g.mul(a[0], x), self.g.mul(a[1], x))

    # f6
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_mul_v(self, a):
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        t0, t1, t2 = (self.f2_mul(a[j], b[j]) for j in range(3))
        m12 = self.f2_mul(self.f2_add(a[1], a[2]), self.f2_add(b[1], b[2]))
        m01 = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(b[0], b[1]))
        m02 = self.f2_mul(self.f2_add(a[0], a[2]), self.f2_add(b[0], b[2]))
        s = self.f2_mul_xi(self.f2_sub(self.f2_sub(m12, t1), t2))
        c0 = self.f2_add(t0, s)
        c1 = self.f2_add(self.f2_sub(self.f2_sub(m01, t0), t1), self.f2_mul_xi(t2))
        c2 = self.f2_add(self.f2_sub(self.f2_sub(m02, t0), t2), t1)
        return (c0, c1, c2)

    def f6_mul01(self, a, b0, b1):
        a0b0, a1b1 = self.f2_mul(a[0], b0), self.f2_mul(a[1], b1)
        a2b0, a2b1 = self.f2_mul(a[2], b0), self.f2_mul(a[2], b1)
        x = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(b0, b1))
        c0 = self.f2_add(a0b0, self.f2_mul_xi(a2b1))
        c1 = self.f2_sub(self.f2_sub(x, a0b0), a1b1)
        return (c0, c1, self.f2_add(a1b1, a2b0))

    def f6_neg(self, a):
        return tuple(self.f2_neg(x) for x in a)

    # f12
    def f12_conj(self, f):
        return (f[0], self.f6_neg(f[1]))

    def f12_sqr(self, f):
        t = self.f6_mul(f[0], f[1])
        s = self.f6_add(f[0], f[1])
        u = self.f6_add(f[0], self.f6_mul_v(f[1]))
        m1 = self.f6_sub(self.f6_mul(s, u), t)
        return (self.f6_sub(m1, self.f6_mul_v(t)), self.f6_add(t, t))

    def f12_mul(self, f, h):
        t0, t1 = self.f6_mul(f[0], h[0]), self.f6_mul(f[1], h[1])
        ts = self.f6_mul(self.f6_add(f[0], f[1]), self.f6_add(h[0], h[1]))
        return (self.f6_add(t0, self.f6_mul_v(t1)), self.f6_sub(self.f6_sub(ts, t0), t1))

    def fp4_sqr(self, x, y):
        x2, y2 = self.f2_sqr(x), self.f2_sqr(y)
        s = self.f2_sqr(self.f2_add(x, y))
        return (self.f2_add(x2, self.f2_mul_xi(y2)), self.f2_sub(self.f2_sub(s, x2), y2))

    def gs_combine(self, t, z, sign):
        d = self.f2_sub(t, z) if sign < 0 else self.f2_add(t, z)
        return self.f2_add(self.f2_add(d, d), t)

    def f12_cyclo_sqr(self, f):
        (a0, a1, a2), (b0, b1, b2) = f
        t00, t01 = self.fp4_sqr(a0, b1)
        t10, t11 = self.fp4_sqr(b0, a2)
        t20, t21 = self.fp4_sqr(a1, b2)
        xt = self.f2_mul_xi(t21)
        gs = self.gs_combine
        return ((gs(t00, a0, -1), gs(t10, a1, -1), gs(t20, a2, -1)),
                (gs(xt, b0, 1), gs(t01, b1, 1), gs(t11, b2, 1)))

    def f12_frob(self, f, gam, n):
        """f^(p^n): conjugate each coefficient when n is odd, then scale
        coefficient (h, j) by the f2 ``gam[h][j]``."""
        g = self.g
        return tuple(tuple(self.f2_mul((c[0], g.neg(c[1])) if n & 1 else c, gam[h][j])
                           for j, c in enumerate(f[h])) for h in range(2))

    # the inverses, split around the base-field inverse: *_norm gives what
    # the inverse one level down takes, *_finish the inverse from it
    def f2_inv_norm(self, a):  # a0^2 + n a1^2
        g = self.g
        return g.add(g.mul(a[0], a[0]), self.small(g.mul(a[1], a[1]), self.n))

    def f2_inv_finish(self, a, ninv):
        g = self.g
        return (g.mul(a[0], ninv), g.neg(g.mul(a[1], ninv)))

    def f6_inv_norm(self, a):
        """(c, norm): the cofactors c and the f2 norm a0 c0 + xi (a2 c1 + a1 c2)."""
        a0, a1, a2 = a
        c0 = self.f2_sub(self.f2_sqr(a0), self.f2_mul_xi(self.f2_mul(a1, a2)))
        c1 = self.f2_sub(self.f2_mul_xi(self.f2_sqr(a2)), self.f2_mul(a0, a1))
        c2 = self.f2_sub(self.f2_sqr(a1), self.f2_mul(a0, a2))
        t = self.f2_mul_xi(self.f2_add(self.f2_mul(a2, c1), self.f2_mul(a1, c2)))
        return (c0, c1, c2), self.f2_add(self.f2_mul(a0, c0), t)

    def f6_inv_finish(self, c, inv2):
        return tuple(self.f2_mul(x, inv2) for x in c)

    def f12_inv_norm(self, f):  # a0^2 - v a1^2
        return self.f6_sub(self.f6_mul(f[0], f[0]), self.f6_mul_v(self.f6_mul(f[1], f[1])))

    def f12_inv_finish(self, f, inv6):
        return (self.f6_mul(f[0], inv6), self.f6_neg(self.f6_mul(f[1], inv6)))

    def f12_sparse_mul(self, f, line):
        a, dmb, negc = line
        b0, b1 = (dmb, negc) if self.twist_m else (negc, dmb)
        p = [self.f2_mul(f[0][j], a) for j in range(3)]
        a1l1 = self.f6_mul01(f[1], b0, b1)
        s = self.f6_add(f[0], f[1])
        if self.twist_m:
            cross = self.f6_mul(s, (b0, b1, a))
            a0l0 = (self.f2_mul_xi(p[1]), self.f2_mul_xi(p[2]), p[0])
        else:
            cross = self.f6_mul01(s, self.f2_add(b0, a), b1)
            a0l0 = tuple(p)
        c0 = self.f6_add(a0l0, self.f6_mul_v(a1l1))
        c1 = self.f6_sub(self.f6_sub(cross, a0l0), a1l1)
        return (c0, c1)

    # miller steps
    def dbl_step(self, T, xP, yP):
        X, Y, Z = T
        S, X2 = self.f2_mul(Y, Z), self.f2_sqr(X)
        W = self.f2_small(X2, 3)
        YS, SZ, S2 = self.f2_mul(Y, S), self.f2_mul(S, Z), self.f2_sqr(S)
        X3t, X2Z, W2 = self.f2_mul(X2, X), self.f2_mul(X2, Z), self.f2_sqr(W)
        Bd, YS2, SS2 = self.f2_mul(X, YS), self.f2_sqr(YS), self.f2_mul(S, S2)
        A = self.f2_mul_fp(self.f2_add(SZ, SZ), yP)
        C = self.f2_mul_fp(self.f2_small(X2Z, 3), xP)
        H = self.f2_sub(W2, self.f2_small(Bd, 8))
        HS = self.f2_mul(H, S)
        Xn = self.f2_add(HS, HS)
        Wt = self.f2_mul(W, self.f2_sub(self.f2_small(Bd, 4), H))
        Yn = self.f2_sub(Wt, self.f2_small(YS2, 8))
        Zn = self.f2_small(SS2, 8)
        dmb = self.f2_sub(self.f2_small(X3t, 3), self.f2_add(YS, YS))
        return (A, dmb, self.f2_neg(C)), (Xn, Yn, Zn)

    def add_step(self, T, Qx, Qy, xP, yP):
        X, Y, Z = T
        th = self.f2_sub(Y, self.f2_mul(Qy, Z))
        lam = self.f2_sub(X, self.f2_mul(Qx, Z))
        l2, th2 = self.f2_sqr(lam), self.f2_sqr(th)
        dmb = self.f2_sub(self.f2_mul(th, Qx), self.f2_mul(lam, Qy))
        A = self.f2_mul_fp(lam, yP)
        negc = self.f2_neg(self.f2_mul_fp(th, xP))
        l3, G, Zt = self.f2_mul(l2, lam), self.f2_mul(X, l2), self.f2_mul(Z, th2)
        H = self.f2_sub(self.f2_add(l3, Zt), self.f2_add(G, G))
        Xn = self.f2_mul(lam, H)
        Yn = self.f2_sub(self.f2_mul(th, self.f2_sub(G, H)), self.f2_mul(Y, l3))
        return (A, dmb, negc), (Xn, Yn, self.f2_mul(Z, l3))


def _state(g: Graph):
    """The leaves of the fixed slots: f, T, xP, yP, Qx, Qy, tail constants."""
    f2 = lambda s: (g.leaf(s), g.leaf(s + 1))  # noqa: E731
    f = tuple(tuple(f2(F_SLOT + 2 * (3 * h + j)) for j in range(3)) for h in range(2))
    T = tuple(f2(T_SLOT + 2 * c) for c in range(3))
    tail = [f2(TAIL_SLOT + 2 * a) for a in range(4)]
    return f, T, g.leaf(XP_SLOT), g.leaf(YP_SLOT), f2(QX_SLOT), f2(QY_SLOT), tail


def _f12_outputs(f) -> Dict[int, int]:
    return {F_SLOT + 2 * (3 * h + j) + c: f[h][j][c]
            for h in range(2) for j in range(3) for c in range(2)}


def _t_outputs(T) -> Dict[int, int]:
    return {T_SLOT + 2 * k + c: T[k][c] for k in range(3) for c in range(2)}


def trace(kind: str, n: int, xi0: int, twist_m: bool, conj_end: bool = False,
          bn_tail: bool = False):
    """(graph, {slot: node}) of one program: "dbl" (a doubling iteration),
    "dbladd" (one followed by an addition step), "add" (an addition step
    alone: ``add_step_kernel``'s f l_{T,Q}(P) and T + Q), or "tail" (the
    end of ``miller_lanes_plain``'s loop: conjugation when ``conj_end``, the BN chord
    steps when ``bn_tail``; f only)."""
    g = Graph()
    tw = Tower(g, n, xi0, twist_m)
    f, T, xP, yP, Qx, Qy, tail = _state(g)
    if kind == "add":
        line, T = tw.add_step(T, Qx, Qy, xP, yP)
        return g, {**_f12_outputs(tw.f12_sparse_mul(f, line)), **_t_outputs(T)}
    if kind in ("dbl", "dbladd"):
        line, T = tw.dbl_step(T, xP, yP)
        f = tw.f12_sparse_mul(tw.f12_sqr(f), line)
        if kind == "dbladd":
            line, T = tw.add_step(T, Qx, Qy, xP, yP)
            f = tw.f12_sparse_mul(f, line)
        return g, {**_f12_outputs(f), **_t_outputs(T)}
    if conj_end:
        f = tw.f12_conj(f)
    if bn_tail:
        X, Y, Z = T
        if conj_end:
            Y = tw.f2_neg(Y)
        q1x = tw.f2_mul((Qx[0], g.neg(Qx[1])), tail[0])
        q1y = tw.f2_mul((Qy[0], g.neg(Qy[1])), tail[1])
        q2x = tw.f2_mul(Qx, tail[2])
        q2y = tw.f2_neg(tw.f2_mul(Qy, tail[3]))
        line, T = tw.add_step((X, Y, Z), q1x, q1y, xP, yP)
        f = tw.f12_sparse_mul(f, line)
        line, T = tw.add_step(T, q2x, q2y, xP, yP)
        f = tw.f12_sparse_mul(f, line)
    return g, _f12_outputs(f)


# ------------------------------------------------------------------ schedule --
@dataclass
class Program:
    """One scheduled program: ``phases[p][w]`` is worker w's instruction
    list in phase p; it uses slots below ``nslots``."""

    phases: List[List[List[int]]]
    nslots: int
    products: int
    layers: List[int]  # products per product layer


def _ins(op: int, slot: int = 0) -> int:
    return op | slot << 4


def encode(code: List[int]) -> List[int]:
    """Instruction words of a list of steps (op | slot << 4): a LD fuses into
    the op after it, a ST into the op before it; a lone LD or ST becomes a
    NOP that loads or stores."""
    out, i, n = [], 0, len(code)
    while i < n:
        op, s = code[i] & 15, code[i] >> 4
        word = 0
        if op == LD:
            word |= LOAD | s << 8
            if i + 1 < n and code[i + 1] & 15 not in (LD, ST):
                i += 1
                op, s = code[i] & 15, code[i] >> 4
            else:
                op = NOP
        if op == ST:
            word |= NOP | STORE | s << 24
        else:
            word |= op | (s << 16 if op in (ADD, SUB, MUL) else 0)
            if i + 1 < n and code[i + 1] & 15 == ST:
                i += 1
                word |= STORE | (code[i] >> 4) << 24
        out.append(word)
        i += 1
    return out


def fields(word: int):
    """(op, x or None, y or None, d or None) of an instruction word."""
    op = word & 15
    return (op, (word >> 8) & 255 if word & LOAD else None,
            (word >> 16) & 255 if op in (ADD, SUB, MUL) else None,
            word >> 24 if word & STORE else None)


MUL_WEIGHT = 14  # a product against a linear instruction, for balancing


MILLER_FREE = range(F_SLOT, T_SLOT + 6)  # f and T: written or dead by a program's end


def schedule(g: Graph, outputs: Dict[int, int], K: int, n_state: int = N_STATE,
             free=MILLER_FREE, cap: int = 0, alap: bool = False, recompute: int = 0) -> Program:
    """Phases for K workers of the graph's values that reach ``outputs``
    ({state slot: node}), each value one task in a slot of its own.  Slots
    below ``n_state`` are the state; of them, those in ``free`` hold values
    between their old value's last reader and their new value's write (for
    good, when the program writes none), the others keep theirs.  An output
    overwrites its old value in place from the phase that last reads it,
    when only earlier code of its own worker reads it there; else it takes a
    copy phase at the end.

    Two options trade phases for slots: ``cap`` puts at most that many
    products in a layer (by deadline), ``alap`` computes each linear value
    in the last gap before its first reader, so that the operands of a
    later layer do not hold slots through an earlier one.  ``recompute``
    shortens the last gap: a linear task there whose operands were stored in
    its sub-phase by other workers (or by a worker that would run it late)
    computes up to that many of them again on a free worker, instead of
    waiting for the next sub-phase."""
    nodes = g.nodes

    def kind(v):
        return nodes[v][0]

    def args(v):
        return () if kind(v) == "leaf" else nodes[v][1:]

    live, todo = set(), list(outputs.values())
    while todo:
        v = todo.pop()
        if v not in live:
            live.add(v)
            todo.extend(args(v))
    order = sorted(live)  # node ids are topological
    out_nodes = set(outputs.values())
    tasks = [v for v in order if kind(v) != "leaf"]
    is_mul = {v: kind(v) == "mul" for v in tasks}
    weight = {v: MUL_WEIGHT if is_mul[v] else 1 for v in tasks}
    ins = {v: set(args(v)) for v in tasks}
    t_users: Dict[int, set] = {v: set() for v in order}
    for v in tasks:
        for a in ins[v]:
            t_users[a].add(v)

    # products: depth in products (ASAP), latest layer (ALAP), then layers
    depth: Dict[int, int] = {}
    for v in order:
        d = max((depth[a] for a in ins.get(v, ())), default=0)
        depth[v] = d + 1 if is_mul.get(v) else d
    muls = [v for v in tasks if is_mul[v]]
    D = max((depth[v] for v in muls), default=0)
    late: Dict[int, int] = {}
    for v in reversed(tasks):
        lim = [late[u] - (1 if is_mul[u] else 0) for u in t_users[v]]
        late[v] = min(lim + [D])
    mul_preds: Dict[int, set] = {}
    for v in tasks:
        preds = set()
        for a in ins[v]:
            if a in mul_preds:
                preds |= {a} if is_mul[a] else mul_preds[a]
        mul_preds[v] = preds
    layer: Dict[int, int] = {}
    lay = 0
    while len(layer) < len(muls):  # must-run products first, then fill the round by deadline
        lay += 1
        ready = sorted((v for v in muls if v not in layer
                        and all(layer.get(p, lay) < lay for p in mul_preds[v])),
                       key=lambda v: (late[v], v))
        if cap:
            pick = ready[:cap]
        else:
            must = [v for v in ready if late[v] <= lay]
            pick = must + [v for v in ready if late[v] > lay][: -len(must) % K]
        for v in pick:
            layer[v] = lay
    assert lay <= D or cap, "a product found no layer"
    D = lay
    latest: Dict[int, int] = {}  # the last gap a linear value may take
    for v in reversed(tasks):
        if not is_mul[v]:
            latest[v] = min([layer[u] - 1 if is_mul[u] else latest[u] for u in t_users[v]] + [D])

    # linear tasks: (gap after product layer, sub-phase, worker); a task that
    # reads a value stored in its own sub-phase runs after it on its worker
    op_of = {v: nodes[v][0] for v in order}  # clones (recompute) join these
    arg_of = {v: args(v) for v in order}
    place: Dict[int, Tuple[int, int, int]] = {}
    load: Dict[Tuple, List[int]] = {}
    emit: List[int] = []  # the tasks in code order: clones before their reader
    for v in tasks:
        if is_mul[v]:
            emit.append(v)
            continue
        gap = latest[v] if alap else max([layer[a] for a in ins[v] if a in layer]
                                         + [place[a][0] for a in ins[v] if a in place] + [0])
        deps = [place[a] for a in ins[v] if a in place and place[a][0] == gap]
        sub, worker = 0, None
        if deps:
            sub = max(s for _, s, _ in deps)
            ws = {w for _, s, w in deps if s == sub}
            ld = load.setdefault((gap, sub), [0] * K)
            w = ws.pop() if len(ws) == 1 else None
            if recompute and gap == D and (w is None or ld[w] >= max(ld)):
                redo, todo = [], [a for a in ins[v] if place.get(a, ())[:2] == (gap, sub)]
                while todo:  # the same-sub-phase ancestors, to compute again
                    a = todo.pop()
                    if a not in redo:
                        redo.append(a)
                        todo += [x for x in ins[a] if place.get(x, ())[:2] == (gap, sub)]
                w2 = min(range(K), key=lambda x: ld[x])
                if len(redo) <= recompute and (w is None or ld[w2] + len(redo) < ld[w]):
                    copy: Dict[int, int] = {}
                    for a in sorted(redo, key=emit.index):
                        c = len(nodes) + len(op_of) - len(order)  # a new id
                        op_of[c] = op_of[a]
                        arg_of[c] = tuple(copy.get(x, x) for x in arg_of[a])
                        ins[c], is_mul[c], weight[c] = set(arg_of[c]), False, 1
                        place[c], copy[a] = (gap, sub, w2), c
                        ld[w2] += 1
                        emit.append(c)
                    arg_of[v] = tuple(copy.get(x, x) for x in arg_of[v])
                    ins[v] = set(arg_of[v])
                    w = w2
            if w is not None:
                worker = w
            else:
                sub += 1
        ld = load.setdefault((gap, sub), [0] * K)
        if worker is None:
            worker = min(range(K), key=lambda w: ld[w])
        ld[worker] += weight[v]
        place[v] = (gap, sub, worker)
        emit.append(v)
    seq = []
    nsub: Dict[int, int] = {}
    for gap, sub, _ in place.values():
        nsub[gap] = max(nsub.get(gap, 0), sub + 1)
    for lay in range(D + 1):
        if lay:
            seq.append(("mul", lay))
        seq += [("lin", lay, s) for s in range(nsub.get(lay, 0))]
    index = {key: i for i, key in enumerate(seq)}
    phase: Dict[int, int] = {}
    worker_of: Dict[int, int] = {}
    for v, (gap, sub, w) in place.items():
        phase[v], worker_of[v] = index[("lin", gap, sub)], w
    for lay in range(1, D + 1):  # products: heaviest first to the least loaded worker
        ld = [0] * K
        for v in sorted((v for v in muls if layer[v] == lay), key=lambda v: (-weight[v], v)):
            w = min(range(K), key=lambda w: ld[w])
            ld[w] += weight[v]
            phase[v], worker_of[v] = index[("mul", lay)], w
    nph = len(seq)

    # lifetimes, then slots: the state's are fixed, the rest are reused once dead
    last_use: Dict[int, int] = {}
    for v in emit:
        for a in ins[v]:
            last_use[a] = max(last_use.get(a, -1), phase[v])
    for v in out_nodes:
        last_use[v] = nph  # read after the program
    slot = {v: nodes[v][1] for v in order if kind(v) == "leaf"}
    at = {v: i for i, v in enumerate(emit)}

    def before_on_its_worker(old, v):  # every reader of old in v's phase precedes v there
        return all(worker_of[r] == worker_of[v] and at[r] < at[v]
                   for r in emit if old in ins[r] and phase[r] == phase[v])

    copies = []
    for s, v in sorted(outputs.items()):
        old = g.memo.get(("leaf", s))
        dead_after = last_use.get(old, -1) if old in live else -1
        if v not in slot and v in phase and (
                phase[v] > dead_after
                or phase[v] == dead_after and before_on_its_worker(old, v)):
            slot[v] = s  # written in place
        elif slot.get(v) != s:
            copies.append((s, v))

    by_phase: Dict[int, List[int]] = {}
    for v in emit:
        by_phase.setdefault(phase[v], []).append(v)
    # a free state slot takes values between its old value's last use and the
    # write of its new value (for good, when the program has none)
    INF = 1 << 30
    opens = []  # (phase it opens, slot, last phase a value there may live)
    for s in free:
        old = g.memo.get(("leaf", s))
        first = last_use.get(old, -1) + 1 if old in live else 0
        v = outputs.get(s)
        if v is None:
            until = INF
        elif v not in phase:  # the old value itself, or another slot's
            until = -1 if v == old else nph - 1
        else:
            until = phase[v] - 1 if slot.get(v) == s else nph - 1
        if until >= first:
            opens.append((first, s, until))
    free: List[Tuple[int, int]] = []  # (until, slot)
    busy: List[Tuple[int, int, int]] = []  # (last use, slot, until)
    top = n_state

    def take(last):
        nonlocal top
        fits = [e for e in free if e[0] >= last]
        if fits:
            e = min(fits)
            free.remove(e)
            until, s = e
        else:
            until, s, top = INF, top, top + 1
        busy.append((last, s, until))
        return s

    for p in range(nph):
        busy.sort()
        while busy and busy[0][0] < p:
            _, s, until = busy.pop(0)
            free.append((until, s))
        free += [(until, s) for first, s, until in opens if first == p]
        for v in by_phase.get(p, []):
            if v not in slot:
                slot[v] = take(last_use.get(v, p))

    # code: acc = the value of v from its arguments' slots, then store it
    phases = [[[] for _ in range(K)] for _ in range(nph)]
    for v in emit:  # topological order keeps a worker's chained tasks in order
        a, *b = arg_of[v]
        if op_of[v] == "neg":
            op = [_ins(NEG)]
        elif op_of[v] == "add" and b == [a]:
            op = [_ins(DBL)]
        else:
            op = [_ins({"add": ADD, "sub": SUB, "mul": MUL}[op_of[v]], slot[b[0]])]
        phases[phase[v]][worker_of[v]] += [_ins(LD, slot[a]), *op, _ins(ST, slot[v])]
    if copies:  # one more phase: outputs that could not be written in place
        extra = [[] for _ in range(K)]
        for i, (s, v) in enumerate(copies):
            extra[i % K] += [_ins(LD, slot[v]), _ins(ST, s)]
        phases.append(extra)
    assert top <= 256, "slot fields are 8 bits"
    phases = [[encode(code) for code in ph] for ph in phases if any(ph)]
    layers = [sum(1 for v in muls if layer[v] == lay) for lay in range(1, D + 1)]
    return Program(phases, top, len(muls), layers)


def check_races(prog: Program) -> None:
    """Raise if a worker reads or writes a slot that another worker writes in
    the same phase."""
    for p, ph in enumerate(prog.phases):
        writers: Dict[int, int] = {}
        touch: Dict[int, set] = {}
        for w, code in enumerate(ph):
            for word in code:
                _, x, y, d = fields(word)
                for s in (x, y, d):
                    if s is not None:
                        touch.setdefault(s, set()).add(w)
                if d is not None and writers.setdefault(d, w) != w:
                    raise AssertionError(f"phase {p}: slot {d} written by two workers")
        for s, w in writers.items():
            if touch[s] != {w}:
                raise AssertionError(f"phase {p}: slot {s} written by {w}, used by {touch[s]}")


# ------------------------------------------------------------------- emulate --
def emulate(prog: Program, S: List, p: int, R: int, np0_full: int) -> None:
    """Run a program on one lane's slots S (Python ints, Montgomery form),
    in place: the kernel's instructions on the field of p, R = 2^(16 L).
    ``np0_full`` = -p^-1 mod R."""
    p2 = 2 * p

    def add(a, b):
        s = a + b
        return s - p2 if s >= p2 else s

    def sub(a, b):
        d = a - b
        return d + p2 if d < 0 else d

    def mul(a, b):
        t = a * b
        m = (t * np0_full) % R
        return (t + m * p) // R

    for ph in prog.phases:
        for code in ph:
            acc = 0
            for word in code:
                op, x, y, d = fields(word)
                if x is not None:
                    acc = S[x]
                if op == ADD:
                    acc = add(acc, S[y])
                elif op == SUB:
                    acc = sub(acc, S[y])
                elif op == MUL:
                    acc = mul(acc, S[y])
                elif op == DBL:
                    acc = add(acc, acc)
                elif op == NEG:
                    acc = sub(0, acc)
                if d is not None:
                    S[d] = acc


def align(prog: Program, per_warp: int) -> None:
    """Pad the code of the workers that share a warp (``per_warp`` of them,
    32 / G) with NOPs, phase by phase, so that their products sit at the same
    instruction index: the warp then runs each product once for all of them,
    and only the cheap instructions between products diverge."""
    heavy = (MUL,)
    for ph in prog.phases:
        for w0 in range(0, len(ph), per_warp):
            segs = []
            for code in ph[w0 : w0 + per_warp]:
                cut, out = 0, []
                for i, ins in enumerate(code):
                    if ins & 15 in heavy:
                        out.append(code[cut : i + 1])
                        cut = i + 1
                segs.append((out, code[cut:]))
            n = max(len(out) for out, _ in segs)
            for w, (out, rest) in enumerate(segs):
                code = []
                for i in range(n):
                    width = max(len(o[i]) for o, _ in segs if i < len(o))
                    if i < len(out):
                        code += [NOP] * (width - len(out[i])) + out[i]
                ph[w0 + w] = code + rest


def _scheduled(traced, K: int, per_warp: int, n_state: int = N_STATE) -> Program:
    prog = schedule(*traced, K, n_state)
    check_races(prog)
    if per_warp > 1:
        align(prog, per_warp)
    return prog


@lru_cache(maxsize=None)
def programs(n: int, xi0: int, twist_m: bool, conj_end: bool, bn_tail: bool, K: int,
             per_warp: int = 1):
    """(dbl, dbladd, tail) programs of one curve for K workers, ``per_warp``
    of them to a warp; tail is None when the loop's end does nothing (no
    conjugation and no BN tail)."""
    return tuple(
        None if kind == "tail" and not (conj_end or bn_tail)
        else _scheduled(trace(kind, n, xi0, twist_m, conj_end, bn_tail), K, per_warp)
        for kind in ("dbl", "dbladd", "tail"))


@lru_cache(maxsize=None)
def add_program(n: int, xi0: int, twist_m: bool, K: int, per_warp: int = 1) -> Program:
    """The addition step's program ("add") of one curve for K workers, over
    the ``ADD_STATE`` slots the ``add_step`` kernel fills."""
    return _scheduled(trace("add", n, xi0, twist_m), K, per_warp, ADD_STATE)


def pack(progs, K: int) -> Tuple[np.ndarray, List[int]]:
    """One int32 array for the kernel: the phase table (per phase, K + 1
    instruction offsets: worker w's code is [off[w], off[w + 1])), then the
    code; and the phase ranges [begin, end) of the programs, in order
    (an empty range for a missing one)."""
    table, code, ranges = [], [], []
    nphase = sum(len(p.phases) for p in progs if p is not None)
    base = nphase * (K + 1)
    for prog in progs:
        begin = len(table) // (K + 1)
        for ph in (prog.phases if prog is not None else []):
            for w in range(K):
                table.append(base + len(code))
                code += ph[w]
            table.append(base + len(code))
        ranges += [begin, len(table) // (K + 1)]
    arr = np.array(table + code, dtype=np.int64)
    assert arr.max(initial=0) < 1 << 32
    return arr.astype(np.uint32).view(np.int32), ranges


def emulate_loop(progs, lanes: List[Tuple], bits, p: int, L: int, tail=None,
                 lanes_out: bool = True):
    """The Miller kernels' whole run on Python integers, lane by lane: the
    state's slots as the kernel fills them (Montgomery form: lanes holds
    (xP, yP, (Qx0, Qx1), (Qy0, Qy1)) per lane, tail the BN tail's 8 Montgomery
    words or None), one program a loop bit, the tail program when
    ``lanes_out``.  Returns per lane f's 12 values (and T's 6 when not
    ``lanes_out``) in the kernels' coefficient order."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R
    one = R % p
    out = []
    nslots = max(pr.nslots for pr in progs if pr is not None)
    for xP, yP, Qx, Qy in lanes:
        S = [0] * nslots
        S[F_SLOT] = one
        S[T_SLOT : T_SLOT + 6] = [Qx[0], Qx[1], Qy[0], Qy[1], one, 0]
        S[XP_SLOT], S[YP_SLOT] = xP, yP
        S[QX_SLOT : QX_SLOT + 2], S[QY_SLOT : QY_SLOT + 2] = Qx, Qy
        if tail is not None:
            S[TAIL_SLOT : TAIL_SLOT + 8] = tail
        for b in bits:
            emulate(progs[1] if b else progs[0], S, p, R, npf)
        if lanes_out and progs[2] is not None:
            emulate(progs[2], S, p, R, npf)
        out.append(S[: 12 if lanes_out else 18])
    return out
