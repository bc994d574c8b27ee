"""The product tree of f12 values as a layered program for the split tree
kernel (``f12_tree_split_kernel`` in ``csrc/fexp_split_kernels.cu``).

``f12_seg_product`` multiplies each aligned power-of-two segment of lanes by
a tree: at every level lane i becomes the product of lanes 2i and 2i + 1
(``pairing_cuda.f12_seg_product_plain``).  One level is one f12 product a
lane, 54 base-field products in one layer and the linear steps of Karatsuba
around them; the levels are serial.  So the tree is bound by the latency of
one f12 product times its depth, not by its work, and this module runs it the
way the final-exp kernels run their chains:

* ``trace_mul`` traces ``Tower.f12_mul`` (op for op as ``tower_rows.RowTower``
  computes it) into a program of two operands A (slots 0-11) and B (12-23),
  the product written over A, scheduled with ``miller_prog.schedule`` for the
  K workers of a block (as ``fexp_prog._build`` schedules a multiply);
* a block of G lanes takes 2G input lanes, lane t's A and B being input lanes
  2t and 2t + 1, and runs several levels in shared memory: the program, then
  a PAIR row that moves the products of lanes 2t and 2t + 1 into lane t's A
  and B, the program again, and so on (``tree_steps``).  After ``levels``
  levels lanes t < 2G >> levels hold the products of the block's aligned
  runs of 2^levels input lanes: the plain version's tree, level for level;
* ``pairing_cuda.tree_plan`` splits the log2(seg) levels of a call into
  launches of at most log2(2G) levels each.

The script's rows are ``fexp_prog``'s (op, a, b), with RUN and one more op:

    PAIR a b   slots a..a+23 of lane t <- slots b..b+11 of lanes 2t and
               2t + 1 (every lane reads before any lane writes)

``emulate`` runs the kernel's blocks on Python integers, every lane of a
block and the copies between them, and the tests hold it to the plain
version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

from . import fexp_prog, miller_prog as mp

A, B, TREE_STATE = 0, 12, 24
TREE_PROGRAMS = ("mul",)
RUN = fexp_prog.RUN
PAIR = 4  # after fexp_prog's RUN, ONE, INV, CONST


def trace_mul(n: int, xi0: int):
    """(graph, {slot: node}, free slots) of the tree's program: A = A * B."""
    g = mp.Graph()
    tw = mp.Tower(g, n, xi0, False)
    prod = tw.f12_mul(fexp_prog._f12(g, A), fexp_prog._f12(g, B))
    return g, fexp_prog._out(prod, A), list(range(TREE_STATE))


@lru_cache(maxsize=None)
def tree_programs(n: int, xi0: int, K: int, per_warp: int = 1):
    """The tree's programs (``TREE_PROGRAMS``' order) for K workers,
    ``per_warp`` of them to a warp."""
    return (fexp_prog._build("mul", trace_mul(n, xi0), TREE_STATE, K, per_warp),)


def tree_steps(levels: int) -> list:
    """The steps of a launch that runs ``levels`` levels of the tree."""
    return [(RUN, "mul")] + [(PAIR, A, A), (RUN, "mul")] * (levels - 1)


def max_levels(G: int) -> int:
    """The most levels a block of G lanes runs: its 2G input lanes to one."""
    return (2 * G).bit_length() - 1


def emulate(progs, steps, lanes: List[List[int]], G: int, levels: int, p: int,
            L: int) -> List[List[int]]:
    """One launch on Python integers: ``lanes`` holds each input lane's 12
    values (Montgomery form, the kernels' coefficient order); blocks of 2G
    input lanes, pad lanes zero; returns the len(lanes) >> levels output
    lanes' 12 values."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R
    prog = dict(zip(TREE_PROGRAMS, progs))
    nslots = max(pr.nslots for pr in progs)
    nout, out = 2 * G >> levels, []
    for b0 in range(0, len(lanes), 2 * G):
        S = [[0] * nslots for _ in range(G)]
        for t in range(G):
            for h in range(2):
                if b0 + 2 * t + h < len(lanes):
                    S[t][12 * h : 12 * h + 12] = lanes[b0 + 2 * t + h]
        for op, a, *b in steps:
            if op == RUN:
                for t in range(G):
                    mp.emulate(prog[a], S[t], p, R, npf)
            elif op == PAIR:
                moved = [S[2 * t + h][b[0] : b[0] + 12] for t in range(G // 2) for h in range(2)]
                for t in range(G // 2):
                    S[t][a : a + 24] = moved[2 * t] + moved[2 * t + 1]
            else:
                raise ValueError(f"the tree kernel runs RUN and PAIR rows, not {op}")
        out += [S[t][A : A + 12] for t in range(nout)]
    return out[: len(lanes) >> levels]
