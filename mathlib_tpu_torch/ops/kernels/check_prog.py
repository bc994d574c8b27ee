"""The one-launch pairing check as step scripts for ``pairing_check_kernel``
(``csrc/check_kernels.cu``).

The kernel runs the split kernels' programs on their interpreter
(``csrc/prog_interp.cuh``), in one launch: each lane's Miller loop (the
programs of ``miller_prog``), each block's product tree (``tree_prog``'s),
the product of the blocks' partials in the block that finishes last, and the
final exponentiation of that product (``fexp_prog``'s) on one lane.  What a
launch does is a script of (op, a, b) rows in two parts, built here on the
host once per curve, block shape and tree width:

* part 1, on the block's G lanes and K workers (the Miller block):

    SKIP n     a block none of whose lanes is below nvalid skips the next n
               rows (its Miller loops: their values are masked to one)
    RUN        a program's phases: one Miller program a loop bit ("dbl" or
               "dbladd"), the loop's end ("tail") where there is one, and
               the tree's f12 product ("mul": A = A * B)
    MASK       lanes at or past nvalid (the pad lanes up to the tree's width
               W included) take the f12 one in f's slots, the tree's A
    PAIR a b   the tree's: lane t's slots a..a+23 <- lanes 2t and 2t + 1's
               slots b..b+11
    PUBLISH    lane 0 stores the block's product to the scratch slot of the
               block, fences and takes a ticket; every block but the last to
               take one leaves
    LOAD a m   the last block: lane t's A, B <- partials a + 2t, a + 2t + 1
               (those below a + m)
    STORE a    lane 0's A -> partial a (a round's product, read by the next)
    PROD       lane 0's A -> the unreduced product (``prod_out``)

* part 2, on 8 lanes of 64 workers (``pairing_cuda.fexp_shape``'s block for
  one lane): the product into lane 0's input slots, ``fexp_prog.fexp_steps``
  (RUN, ONE, INV and CONST rows), then the unity test.

``plan`` gives a launch's tree: a block of G lanes multiplies its lanes in
log2(min(G, W)) levels (lanes past W never enter the tree, and a product by
one is not bit-neutral in relaxed limbs, so a block of W < G lanes runs
fewer levels); the last block reduces the W / G partials 2G at a time,
round after round.  Every level pairs lanes 2i and 2i + 1, so the product is
``f12_seg_product_plain``'s over the W lanes, bit for bit, and the check's
outputs are ``pairing_check_plain``'s.  ``emulate`` runs a launch's scripts on
Python integers, block by block, and the tests hold it to the plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import fexp_prog, miller_prog as mp, tree_prog

RUN, ONE, INV, CONST = fexp_prog.RUN, fexp_prog.ONE, fexp_prog.INV, fexp_prog.CONST
PAIR = tree_prog.PAIR
SKIP, MASK, PUBLISH, LOAD, STORE, PROD = range(5, 11)
A = tree_prog.A
# part 1's programs, in the packed order: the Miller loop's (miller_prog's
# dbl, dbladd, tail) and the tree's product
PART1_PROGRAMS = ("dbl", "dbladd", "tail", "mul")
FEXP_GROUP, FEXP_WORKERS = 8, 64  # part 2's block: 8 lanes of 64 workers


def tree_width(B: int) -> int:
    """The lanes of a product tree over B lanes: the next power of two."""
    return 1 << max(0, B - 1).bit_length()


@dataclass(frozen=True)
class Plan:
    """One launch's tree over B lanes with blocks of G lanes: the tree's
    width W, the blocks, the levels each block runs, the blocks that run
    their Miller loops (those with a lane below nvalid), and the last
    block's rounds (partials in, partials a chunk, levels a chunk)."""

    width: int
    blocks: int
    block_levels: int
    miller_blocks: Tuple[bool, ...]
    rounds: Tuple[Tuple[int, int, int], ...]


def plan(B: int, nvalid: int, G: int) -> Plan:
    """The tree of a launch over B lanes, nvalid of them real, in blocks of
    G lanes (a power of two)."""
    if B < 0 or G < 1 or G & (G - 1):
        raise ValueError(f"a check takes B >= 0 lanes and a power-of-two block, got {B}, {G}")
    W = tree_width(B)
    blocks = max(1, W // G)
    rounds, c = [], blocks
    while c > 1:
        m = min(2 * G, c)
        rounds.append((c, m, m.bit_length() - 1))
        c //= m
    return Plan(W, blocks, min(G, W).bit_length() - 1,
                tuple(b * G < nvalid for b in range(blocks)), tuple(rounds))


def check_steps(pl: Plan, loop_bits: Sequence[int], tail: bool) -> list:
    """Part 1's steps (program names in RUN rows): the Miller loop (skipped
    by blocks with no real lane), the mask, the block's levels, and when
    there are several blocks the ticket and the last block's rounds; the
    product out."""
    miller = [(RUN, "dbladd" if b else "dbl") for b in loop_bits] + ([(RUN, "tail")] if tail else [])
    out = [(SKIP, len(miller), 0)] + miller + [(MASK, 0, 0)]
    out += [(PAIR, A, A), (RUN, "mul")] * pl.block_levels
    if pl.blocks > 1:
        out.append((PUBLISH, 0, 0))
        for r, (count, m, levels) in enumerate(pl.rounds):
            for chunk in range(count // m):
                out += [(LOAD, chunk * m, m), (RUN, "mul")]
                out += [(PAIR, A, A), (RUN, "mul")] * (levels - 1)
                if r + 1 < len(pl.rounds):
                    out.append((STORE, chunk, 0))
    out.append((PROD, 0, 0))
    return out


def emulate(progs1: Dict[str, Optional[mp.Program]], steps1, progs2: Dict[str, mp.Program],
            steps2, lanes: List[Tuple], nvalid: int, G: int, p: int, L: int, inv_bits,
            consts, tail=None):
    """A launch on Python integers: ``lanes`` holds each lane's (xP, yP,
    (Qx0, Qx1), (Qy0, Qy1)) in Montgomery form (``miller_prog.emulate_loop``'s
    order), ``tail`` the BN tail's constants or None; the blocks run part 1
    in block order, the last of them then reduces the partials, and part 2
    runs on the product (``fexp_prog.emulate``; ``consts``: gamma_1's and
    gamma_2's 12 values).  A lane at or past nvalid runs no Miller program
    here (the kernel's runs on zeros and is masked to one).  Returns the
    product's and the reduced value's 12 values and the unity verdict."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R
    one = R % p
    f12_one = [one] + [0] * 11
    nvalid = max(0, min(nvalid, len(lanes)))  # the launcher's clamp
    pl = plan(len(lanes), nvalid, G)
    nslots = max(pr.nslots for pr in progs1.values() if pr is not None)
    partials, S, prod = {}, None, None
    for blk in range(pl.blocks):
        S = [[0] * nslots for _ in range(G)]
        for t in range(G):
            i = blk * G + t
            S[t][mp.F_SLOT] = one
            S[t][mp.T_SLOT + 4] = one
            if i < nvalid:
                xP, yP, Qx, Qy = lanes[i]
                S[t][mp.T_SLOT : mp.T_SLOT + 4] = [Qx[0], Qx[1], Qy[0], Qy[1]]
                S[t][mp.XP_SLOT], S[t][mp.YP_SLOT] = xP, yP
                S[t][mp.QX_SLOT : mp.QX_SLOT + 2], S[t][mp.QY_SLOT : mp.QY_SLOT + 2] = Qx, Qy
            if tail is not None:
                S[t][mp.TAIL_SLOT : mp.TAIL_SLOT + 8] = tail
        s, last = 0, blk == pl.blocks - 1
        while s < len(steps1):
            op, *ab = steps1[s]
            s += 1
            if op == SKIP:
                if not pl.miller_blocks[blk]:
                    s += ab[0]
            elif op == RUN:
                real = ab[0] not in ("dbl", "dbladd", "tail")
                for t in range(G):
                    if real or blk * G + t < nvalid:
                        mp.emulate(progs1[ab[0]], S[t], p, R, npf)
            elif op == MASK:
                for t in range(G):
                    if blk * G + t >= nvalid:
                        S[t][A : A + 12] = list(f12_one)
            elif op == PAIR:
                moved = [S[2 * t + h][ab[1] : ab[1] + 12] for t in range(G // 2) for h in range(2)]
                for t in range(G // 2):
                    S[t][ab[0] : ab[0] + 24] = moved[2 * t] + moved[2 * t + 1]
            elif op == PUBLISH:
                partials[blk] = S[0][A : A + 12]
                if not last:
                    break
            elif op == LOAD:
                first, m = ab
                for t in range(G):
                    for h in range(2):
                        if 2 * t + h < m:
                            S[t][12 * h : 12 * h + 12] = list(partials[first + 2 * t + h])
            elif op == STORE:
                partials[ab[0]] = S[0][A : A + 12]
            elif op == PROD:
                prod = S[0][A : A + 12]
            else:
                raise ValueError(f"part 1 runs no row {op}")
    red = fexp_prog.emulate(progs2, steps2, [prod], fexp_prog.F, fexp_prog.F, p, L, inv_bits,
                            consts)[0]
    return prod, red, [v % p for v in red] == f12_one
