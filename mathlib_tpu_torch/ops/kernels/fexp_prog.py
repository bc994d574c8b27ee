"""The final exponentiation and the Fp12 power chain as layered programs for
the split final-exp kernels (``csrc/fexp_split_kernels.cu``).

The chains of ``final_exp_plain`` and ``f12_pow_plain`` (``pairing_cuda``)
are serial in their steps, but each step -- a cyclotomic or plain squaring,
an Fp12 product, a Frobenius map, the halves of the inverse -- is a few
layers of independent field products.  This module traces the steps with
``miller_prog.Tower``, operation for operation as ``tower_rows.RowTower``
(the plain versions' tower) computes them, and schedules them with ``miller_prog.schedule`` for a block of
K workers, as the Miller programs are:

* ``f12_pow``: ``sqr`` (acc = acc^2, cyclotomic or plain) and ``sqrmul``
  (acc = acc^2 * base), one of the two an exponent bit; the bits are the
  same for every lane, so the block runs one program a bit;
* ``final_exp``, in ``final_exp_plain``'s order: ``pre`` (the inverse down to
  its base-field norm), then the base-field inverse, a loop of 610 serial
  products at BLS12-381 that one worker runs in registers (``fp_pow``'s
  square-and-multiply over the bits of p - 2), then ``post`` (the inverse
  back up, conj(f) / f, frob^2 and the product: f1), then five x-chains of
  ``sqr`` and ``sqrmul`` programs (``conj`` after each when x < 0), with the
  fixed steps between them (``CHAINS``): ``step1`` y = acc conj(f1),
  ``step2`` y = acc conj(y), ``step3`` y = acc frob(y), ``copy_x`` (the
  fifth chain's base is the fourth's result), ``step5a``
  y = (acc frob^2(y)) conj(y), and ``step5b``, the output y (f1^2 f1);
* ``final_exp_bn``, BN curves' whole final exponentiation in
  ``final_exp_bn_plain``'s order: the same ``pre``, inverse and ``post``
  (f1, the easy part), then one chain a base-p digit d_i of the hard-part
  exponent, lowest first (``BN_PROGRAMS``: ``load``, acc = f1 for d_i's
  leading one, then ``sqr`` and ``sqrmul``, the cyclotomic squaring and
  the multiply by f1, over the bits after it), each folded into the
  running product y: ``copy`` (y = acc, after digit 0), then
  ``frob_odd`` / ``frob_even`` (y = y frob^i(acc), gamma_i in GAM).  y
  lives in F's slots, dead once ``post`` has read the input, so the last
  product lands in the output slot.

A 32-lane block at 12 words has room for 151 slots.  So the programs are
scheduled with at most K products a layer and each linear value in the last
gap before its first reader (``schedule``'s ``cap`` and ``alap``), a
program may use every state slot that no later step reads, and the kernel
writes the Frobenius constant gamma_n into GAM just before each of the three
programs that read it (``GAMMA_OF``): BLS12-381 then needs 144 slots.  The
squarings, the bulk of every chain, also recompute up to two operands a
worker in their last gap (``recompute``): at BLS12-381 a cyclotomic squaring
is then 5 phases and 14 instructions on its critical worker, not 6 and 21.

Each chain starts from acc = 1, BN's digit chains from acc = f1.  The
values are those of the plain versions
``f12_pow_plain``, ``final_exp_plain`` and ``final_exp_bn_plain``, limb for
limb: ``emulate`` runs a kernel's whole script on Python integers,
and the tests hold it to the plain versions.

Fixed slots (an f12 is 12 slots in the kernels' coefficient order
q = (h * 3 + j) * 2 + c):

    f12_pow:    ACC 0, BASE 12; 24 state slots
    final_exp:  F 0 (the input; later the fifth chain's base and the
                output), F1 12, Y 24, ACC 36, GAM 48, the inverse's
                cofactors C 60 (an f6), its f2 norm N2 66, its base-field
                norm NORM 68 and inverse NINV 69; 70 state slots
    final_exp_bn: the same, Y unused (y is F)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from . import miller_prog as mp

# f12_pow
ACC, BASE, POW_STATE = 0, 12, 24
POW_PROGRAMS = ("sqr_cyclo", "sqrmul_cyclo", "sqr", "sqrmul")
# final_exp
F, F1, Y, FX_ACC, GAM, C, N2, NORM, NINV, FEXP_STATE = 0, 12, 24, 36, 48, 60, 66, 68, 69, 70
X = F  # the fifth x-chain's base
FEXP_PROGRAMS = ("pre", "post", "sqr", "sqrmul_f1", "sqrmul_y", "sqrmul_x", "conj", "step1",
                 "step2", "step3", "copy_x", "step5a", "step5b")
SQRMUL_BASE = {"sqrmul_f1": F1, "sqrmul_y": Y, "sqrmul_x": X}
# the five x-chains: each one's sqrmul program, and the step after it
CHAINS = (("sqrmul_f1", "step1"), ("sqrmul_y", "step2"), ("sqrmul_y", "step3"),
          ("sqrmul_y", "copy_x"), ("sqrmul_x", "step5a"))
GAMMA_OF = {"post": 2, "step3": 1, "step5a": 2}  # the kernel writes gamma_n into GAM first
# the f12 values a program must leave as they are: read by a later step and
# not written by this one (every other state slot may hold its values)
KEEP = {"pre": (F,), "post": (), "sqr": (F1, Y, X), "sqrmul_f1": (F1,), "sqrmul_y": (F1, Y),
        "sqrmul_x": (F1, Y, X), "conj": (F1, Y, X), "step1": (F1,), "step2": (F1,),
        "step3": (F1,), "copy_x": (F1, Y), "step5a": (F1,), "step5b": ()}
# final_exp_bn: the digit chains read f1 and must keep y (in F) between them
BN_PROGRAMS = ("pre", "post", "load", "sqr", "sqrmul", "copy", "frob_odd", "frob_even")
KEEP_BN = {"pre": (F,), "post": (), "load": (F1, F), "sqr": (F1, F), "sqrmul": (F1, F),
           "copy": (F1,), "frob_odd": (F1,), "frob_even": (F1,)}
BN_DIGITS = 4  # the constants reach gamma_3: digits 0-3


def _f12(g: mp.Graph, s: int):
    return tuple(tuple((g.leaf(s + 2 * (3 * h + j)), g.leaf(s + 2 * (3 * h + j) + 1))
                       for j in range(3)) for h in range(2))


def _out(f, s: int) -> Dict[int, int]:
    return {s + 2 * (3 * h + j) + c: f[h][j][c]
            for h in range(2) for j in range(3) for c in range(2)}


def _slots(*starts: int) -> List[int]:
    return [s + q for s in starts for q in range(12)]


def trace_pow(kind: str, n: int, xi0: int):
    """(graph, {slot: node}, free slots) of one f12_pow program
    (``POW_PROGRAMS``)."""
    g = mp.Graph()
    tw = mp.Tower(g, n, xi0, False)
    a = _f12(g, ACC)
    a = tw.f12_cyclo_sqr(a) if kind.endswith("cyclo") else tw.f12_sqr(a)
    if kind.startswith("sqrmul"):
        a = tw.f12_mul(a, _f12(g, BASE))
    return g, _out(a, ACC), _slots(ACC)


def trace_fexp(kind: str, n: int, xi0: int):
    """(graph, {slot: node}, free slots) of one final-exp program
    (``FEXP_PROGRAMS``)."""
    g = mp.Graph()
    tw = mp.Tower(g, n, xi0, False)
    f12 = lambda s: _f12(g, s)  # noqa: E731
    if kind == "pre":
        c, n2 = tw.f6_inv_norm(tw.f12_inv_norm(f12(F)))
        outs = {C + 2 * j + k: c[j][k] for j in range(3) for k in range(2)}
        outs.update({N2: n2[0], N2 + 1: n2[1], NORM: tw.f2_inv_norm(n2)})
    elif kind == "post":
        c = tuple((g.leaf(C + 2 * j), g.leaf(C + 2 * j + 1)) for j in range(3))
        inv2 = tw.f2_inv_finish((g.leaf(N2), g.leaf(N2 + 1)), g.leaf(NINV))
        finv = tw.f12_inv_finish(f12(F), tw.f6_inv_finish(c, inv2))
        t = tw.f12_mul(tw.f12_conj(f12(F)), finv)  # f^(p^6 - 1)
        outs = _out(tw.f12_mul(tw.f12_frob(t, f12(GAM), 2), t), F1)  # ^(p^2 + 1)
    elif kind == "sqr":
        outs = _out(tw.f12_cyclo_sqr(f12(FX_ACC)), FX_ACC)
    elif kind in SQRMUL_BASE:
        acc = tw.f12_cyclo_sqr(f12(FX_ACC))
        outs = _out(tw.f12_mul(acc, f12(SQRMUL_BASE[kind])), FX_ACC)
    elif kind == "conj":
        outs = _out(tw.f12_conj(f12(FX_ACC)), FX_ACC)
    elif kind in ("step1", "step2", "step3"):
        other = {"step1": lambda: tw.f12_conj(f12(F1)), "step2": lambda: tw.f12_conj(f12(Y)),
                 "step3": lambda: tw.f12_frob(f12(Y), f12(GAM), 1)}[kind]()
        outs = _out(tw.f12_mul(f12(FX_ACC), other), Y)
    elif kind == "copy_x":
        outs = _out(f12(FX_ACC), X)
    elif kind == "step5a":  # y = (acc frob^2(y)) conj(y)
        t = tw.f12_mul(f12(FX_ACC), tw.f12_frob(f12(Y), f12(GAM), 2))
        outs = _out(tw.f12_mul(t, tw.f12_conj(f12(Y))), Y)
    elif kind == "step5b":  # the output, y f1^3
        outs = _out(tw.f12_mul(f12(Y), tw.f12_mul(tw.f12_sqr(f12(F1)), f12(F1))), F)
    else:
        raise ValueError(f"no final-exp program {kind!r}")
    keep = set(_slots(*KEEP[kind]))
    return g, outs, [s for s in range(FEXP_STATE) if s not in keep]


def trace_fexp_bn(kind: str, n: int, xi0: int):
    """(graph, {slot: node}, free slots) of one BN final-exp program
    (``BN_PROGRAMS``)."""
    if kind in ("pre", "post"):
        g, outs, _ = trace_fexp(kind, n, xi0)
    else:
        g = mp.Graph()
        tw = mp.Tower(g, n, xi0, False)
        f12 = lambda s: _f12(g, s)  # noqa: E731
        if kind == "load":
            outs = _out(f12(F1), FX_ACC)
        elif kind == "sqr":
            outs = _out(tw.f12_cyclo_sqr(f12(FX_ACC)), FX_ACC)
        elif kind == "sqrmul":
            outs = _out(tw.f12_mul(tw.f12_cyclo_sqr(f12(FX_ACC)), f12(F1)), FX_ACC)
        elif kind == "copy":
            outs = _out(f12(FX_ACC), F)
        elif kind in ("frob_odd", "frob_even"):  # y = y frob^i(acc)
            part = tw.f12_frob(f12(FX_ACC), f12(GAM), 1 if kind == "frob_odd" else 2)
            outs = _out(tw.f12_mul(f12(F), part), F)
        else:
            raise ValueError(f"no BN final-exp program {kind!r}")
    keep = set(_slots(*KEEP_BN[kind]))
    return g, outs, [s for s in range(FEXP_STATE) if s not in keep]


SQUARINGS = ("sqr", "sqr_cyclo")  # recompute shortens their last phases (not the others')


def _build(kind: str, traced, n_state: int, K: int, per_warp: int) -> mp.Program:
    g, outs, free = traced
    prog = mp.schedule(g, outs, K, n_state, free, cap=K, alap=True,
                       recompute=2 if kind in SQUARINGS else 0)
    mp.check_races(prog)
    if per_warp > 1:
        mp.align(prog, per_warp)
    return prog


@lru_cache(maxsize=None)
def pow_programs(n: int, xi0: int, K: int, per_warp: int = 1) -> Tuple[mp.Program, ...]:
    """The f12_pow programs of one curve for K workers, ``per_warp`` of them
    to a warp, in ``POW_PROGRAMS``' order."""
    return tuple(_build(kind, trace_pow(kind, n, xi0), POW_STATE, K, per_warp)
                 for kind in POW_PROGRAMS)


@lru_cache(maxsize=None)
def fexp_programs(n: int, xi0: int, K: int, per_warp: int = 1) -> Tuple[mp.Program, ...]:
    """The final-exp programs of one curve, in ``FEXP_PROGRAMS``' order."""
    return tuple(_build(kind, trace_fexp(kind, n, xi0), FEXP_STATE, K, per_warp)
                 for kind in FEXP_PROGRAMS)


@lru_cache(maxsize=None)
def fexp_bn_programs(n: int, xi0: int, K: int, per_warp: int = 1) -> Tuple[mp.Program, ...]:
    """The BN final-exp programs of one curve, in ``BN_PROGRAMS``' order."""
    return tuple(_build(kind, trace_fexp_bn(kind, n, xi0), FEXP_STATE, K, per_warp)
                 for kind in BN_PROGRAMS)


# ------------------------------------------------------------------- scripts --
# A kernel's run is a script of steps (csrc/fexp_split_kernels.cu), one
# (op, a, b) row each: RUN the phases [a, b) of a program; ONE: the f12 one
# into slots a..a+11; INV: S[b] = S[a]^(p - 2) by one worker, over the
# kernel's inverse bits; CONST: the 12 values b..b+11 of the kernel's
# constants (gamma_1, gamma_2, then gamma_3) into slots a..a+11.  The bits of the
# exponent, |x| and x's sign are in the script; the host builds it once per
# exponent, so one build of the kernels serves every curve and exponent.
RUN, ONE, INV, CONST = range(4)


def pow_steps(bits, cyclo: bool) -> list:
    """f12_pow's steps: acc = 1, then one program a bit."""
    sqr, sqrmul = POW_PROGRAMS[:2] if cyclo else POW_PROGRAMS[2:]
    return [(ONE, ACC)] + [(RUN, sqrmul if b else sqr) for b in bits]


def fexp_steps(x_bits, x_neg: bool) -> list:
    """final_exp's steps, in ``final_exp_plain``'s order."""
    out = [(RUN, "pre"), (INV, NORM, NINV)]

    def run(kind):
        if kind in GAMMA_OF:
            out.append((CONST, GAM, 12 * (GAMMA_OF[kind] - 1)))
        out.append((RUN, kind))

    run("post")
    for mul, step in CHAINS:
        out.append((ONE, FX_ACC))
        out.extend((RUN, mul if b else "sqr") for b in x_bits)
        if x_neg:
            run("conj")
        run(step)
    run("step5b")
    return out


def check_bn_digits(digit_bits) -> None:
    """ValueError unless there are 1 to ``BN_DIGITS`` digits, each one's
    MSB-first bits led by a one (every digit > 0)."""
    if not 0 < len(digit_bits) <= BN_DIGITS:
        raise ValueError(f"the BN script takes 1 to {BN_DIGITS} digits, got {len(digit_bits)}")
    if not all(len(bits) and bits[0] for bits in digit_bits):
        raise ValueError("each BN digit's bits must start with its leading one")


def fexp_bn_steps(digit_bits) -> list:
    """final_exp_bn's steps: the easy part as ``fexp_steps``', then one
    cyclotomic chain a digit, lowest digit first: acc = f1 for the leading
    one, one program for each bit after it; each chain folded into y as
    ``final_exp_bn_plain`` folds it."""
    check_bn_digits(digit_bits)
    out = [(RUN, "pre"), (INV, NORM, NINV), (CONST, GAM, 12), (RUN, "post")]
    for i, bits in enumerate(digit_bits):
        out.append((RUN, "load"))
        out.extend((RUN, "sqrmul" if b else "sqr") for b in bits[1:])
        if i:
            out += [(CONST, GAM, 12 * (i - 1)), (RUN, "frob_odd" if i % 2 else "frob_even")]
        else:
            out.append((RUN, "copy"))
    return out


def encode_steps(steps, names, ranges) -> np.ndarray:
    """The (n, 3) int32 script of ``steps``; ``names`` and ``ranges`` are the
    programs' names and ``miller_prog.pack``'s phase ranges."""
    at = dict(zip(names, zip(ranges[0::2], ranges[1::2])))
    rows = [(RUN, *at[st[1]]) if st[0] == RUN else (st + (0,))[:3] for st in steps]
    return np.array(rows, dtype=np.int32).reshape(-1, 3)


# ------------------------------------------------------------------- emulate --
def emulate(progs: Dict[str, mp.Program], steps, lanes: List[List[int]], in_slot: int,
            out_slot: int, p: int, L: int, inv_bits=(), consts=()):
    """A kernel's run on Python integers, lane by lane: the lane's 12 input
    values (Montgomery form, the kernels' coefficient order) into
    ``in_slot``, the steps (the programs by name), the 12 values at
    ``out_slot`` out.  ``consts``: gamma_1's 12 values, then gamma_2's
    (and gamma_3's)."""
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R
    one = R % p

    def mul(a, b):
        t = a * b
        return (t + (t * npf % R) * p) // R

    nslots = max(pr.nslots for pr in progs.values())
    out = []
    for vals in lanes:
        S = [0] * nslots
        S[in_slot : in_slot + 12] = vals
        for op, a, *b in steps:
            if op == RUN:
                mp.emulate(progs[a], S, p, R, npf)
            elif op == ONE:
                S[a : a + 12] = [one] + [0] * 11
            elif op == CONST:
                S[a : a + 12] = consts[b[0] : b[0] + 12]
            else:  # fp_pow's square and multiply, as one worker runs it
                acc = one
                for bit in inv_bits:
                    acc = mul(acc, acc)
                    if bit:
                        acc = mul(acc, S[a])
                S[b[0]] = acc
        out.append(S[out_slot : out_slot + 12])
    return out
