"""The programs of the split final-exp kernels (``ops/kernels/fexp_prog.py``,
``csrc/fexp_split_kernels.cu``) on the CPU.

* Each program, emulated on Python integers, against a plain evaluation of
  its graph on random relaxed [0, 2p) slots: scheduling and slot reuse keep
  every value, and the state a later step reads.
* The kernels' whole run, emulated (the script: the programs, acc = 1 before
  each chain (BN's digit chains: acc = f1), the base-field inverse loop, the Frobenius constants), against
  ``final_exp_plain`` on BLS12-381 and BLS12-377 and on BN254 over its own
  x, and against ``f12_pow_plain`` with and without cyclotomic squaring on
  BN254 (a hard-part digit) and BLS12-381 (|x|), full chains, at each block
  the launcher can pick for the curve -- and through the plain versions
  against the reference kernel bodies (``tests/test_torch_final_exp.py``);
  BN254's one-launch final exp (``final_exp_bn``: the real easy part, four
  short digits) against ``final_exp_bn_plain`` the same way (its full
  digits: ``tests/test_torch_final_exp.py``).  Tolerance: exact (every
  limb).
* No worker touches a slot another worker writes in the same phase; the
  workers of a warp have their products at the same instruction index;
  the script's rows run the programs ``pack`` laid out; the products the
  scripts run are the ones the bound counts; the launcher's choice of block
  at 4,096, 1,024, 64 and 1 lanes.

The kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.ops.kernels import fexp_prog as fp
from mathlib_tpu_torch.ops.kernels import miller_prog as mp
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.kernels.tower_rows import (
    f12_pow_mults,
    final_exp_bn_mults,
    final_exp_mults,
    pow_mults,
)

torch.set_num_threads(1)

CURVES = ["BLS12_381", "BN254", "BLS12_377"]
KINDS = {"f12_pow": (fp.trace_pow, fp.POW_STATE), "final_exp": (fp.trace_fexp, fp.FEXP_STATE),
         "final_exp_bn": (fp.trace_fexp_bn, fp.FEXP_STATE)}
BN_SHORT = ([1, 0, 1], [1, 1], [1, 0, 0], [1])  # synthetic digits: every program, each gamma


def _kcfg(curve):
    return BatchEngine(get_spec(curve), "cpu").tw.kcfg


def _x_bits(curve):
    return pc.msb_bits(abs(get_spec(curve).x))


def _shapes(kcfg, kind):
    """The (G, K) blocks the launcher picks at 4,096, 1,024 and 1 lanes."""
    return sorted({pc.fexp_shape(kcfg, kind, n) for n in (4096, 1024, 1)}, reverse=True)


def _ints(t, q, L):
    """(q, L, B) limbs -> [lane][q] integers."""
    a = t.reshape(q, L, -1).to(torch.int64).numpy().astype(object)
    return (a * np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
            ).sum(axis=1).T.tolist()


def _graph_eval(g, S, p, R):
    npf = (-pow(p, -1, R)) % R
    val = {}
    for v, (op, *a) in enumerate(g.nodes):
        if op == "leaf":
            val[v] = S[a[0]]
        elif op == "mul":
            t = val[a[0]] * val[a[1]]
            val[v] = (t + (t * npf % R) * p) // R
        else:
            x = val[a[0]] + val[a[1]] if op == "add" else (
                val[a[0]] - val[a[1]] if op == "sub" else -val[a[0]])
            val[v] = x - 2 * p if x >= 2 * p else x + 2 * p if x < 0 else x
    return val


def test_launcher_picks_the_block_from_the_lane_count():
    """4,096 BLS12-381 lanes (pairing_batch) in 32-lane blocks; 1,024
    (GROUP_FEXP=device, BN254's digit chains), 64 and 1 (split) in 8-lane
    blocks; BLS12-377's final exp needs more slots than a 32-lane block
    holds, so 16-lane blocks at 4,096."""
    bls, bn, b377 = (_kcfg(c) for c in CURVES)
    W = pc.MILLER_WORKERS
    assert pc.fexp_shape(bls, "final_exp", 4096) == (32, W[32])
    for lanes in (1024, 64, 1):
        assert pc.fexp_shape(bls, "final_exp", lanes) == (8, W[8])
        assert pc.fexp_shape(bn, "f12_pow", lanes) == (8, W[8])
    assert pc.fexp_shape(bls, "final_exp", 2048) == (16, W[16])
    assert pc.fexp_shape(bn, "final_exp_bn", 1024) == (8, W[8])  # pairing_batch
    assert pc.fexp_shape(bn, "final_exp_bn", 4096) == (32, W[32])
    _, slots, words = pc.fexp_programs(b377, "final_exp", 32)
    assert slots * words * 4 > pc.MILLER_SMEM
    assert pc.fexp_shape(b377, "final_exp", 4096) == (16, W[16])


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_programs_fit_shared_memory_and_keep_to_their_slots(curve, kind):
    kcfg = _kcfg(curve)
    names = pc.FEXP_KINDS[kind][1]
    for G, K in _shapes(kcfg, kind):
        progs, slots, words = pc.fexp_programs(kcfg, kind, G)
        assert slots * words * 4 <= pc.MILLER_SMEM and words >= kcfg.fp.L // 2 * G
        code, ranges = mp.pack(progs, K)
        words32 = code.view(np.uint32)
        for prog, begin, end in zip(progs, ranges[0::2], ranges[1::2]):
            assert end - begin == len(prog.phases)
            for p, ph in enumerate(prog.phases):
                offs = words32[(begin + p) * (K + 1) : (begin + p + 1) * (K + 1)]
                assert [list(words32[offs[w] : offs[w + 1]]) for w in range(K)] == ph
                for code_w in ph:
                    for word in code_w:
                        assert all(s is None or s < slots for s in mp.fields(word)[1:])
            mp.check_races(prog)
        by_name = dict(zip(names, progs))
        if kind == "f12_pow":
            assert by_name["sqr_cyclo"].products == 9 * (2 if kcfg.tower.n == 1 else 3)
            assert by_name["sqr"].products == 36
            assert by_name["sqrmul"].products == 36 + 54
        if kind == "final_exp_bn":  # the chains' programs as f12_pow's cyclotomic ones
            sq = 9 * (2 if kcfg.tower.n == 1 else 3)
            assert by_name["sqr"].products == sq and by_name["sqrmul"].products == sq + 54
            assert by_name["copy"].products == by_name["load"].products == 0
            assert by_name["frob_odd"].products == by_name["frob_even"].products == 18 + 54


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_each_program_keeps_every_value(curve, kind):
    """Random relaxed slots through each program against its graph; the
    state slots it may not touch keep their values."""
    kcfg = _kcfg(curve)
    tw = kcfg.tower
    p, L = kcfg.fp.p, kcfg.fp.L
    R = 1 << (16 * L)
    trace, n_state = KINDS[kind]
    rnd = random.Random(5)
    for G, _ in _shapes(kcfg, kind):
        progs = pc.fexp_programs(kcfg, kind, G)[0]
        for name, prog in zip(pc.FEXP_KINDS[kind][1], progs):
            g, outs, free = trace(name, tw.n, tw.xi0)
            S = [rnd.randrange(2 * p) for _ in range(prog.nslots)]
            kept = {s: S[s] for s in range(n_state) if s not in free}
            want = _graph_eval(g, S, p, R)
            mp.emulate(prog, S, p, R, (-pow(p, -1, R)) % R)
            assert {s: S[s] for s in outs} == {s: want[v] for s, v in outs.items()}, name
            assert {s: S[s] for s in kept} == kept, name


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_warp_partners_multiply_at_the_same_index(curve, kind):
    kcfg = _kcfg(curve)
    for G, K in _shapes(kcfg, kind):
        if G == 32:
            continue
        for prog in pc.fexp_programs(kcfg, kind, G)[0]:
            for ph in prog.phases:
                for w0 in range(0, K, 32 // G):
                    at = [{i for i, w in enumerate(c) if w & 15 == mp.MUL}
                          for c in ph[w0 : w0 + 32 // G]]
                    for a in at:
                        for b in at:
                            assert sorted(a)[: len(b)] == sorted(b)[: len(a)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_scripts_run_the_packed_programs_and_the_counted_products(kind):
    """The launch's script (as the wrapper builds it for the card): each RUN
    row is its program's phase range in the packed code, and the products
    it runs (with the inverse loop's) are those ``final_exp_mults`` and
    ``f12_pow_mults`` count for the bound."""
    curve = "BN254" if kind == "final_exp_bn" else "BLS12_381"
    kcfg = _kcfg(curve)
    tw, bits = kcfg.tower, _x_bits(curve)
    names = pc.FEXP_KINDS[kind][1]
    if kind == "final_exp_bn":
        steps = fp.fexp_bn_steps(kcfg.digit_bits)
        want = final_exp_bn_mults(tw.n, tw.twist, kcfg.inv_bits, kcfg.digit_bits)
    elif kind == "final_exp":
        steps = fp.fexp_steps(bits, True)
        want = final_exp_mults(tw.n, tw.twist, kcfg.inv_bits, bits)
    else:
        steps = fp.pow_steps(bits, True)
        want = f12_pow_mults(tw.n, tw.twist, bits, True)
    for lanes in (4096, 1):
        G, K = pc.fexp_shape(kcfg, kind, lanes)
        code, script, meta = pc._fexp_launch_args(kcfg, kind, "cpu", lanes, ("test", kind),
                                                  lambda: steps)
        progs = pc.fexp_programs(kcfg, kind, G)[0]
        assert list(meta) == [G, K, max(p.nslots for p in progs), pc.slot_words(kcfg.fp.L, G)]
        _, ranges = mp.pack(progs, K)
        at = dict(zip(names, zip(ranges[0::2], ranges[1::2])))
        by_name = dict(zip(names, progs))
        assert script.dtype == torch.int32 and script.shape == (len(steps), 3)
        products = 0
        for row, step in zip(script.tolist(), steps):
            if step[0] == fp.RUN:
                assert row == [fp.RUN, *at[step[1]]]
                products += by_name[step[1]].products
            else:
                assert row == list(step) + [0] * (3 - len(step))
                if step[0] == fp.INV:
                    products += pow_mults(kcfg.inv_bits)
        assert products == want
    if kind == "final_exp_bn":  # gamma_2 for post, then gamma_1, 2, 3 before the folds
        assert [s[2] for s in steps if s[0] == fp.CONST] == [12, 0, 12, 24]
        return
    runs = [s[1] for s in fp.fexp_steps(bits, False) if s[0] == fp.RUN]
    assert "conj" not in runs and runs.count("sqr") == 5 * (len(bits) - int(bits.sum()))


def _lanes_in(kcfg, seed, B=2):
    """B lanes of random relaxed [0, 2p) f12 values: the (2, 3, 2, L, B)
    tensor and the same as [lane][12] integers."""
    p, L = kcfg.fp.p, kcfg.fp.L
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(64), "big") % (2 * p) for _ in range(12)] for _ in range(B)]
    limbs = np.array([[[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in lane]
                      for lane in vals])
    return torch.from_numpy(limbs.transpose(1, 2, 0).reshape(2, 3, 2, L, B).astype(np.int32)), vals


@pytest.mark.parametrize("curve", CURVES)
def test_final_exp_run_equals_the_plain_version(curve):
    kcfg = _kcfg(curve)
    spec = get_spec(curve)
    p, L = kcfg.fp.p, kcfg.fp.L
    x_bits, x_neg = _x_bits(curve), spec.x < 0
    f, vals = _lanes_in(kcfg, 3)
    want = _ints(pc.final_exp_plain(kcfg, f, kcfg.inv_bits, x_bits, x_neg), 12, L)
    gammas = _ints(kcfg.gammas.to(torch.int64), 36, L)[0]
    for G, _ in _shapes(kcfg, "final_exp"):
        progs = dict(zip(fp.FEXP_PROGRAMS, pc.fexp_programs(kcfg, "final_exp", G)[0]))
        got = fp.emulate(progs, fp.fexp_steps(x_bits, x_neg), vals, fp.F, fp.F, p, L,
                         kcfg.inv_bits, gammas)
        assert got == want, G


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
@pytest.mark.parametrize("cyclo", [True, False])
def test_f12_pow_run_equals_the_plain_version(curve, cyclo):
    """BN254 over its first hard-part digit (as pairing_batch runs it),
    BLS12-381 over |x|."""
    kcfg = _kcfg(curve)
    spec = get_spec(curve)
    p, L = kcfg.fp.p, kcfg.fp.L
    bits = pc.msb_bits(spec.hard_part_exp % spec.p) if curve == "BN254" else _x_bits(curve)
    f, vals = _lanes_in(kcfg, 4)
    want = _ints(pc.f12_pow_plain(kcfg, f, bits, cyclo), 12, L)
    for G, _ in _shapes(kcfg, "f12_pow"):
        progs = dict(zip(fp.POW_PROGRAMS, pc.fexp_programs(kcfg, "f12_pow", G)[0]))
        assert fp.emulate(progs, fp.pow_steps(bits, cyclo), vals, fp.BASE, fp.ACC, p, L) == want


def test_final_exp_bn_run_equals_the_plain_version():
    """BN254's whole final exp as one script: the real easy part (the
    inverse over p - 2, gamma_2), then four short digit chains folded with
    gamma_1, gamma_2 and gamma_3, on 1 lane at every block the launcher can
    pick."""
    kcfg = _kcfg("BN254")
    p, L = kcfg.fp.p, kcfg.fp.L
    digits = [np.array(b, np.uint8) for b in BN_SHORT]
    f, vals = _lanes_in(kcfg, 16, B=1)
    want = _ints(pc.final_exp_bn_plain(kcfg, f, kcfg.inv_bits, digits), 12, L)
    assert want == _ints(pc.final_exp(kcfg, f, digit_bits=digits), 12, L)  # the wrapper's CPU path
    gammas = _ints(kcfg.gammas.to(torch.int64), 36, L)[0]
    for G, _ in _shapes(kcfg, "final_exp_bn"):
        progs = dict(zip(fp.BN_PROGRAMS, pc.fexp_programs(kcfg, "final_exp_bn", G)[0]))
        got = fp.emulate(progs, fp.fexp_bn_steps(digits), vals, fp.F, fp.F, p, L,
                         kcfg.inv_bits, gammas)
        assert got == want, G
    with pytest.raises(ValueError):
        fp.fexp_bn_steps(digits + digits[:1])  # no gamma_4
    with pytest.raises(ValueError):  # each chain starts at f1, its digit's leading one
        pc.final_exp(kcfg, f, digit_bits=[np.array([0, 1], np.uint8)])
