"""The one-launch pairing check's plan and scripts (``ops/kernels/check_prog.py``,
``csrc/check_kernels.cu pairing_check_kernel``) on the CPU.

* ``check_prog.emulate`` runs a launch's two scripts on Python integers,
  block by block (each lane's Miller programs, the mask, the block's tree
  levels, the ticket, the last block's rounds of partials, the final exp's
  script on the product and the unity test), against
  ``pairing_check_plain`` on BLS12-381: B = 1, 2, 3, 5 and 9 lanes with
  nvalid < B among them, in blocks of 2 lanes (several blocks and rounds
  from a few lanes) and of 4.  The loop is cut to its first bits and x to a
  short exponent (the plain Miller loop and final exp take seconds each at
  full length; the programs do not depend on either, and the card tests run
  the full check).  The pairs (P, G), (-P, G) still reduce to one, and so
  does nvalid = 0 (every lane one): those give True.  The unreduced
  product, the reduced value (``final_exp_plain`` of it) and the verdict
  are compared exactly; the plain checks run once for both block sizes.
* The plan at the card's shapes (4,096 lanes: 128 blocks of 32, two chunks
  of 64 partials through 6 levels, then one level), the launcher's block
  (``check_shape``) and the packed code and scripts
  (``_check_launch_args``).

The kernel itself runs on the card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import check_prog as cp
from mathlib_tpu_torch.ops.kernels import fexp_prog as fp
from mathlib_tpu_torch.ops.kernels import miller_prog as mp
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc

torch.set_num_threads(1)

LOOP_PREFIX = 2  # loop bits of the plain comparison: 1, 0 (an addition step)
SHORT_X = -0b1101  # the x-chains' exponent of the plain comparison (x < 0: conjugations)
# (B, nvalid, verdict): lanes 0 and 1 hold (P, G) and (-P, G)
CASES = [(1, 1, False), (2, 1, False), (3, 2, True), (5, 0, True), (9, 7, False)]


def _ints(t, q, L):
    """(q, L, B) limbs -> [lane][q] integers."""
    a = t.reshape(q, L, -1).to(torch.int64).numpy().astype(object)
    return (a * np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
            ).sum(axis=1).T.tolist()


@pytest.fixture(scope="module")
def short_check():
    """BLS12-381's check config with the loop and x cut short, nine pairs
    (P, G), (-P, G) and seven random ones, as tensors and as Python ints."""
    spec = get_spec("BLS12_381")
    eng, be = get_engine(spec), BatchEngine(spec, "cpu")
    cfg = be.pair.cfg
    assert cfg.bits[:LOOP_PREFIX].any() and cfg.tail is None
    tc = dataclasses.replace(cfg.tc, x=SHORT_X, _dev={})
    short = pc.MillerCfg(tc, cfg.bits[:LOOP_PREFIX], cfg.conj_end, None)
    rng = np.random.default_rng(17)
    ks = [int(k) for k in rng.integers(1, 1 << 62, 14)]
    P = eng.g1.mul(eng.gen_g1, 99)
    g1s = [P, eng.g1.neg(P)] + [eng.g1.mul(eng.gen_g1, k) for k in ks[:7]]
    g2s = [eng.gen_g2] * 2 + [eng.g2.mul(eng.gen_g2, k) for k in ks[7:]]
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    L = be.fp.L
    lanes = [(x[0], y[0], tuple(qx), tuple(qy)) for x, y, qx, qy in
             zip(_ints(xP, 1, L), _ints(yP, 1, L), _ints(Qx, 2, L), _ints(Qy, 2, L))]
    oks, prods = zip(*(pc.pairing_check_plain(short, *(t[..., :B].contiguous()
                                                        for t in (xP, yP, Qx, Qy)), n)
                       for B, n, _ in CASES))
    prods = torch.cat(prods, dim=-1)
    tc = short.tc
    reds = pc.final_exp_plain(tc, prods, tc.inv_bits, tc.x_bits, tc.x < 0)
    want = list(zip(_ints(prods, 12, L), _ints(reds, 12, L), [bool(ok) for ok in oks]))
    return short, lanes, want


@pytest.mark.parametrize("G", [2, 4])
def test_emulated_check_equals_the_plain_version(short_check, G):
    short, lanes, want = short_check
    tc, p, L = short.tc, short.fp.p, short.fp.L
    progs, _, _, fprogs, _, _ = pc.check_programs(short, 8)
    progs1, progs2 = dict(zip(cp.PART1_PROGRAMS, progs)), dict(zip(fp.FEXP_PROGRAMS, fprogs))
    steps2 = fp.fexp_steps(tc.x_bits, tc.x < 0)
    gammas = _ints(tc.gammas.to(torch.int64), 36, L)[0]
    got = []
    for B, n, _ in CASES:
        steps1 = cp.check_steps(cp.plan(B, n, G), short.bits, progs[2] is not None)
        got.append(cp.emulate(progs1, steps1, progs2, steps2, lanes[:B], n, G, p, L,
                              tc.inv_bits, gammas))
    assert [tuple(g) for g in got] == want
    assert [ok for _, _, ok in want] == [ok for _, _, ok in CASES]


def test_plan_gives_each_block_its_levels_and_the_last_block_its_rounds():
    """Blocks of 2 lanes: the tree's width, the blocks, each block's levels
    and Miller loops, the rounds; and the card's 4,096 lanes in blocks of
    32 (two chunks of 64 partials through 6 levels, then one level) and of
    16 (BLS12-377)."""
    assert cp.plan(1, 1, 2) == cp.Plan(1, 1, 0, (True,), ())
    assert cp.plan(2, 1, 2) == cp.Plan(2, 1, 1, (True,), ())
    assert cp.plan(3, 2, 2) == cp.Plan(4, 2, 1, (True, False), ((2, 2, 1),))
    assert cp.plan(5, 0, 2) == cp.Plan(8, 4, 1, (False,) * 4, ((4, 4, 2),))
    assert cp.plan(9, 7, 2) == cp.Plan(16, 8, 1, (True,) * 4 + (False,) * 4,
                                       ((8, 4, 2), (2, 2, 1)))
    assert cp.plan(9, 9, 4) == cp.Plan(16, 4, 2, (True,) * 3 + (False,), ((4, 4, 2),))
    big = cp.plan(4096, 4096, 32)
    assert (big.width, big.blocks, big.block_levels, big.rounds) == (
        4096, 128, 5, ((128, 64, 6), (2, 2, 1)))
    assert cp.plan(4096, 4096, 16).rounds == ((256, 32, 5), (8, 8, 3))
    assert cp.plan(2, 2, 8) == cp.Plan(2, 1, 1, (True,), ())
    assert cp.plan(257, 257, 8).rounds == ((64, 16, 4), (4, 4, 2))
    steps = cp.check_steps(cp.plan(9, 7, 2), [0, 1], False)
    assert steps == [
        (cp.SKIP, 2, 0), (cp.RUN, "dbl"), (cp.RUN, "dbladd"), (cp.MASK, 0, 0),
        (cp.PAIR, cp.A, cp.A), (cp.RUN, "mul"), (cp.PUBLISH, 0, 0),
        (cp.LOAD, 0, 4), (cp.RUN, "mul"), (cp.PAIR, cp.A, cp.A), (cp.RUN, "mul"), (cp.STORE, 0, 0),
        (cp.LOAD, 4, 4), (cp.RUN, "mul"), (cp.PAIR, cp.A, cp.A), (cp.RUN, "mul"), (cp.STORE, 1, 0),
        (cp.LOAD, 0, 2), (cp.RUN, "mul"), (cp.PROD, 0, 0)]
    with pytest.raises(ValueError):
        cp.plan(4, 4, 3)


def test_launcher_packs_the_programs_and_scripts():
    """The block of 4,096 lanes (32 x 32 at BLS12-381, 16 x 48 at
    BLS12-377), of 2 and 257 lanes (8 x 64); the code array holds part 1's
    programs, part 2's, then both scripts, at the meta's offsets; the slots
    fit a block."""
    for curve, big in (("BLS12_381", (32, 32)), ("BLS12_377", (16, 48))):
        cfg = BatchEngine(get_spec(curve), "cpu").pair.cfg
        assert pc.check_shape(cfg, 4096) == big
        assert pc.check_shape(cfg, 2) == pc.check_shape(cfg, 257) == (8, 64)
    code, meta, blocks = pc._check_launch_args(cfg, "cpu", 4096)
    G, K, slots, words, K2, slots2, words2, prog2, at1, rows1, at2, rows2 = list(meta)
    assert (G, K, K2, blocks) == (16, 48, cp.FEXP_WORKERS, 256)
    progs, s1, w1, fprogs, s2, w2 = pc.check_programs(cfg, G)
    assert (slots, words, slots2, words2) == (s1, w1, s2, w2)
    assert 4 * max(s1 * w1, s2 * w2) <= pc.MILLER_SMEM and s1 >= mp.N_STATE
    code1, r1 = mp.pack(progs, K)
    code2, r2 = mp.pack(fprogs, K2)
    code = code.numpy()
    assert prog2 == len(code1) and at1 == len(code1) + len(code2) and at2 == at1 + 3 * rows1
    assert np.array_equal(code[:prog2], code1) and np.array_equal(code[prog2:at1], code2)
    script1 = code[at1:at2].reshape(rows1, 3)
    steps1 = cp.check_steps(cp.plan(4096, 4096, G), cfg.bits, progs[2] is not None)
    assert np.array_equal(script1, fp.encode_steps(steps1, cp.PART1_PROGRAMS, r1))
    assert script1[0].tolist() == [cp.SKIP, len(cfg.bits), 0] and len(code) == at2 + 3 * rows2
    tc = cfg.tc
    assert np.array_equal(code[at2:].reshape(rows2, 3), fp.encode_steps(
        fp.fexp_steps(tc.x_bits, tc.x < 0), fp.FEXP_PROGRAMS, r2))
