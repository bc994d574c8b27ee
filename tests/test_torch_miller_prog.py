"""The programs of the split Miller kernels (``ops/kernels/miller_prog.py``,
``csrc/miller_split_kernels.cu``) on the CPU.

* Each program, emulated on Python integers, against a plain evaluation of
  its graph on random relaxed [0, 2p) slots: scheduling and slot reuse keep
  every value.
* The kernels' whole run, emulated (state into slots, one program a loop
  bit, the tail program), against ``miller_lanes_plain`` and
  ``miller_ft_plain`` -- and through them against the reference kernel
  bodies (``tests/test_torch_pairing.py``, ``test_torch_final_exp.py``) -- on
  BLS12-381, BN254 and BLS12-377, at each block the launcher can pick for
  the curve, over a prefix of the loop bits; the ``add_step`` kernel's run
  (f, T, P, Q into their slots, the "add" program, f and T out) against
  ``add_step_plain`` on random relaxed inputs the same way.  Tolerance:
  exact (every limb).
* No worker touches a slot another worker writes in the same phase; the
  workers of a warp have their products at the same instruction index;
  ``pack`` lays out what ``miller_split_kernels.cu`` reads; the launcher's
  choice of block from the lane count and the curve's slot count.

The kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import miller_prog as mp
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

torch.set_num_threads(1)

CURVES = ["BLS12_381", "BN254", "BLS12_377"]
LOOP_PREFIX = 6  # loop bits of the plain comparison (each curve's holds an addition step)


def _cfg(curve):
    return BatchEngine(get_spec(curve), "cpu").pair.cfg


def _shapes(cfg):
    """The (G, K) blocks the launcher picks for the curve at 4,096, 2,048
    and 1,024 lanes, largest first."""
    return sorted({pc.miller_shape(cfg, n) for n in (4096, 2048, 1024)}, reverse=True)


def _flags(cfg):
    tw = cfg.tower
    return tw.n, tw.xi0, tw.twist == "M", bool(cfg.conj_end), cfg.tail is not None


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
    cfg = _cfg("BLS12_381")
    shape = lambda lanes: pc.miller_shape(cfg, lanes)  # noqa: E731
    assert shape(4096) == shape(1 << 20) == (32, pc.MILLER_WORKERS[32])
    assert shape(4064) == shape(2048) == (16, pc.MILLER_WORKERS[16])
    assert shape(2032) == shape(1024) == shape(1) == (8, pc.MILLER_WORKERS[8])
    for lanes in (1024, 2048, 4096):
        assert -(-lanes // shape(lanes)[0]) >= pc.MILLER_BLOCKS


def test_launcher_takes_a_smaller_block_when_the_programs_do_not_fit():
    """BLS12-377's programs need more slots of 32 lanes than a block's
    shared memory holds: its 4,096-lane calls run in blocks of 16."""
    cfg = _cfg("BLS12_377")
    _, slots, words = pc.miller_programs(cfg, 32)
    assert slots * words * 4 > pc.MILLER_SMEM
    assert pc.miller_shape(cfg, 4096) == pc.miller_shape(cfg, 2048) == (16, pc.MILLER_WORKERS[16])
    assert pc.miller_shape(cfg, 1024) == (8, pc.MILLER_WORKERS[8])


@pytest.mark.parametrize("curve", CURVES)
def test_programs_fit_shared_memory_and_keep_to_their_slots(curve):
    cfg = _cfg(curve)
    m = mults_per_step(cfg.tower.n, cfg.tower.twist)
    dbl = m["dbl_step"] + m["f12_sqr"] + m["f12_sparse_mul"]
    for G, K in _shapes(cfg):
        progs, slots, words = pc.miller_programs(cfg, G)
        assert slots * words * 4 <= pc.MILLER_SMEM and words >= cfg.fp.L // 2 * G
        assert progs[0].products == sum(progs[0].layers) == dbl  # the bound's count
        assert progs[1].products == dbl + m["add_step"] + m["f12_sparse_mul"]
        (add,), add_slots, _ = pc.add_programs(cfg, G)
        assert add.products == m["add_step"] + m["f12_sparse_mul"]
        assert add_slots * words * 4 <= pc.MILLER_SMEM
        mp.check_races(add)
        assert all(s is None or s < add_slots
                   for ph in add.phases for code_w in ph for word in code_w
                   for s in mp.fields(word)[1:])
        code, ranges = mp.pack(progs, K)
        assert code.dtype == np.int32 and len(ranges) == 6
        words32 = code.view(np.uint32)
        for prog, (begin, end) in zip(progs, zip(ranges[0::2], ranges[1::2])):
            phases = prog.phases if prog is not None else []
            assert end - begin == len(phases)
            for p, ph in enumerate(phases):
                offs = words32[(begin + p) * (K + 1) : (begin + p + 1) * (K + 1)]
                assert [list(words32[offs[w] : offs[w + 1]]) for w in range(K)] == ph
                for code_w in ph:
                    for word in code_w:
                        assert all(s is None or s < slots for s in mp.fields(word)[1:])
            if prog is not None:
                mp.check_races(prog)


@pytest.mark.parametrize("curve", CURVES)
def test_each_program_keeps_every_value(curve):
    """Random relaxed slots through each program against its graph."""
    cfg = _cfg(curve)
    p, L = cfg.fp.p, cfg.fp.L
    R = 1 << (16 * L)
    rnd = random.Random(5)
    for G, K in _shapes(cfg):
        for kind in ("dbl", "dbladd", "tail", "add"):
            g, outs = mp.trace(kind, *_flags(cfg))
            prog = mp.schedule(g, outs, K)
            S = [rnd.randrange(2 * p) for _ in range(prog.nslots)]
            want = _graph_eval(g, S, p, R)
            mp.emulate(prog, S, p, R, (-pow(p, -1, R)) % R)
            assert {s: S[s] for s in outs} == {s: want[v] for s, v in outs.items()}


@pytest.mark.parametrize("curve", CURVES)
def test_warp_partners_multiply_at_the_same_index(curve):
    cfg = _cfg(curve)
    for G, K in _shapes(cfg):
        if G == 32:
            continue
        progs, _, _ = pc.miller_programs(cfg, G)
        for prog in progs:
            for ph in prog.phases if prog is not None else []:
                for w0 in range(0, K, 32 // G):
                    at = [{i for i, w in enumerate(c) if w & 15 == mp.MUL}
                          for c in ph[w0 : w0 + 32 // G]]
                    for a in at:
                        for b in at:
                            assert sorted(a)[: len(b)] == sorted(b)[: len(a)]


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_run_equals_the_plain_versions(curve):
    spec = get_spec(curve)
    eng = get_engine(spec)
    be = BatchEngine(spec, "cpu")
    cfg = be.pair.cfg
    assert cfg.bits[:LOOP_PREFIX].any()
    short = pc.MillerCfg(cfg.tc, cfg.bits[:LOOP_PREFIX], cfg.conj_end, cfg.tail)
    rng = np.random.default_rng(11)
    ks = [int(k) for k in rng.integers(1, 1 << 62, 4)]
    g1s = [eng.g1.mul(eng.gen_g1, k) for k in ks[:2]]
    g2s = [eng.g2.mul(eng.gen_g2, k) for k in ks[2:]]
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    L, p = be.fp.L, spec.p

    def ints(t, q):  # (q, L, B) limbs -> [lane][q] integers
        a = t.reshape(q, L, -1).to(torch.int64).numpy().astype(object)
        return (a * np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
                ).sum(axis=1).T.tolist()

    lanes = [(x[0], y[0], tuple(qx), tuple(qy))
             for x, y, qx, qy in zip(ints(xP, 1), ints(yP, 1), ints(Qx, 2), ints(Qy, 2))]
    tail = None if cfg.tail is None else [v for v in ints(cfg.tail_limbs("cpu"), 8)[0]]
    want_f = ints(pc.miller_lanes_plain(short, xP, yP, Qx, Qy, 2), 12)
    f, T = pc.miller_ft_plain(short, xP, yP, Qx, Qy)
    want_ft = [a + b for a, b in zip(ints(f, 12), ints(T, 6))]
    for G, _ in _shapes(cfg):
        progs = pc.miller_programs(cfg, G)[0]
        assert mp.emulate_loop(progs, lanes, short.bits, p, L, tail) == want_f
        assert mp.emulate_loop(progs, lanes, short.bits, p, L, tail, lanes_out=False) == want_ft


@pytest.mark.parametrize("curve", CURVES)
def test_add_step_run_equals_the_plain_version(curve):
    """The ``add_step`` kernel's run on 2 lanes of random relaxed [0, 2p)
    f, T, P and Q, at every block the launcher can pick, against
    ``add_step_plain``: the state into the loop's slots, the "add"
    program, then f (slots 0-11) and T (12-17) out."""
    cfg = _cfg(curve)
    p, L = cfg.fp.p, cfg.fp.L
    R = 1 << (16 * L)
    rng = np.random.default_rng(17)
    vals = [[int.from_bytes(rng.bytes(64), "big") % (2 * p) for _ in range(2)]
            for _ in range(mp.ADD_STATE)]  # [slot][lane]
    limbs = np.array([[[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in row] for row in vals],
                     dtype=np.int32).transpose(0, 2, 1)  # (slot, L, lane)
    t = torch.from_numpy(np.ascontiguousarray(limbs))
    f, T = t[:12].reshape(2, 3, 2, L, 2), t[12:18].reshape(3, 2, L, 2)
    xP, yP, Qx, Qy = t[18], t[19], t[20:22], t[22:24]
    f2, T2 = pc.add_step_plain(cfg, f, T, Qx, Qy, xP, yP)
    weights = np.array([1 << (16 * k) for k in range(L)], dtype=object)
    out = torch.cat([f2.reshape(12, L, 2), T2.reshape(6, L, 2)]).to(torch.int64).numpy()
    want = [list(out[..., i].astype(object) @ weights) for i in range(2)]
    for G, K in sorted({pc.add_shape(cfg, n) for n in (4096, 2048, 1024)}):
        prog = pc.add_programs(cfg, G)[0][0]
        for i in range(2):
            S = [0] * prog.nslots
            S[: mp.ADD_STATE] = [row[i] for row in vals]
            mp.emulate(prog, S, p, R, (-pow(p, -1, R)) % R)
            assert S[:18] == want[i], (G, i)
