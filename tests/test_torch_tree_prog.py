"""The product tree of the split tree kernel (``ops/kernels/tree_prog.py``,
``csrc/fexp_split_kernels.cu f12_tree_split_kernel``) on the CPU.

* The kernel's launches, emulated on Python integers (the f12 product
  program on every lane of a block, the PAIR rows between levels, zero pad
  lanes in a partial block, the launches of ``tree_plan``), against
  ``f12_seg_product_plain`` on BLS12-381, BN254 and BLS12-377: seg 2, 8 and
  the whole batch, on 1, 2, 16 and 64 lanes, with the f12-one lanes that
  ``tree_width`` pads a check with.  Through the plain version
  the tree is the reference's product (``tests/test_torch_pairing.py``).
  Tolerance: exact (every limb).
* The program against its graph on random relaxed slots; no worker touches
  a slot another writes in the same phase; its slots, products and layers;
  the script's rows; the launcher's (G, K, levels a launch).

The kernel itself runs on the card: ``tests/test_torch_cuda.py``.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.ops.kernels import miller_prog as mp
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.kernels import tree_prog as tp
from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

torch.set_num_threads(1)

CURVES = ["BLS12_381", "BN254", "BLS12_377"]


def _cfg(curve):
    return BatchEngine(get_spec(curve), "cpu").pair.cfg


def _lanes_in(cfg, seed, B, ones=0):
    """B lanes of f12 values, random relaxed [0, 2p) but the last ``ones``,
    which are the f12 one (a check's pad lanes): the (2, 3, 2, L, B) tensor
    and the same as [lane][12] integers."""
    p, L = cfg.fp.p, cfg.fp.L
    rng = np.random.default_rng(seed)
    one = [cfg.fp.R % p] + [0] * 11
    vals = [[int.from_bytes(rng.bytes(64), "big") % (2 * p) for _ in range(12)]
            for _ in range(B - ones)] + [list(one) for _ in range(ones)]
    limbs = np.array([[[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in lane]
                      for lane in vals]).reshape(B, 12, L)
    return torch.from_numpy(limbs.transpose(1, 2, 0).reshape(2, 3, 2, L, B).astype(np.int32)), vals


def _ints(t, L):
    """(2, 3, 2, L, B) limbs -> [lane][12] integers."""
    a = t.reshape(12, L, -1).to(torch.int64).numpy().astype(object)
    return (a * np.array([1 << (16 * k) for k in range(L)], dtype=object)[:, None]
            ).sum(axis=1).T.tolist()


def _emulated(cfg, vals, seg):
    """``f12_seg_product``'s launches on the card, on Python integers."""
    G, _, plan = pc.tree_plan(cfg, seg)
    progs = pc.tree_programs(cfg, G)[0]
    for levels in plan:
        vals = tp.emulate(progs, tp.tree_steps(levels), vals, G, levels, cfg.fp.p, cfg.fp.L)
    return vals


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("B, seg, ones", [(1, 1, 0), (2, 2, 0), (2, 2, 1), (16, 2, 0),
                                          (16, 8, 3), (16, 16, 3), (64, 64, 5)])
def test_emulated_tree_equals_the_plain_version(curve, B, seg, ones):
    """B lanes, the last ``ones`` the f12 one; 64 lanes take two launches."""
    cfg = _cfg(curve)
    f, vals = _lanes_in(cfg, B + seg + ones, B, ones)
    want = _ints(pc.f12_seg_product_plain(cfg, f, seg), cfg.fp.L)
    assert _emulated(cfg, vals, seg) == want


@pytest.mark.parametrize("curve", CURVES)
def test_program_keeps_every_value_and_fits(curve):
    """Random relaxed A and B through the program, against its graph; one
    layer of the f12 product's 54 field products; no race; the slots fit
    a block."""
    cfg = _cfg(curve)
    tw, p, L = cfg.tower, cfg.fp.p, cfg.fp.L
    R = 1 << (16 * L)
    npf = (-pow(p, -1, R)) % R
    g, outs, _ = tp.trace_mul(tw.n, tw.xi0)
    (prog,), slots, words = pc.tree_programs(cfg, pc.TREE_GROUP)
    assert prog.products == mults_per_step(tw.n, tw.twist)["f12_mul"] == 54
    assert prog.layers == [54]
    mp.check_races(prog)
    assert words >= L // 2 * pc.TREE_GROUP and slots == prog.nslots <= 256
    assert slots * words * 4 <= pc.MILLER_SMEM
    S = [random.Random(7).randrange(2 * p) for _ in range(prog.nslots)]
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
    mp.emulate(prog, S, p, R, npf)
    assert {s: S[s] for s in outs} == {s: val[v] for s, v in outs.items()}


def test_launcher_plans_the_levels():
    """8-lane blocks of 64 workers, at most 4 levels a launch: check (a)'s
    4,096-lane tree in 3 launches, the grouped checks' seg 2 in one, 64
    lanes in 4 + 2, one lane in none."""
    for curve in CURVES:
        cfg = _cfg(curve)
        assert pc.tree_shape(cfg) == (8, 64)
        assert pc.tree_plan(cfg, 4096) == (8, 64, [4, 4, 4])
        assert pc.tree_plan(cfg, 2) == (8, 64, [1])
        assert pc.tree_plan(cfg, 64) == (8, 64, [4, 2])
        assert pc.tree_plan(cfg, 1) == (8, 64, [])
    assert tp.max_levels(8) == 4


def test_script_rows_run_the_packed_program():
    cfg = _cfg("BLS12_381")
    G, K = pc.tree_shape(cfg)
    code, script, meta = pc._tree_launch_args(cfg, "cpu", G, K, 3)
    (prog,), slots, words = pc.tree_programs(cfg, G)
    assert list(meta) == [G, K, slots, words]
    _, ranges = mp.pack((prog,), K)
    assert ranges == [0, len(prog.phases)]
    run = [tp.RUN, *ranges]
    assert script.tolist() == [run, [tp.PAIR, tp.A, tp.A], run, [tp.PAIR, tp.A, tp.A], run]
