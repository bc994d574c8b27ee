"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path -- the BLS12-381 G1 multi-scalar multiplication
at 2^20 points (c=16 window bits, K=64 scan steps, unsigned digits, dense
capture, host Horner), as ``bench.py`` times it for the JAX package -- through
``mathlib_tpu_torch`` alone, in phases:

  1. device: needs a CUDA card (exit 1 otherwise); prints its name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compiles the CUDA kernels from ``mathlib_tpu_torch/csrc`` with
     nvcc (ptxas register and spill report in the build log);
  3. each kernel (add, double, addsel, smul) against its plain PyTorch
     version on the card, bit for bit (tolerance: exact), and each one's
     time beside the plain version's at the main path's shapes;
  4. the n=512 gates of ``bench.py``: msm_totals + horner_host and the split
     path must equal the port's msm_naive and the host engine's MSM;
  5. the main path at 2^20 points: 8,192 base points by the port's
     scalar_mul (checked against the host engine), tiled to 2^20, scalars
     from ``np.random.default_rng(0)`` reduced mod r; one warm-up and 3
     timed runs; the result must equal a host MSM of the scalars folded per
     base point; every kernel must have launched during this phase.

The second main path, the pairing-product check a BLS verifier pays for
(``BatchEngine.pairing_product_is_one`` / ``pairing_products_are_one``):

  6. the pairing kernels (mont_mul, miller_lanes, f12_seg_product) against
     their plain PyTorch versions on the card, exact: miller_lanes on 64
     lanes with n = 61 (3 pad lanes) on BLS12-381, BN254 and BLS12-377,
     f12_seg_product with seg in {2, 64}; then each at the shapes of phase 7
     (BLS12-381, 4,096 and 2,048 lanes), checked against the plain version
     and timed beside it;
  7. the product check at full width on BLS12-381 through ``BatchEngine``
     on the card: (a) 4,096 pairs (a_i g1, b_i g2) beside (-a_i b_i g1, g2)
     must check True and their twin with one scalar changed False; (b) 1,024
     two-pair BLS verifies e(sig, g2) e(-H, pk), a known half corrupted, must
     give the known verdicts; (c) 8 per-lane Miller values, reduced on the
     host, must equal the host engine's pairings.  One warm-up and 3 timed
     runs of (a) and (b); every pairing kernel must have launched.

Inputs come from ``np.random.default_rng(0)``, the points from the port's
C++ host engine (built with g++ at first use).  Prints the card's name and
power limit, one JSON line of per-kernel results (time, plain time, bound,
launches on its main path), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code != 0) before that line.  Imports no JAX and
nothing of the JAX package.

    python3 chip_smoke.py --profile

adds, after phase 5, one MSM under ``torch.profiler`` (device time by kernel
and by operator, and the device's busy share of the profiled wall time) and
the ``add`` kernel's time at 2^20 lanes on BLS12-381 (12 words) beside BN254
(8 words); and after phase 7, one 4,096-pair check under the profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 1 << 20
N_BASE = 8192
N_GATE = 512
C, K = 16, 64
N_CHECK = 4097  # lanes of the kernel-vs-plain check (a ragged edge)
N_SMUL = 256  # lanes of the smul check
PLAIN_CHUNK = 1 << 16  # lanes per plain-version call when timing big shapes

N_PAIRS = 4096  # phase 7 (a): pairs in one product check
N_CHECKS = 1024  # phase 7 (b): two-pair checks in one grouped call
N_LANES_CHECK, N_VALID_CHECK = 64, 61  # phase 6: lanes, real lanes (3 pad)
PLAIN_PAIR_CHUNK = 1024  # lanes per plain-version call of the pairing kernels

G1_SRC = "mathlib_tpu_torch/csrc/g1_kernels.cu"
KERNEL_INFO = {  # name: (source, the TPU kernel it replaces)
    "add": (G1_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:174"),
    "double": (G1_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:182"),
    "addsel": (G1_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:210"),
    "smul": (G1_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:476"),
    "mont_mul": ("mathlib_tpu_torch/csrc/fp_kernels.cu", "mathlib_tpu/ops/kernels/fp_pallas.py:40"),
    "miller_lanes": ("mathlib_tpu_torch/csrc/pairing_kernels.cu",
                     "mathlib_tpu/ops/kernels/pairing_pallas.py:1188"),
    "f12_seg_product": ("mathlib_tpu_torch/csrc/pairing_kernels.cu",
                        "mathlib_tpu/ops/kernels/pairing_pallas.py:1244"),
}

# The card's peaks for the bound (NVIDIA H100 SXM data sheet): HBM at
# 3.35 TB/s, and 32-bit integer multiply-adds on 64 INT32 lanes per SM
# (half the 128 float32 lanes behind the sheet's 67 TFLOP/s) at the
# 1.98 GHz boost clock on 132 SMs.  A 32x32->64 product counts as two of
# them (its low and high words), a 32-bit low product as one.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, mads: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the int32 multiply-adds over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, mads / INT32_MADS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def wide_mads(fp_muls: int, L: int) -> int:
    """int32 multiply-adds of fp_muls CIOS Montgomery products at L 16-bit
    limbs (``fp_mul`` in csrc/fp_rows.cuh, NW = L/2 words): per word of b,
    NW 32x32->64 products for a*b[i] and NW for m*p, two multiply-adds
    each, and one low product for m = t[0]*np0: 4 NW^2 + NW."""
    nw = L // 2
    return fp_muls * (4 * nw * nw + nw)


def miller_fp_muls(cfg, lanes: int) -> int:
    """Base-field Montgomery products ``miller_lanes`` runs for ``lanes``
    real lanes (pad lanes run none), counted from the steps it takes."""
    import numpy as np
    from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

    c = mults_per_step(cfg.tower.n, cfg.tower.twist)
    nbits, nadd = len(cfg.bits), int(np.count_nonzero(cfg.bits))
    per = nbits * (c["dbl_step"] + c["f12_sqr"] + c["f12_sparse_mul"])
    per += nadd * (c["add_step"] + c["f12_sparse_mul"])
    if cfg.tail is not None:  # BN: Frobenius of Q (4 Fp2 products), 2 chord steps
        per += 4 * 3 + 2 * (c["add_step"] + c["f12_sparse_mul"])
    return lanes * per


def seg_product_fp_muls(cfg, lanes: int, seg: int) -> int:
    """Base-field Montgomery products of ``f12_seg_product`` on ``lanes``:
    one f12 product per lane that is not the head of its segment."""
    from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

    return (lanes - lanes // seg) * mults_per_step(cfg.tower.n, cfg.tower.twist)["f12_mul"]


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """Mean device milliseconds of fn() over reps runs, after one warm-up,
    and the output of the last run.  A spin of about 50 ms on the stream
    goes first, so the host queues the runs behind it and the events time
    the device's work, not the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def chunked(fn, lanes: int, *args, step: int = PLAIN_CHUNK):
    """fn on step-lane slices of its (..., lanes) arguments, joined."""
    import torch

    return torch.cat(
        [fn(*[a[..., lo : lo + step] for a in args]) for lo in range(0, lanes, step)], dim=-1
    )


def check_equal(results: dict, name: str, got, want):
    """A kernel's output against its plain version's, bit for bit; records
    the largest absolute difference under ``results[name]``."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"kernel {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel {name} disagrees with its plain version ({err=})")
    res = results.setdefault(name, {"max_abs_err": 0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    return got


def profile_run(run) -> None:
    """Device time of one run() by kernel and by operator (torch.profiler).
    A first run under a warm-up step starts the tracer; the second is the
    one recorded (a second profiler in one process otherwise
    missed the activity of its first ~20 ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()

    def dev_us(ev):
        us = getattr(ev, "self_device_time_total", None)
        return ev.self_cuda_time_total if us is None else us

    events = prof.key_averages()
    kernels = sorted(  # the schedule's "ProfilerStep*" span is not a kernel
        (ev for ev in events if str(ev.device_type).endswith("CUDA") and dev_us(ev) > 0
         and not ev.key.startswith("ProfilerStep")),
        key=dev_us, reverse=True,
    )
    ops = sorted(
        (ev for ev in events if ev.key.startswith("aten::") and dev_us(ev) > 0),
        key=dev_us, reverse=True,
    )
    total_ms = sum(dev_us(ev) for ev in kernels) / 1e3
    for ev in kernels[:12]:
        log("profile_kernel", ms=f"{dev_us(ev) / 1e3:.3f}", count=ev.count, name=repr(ev.key[:90]))
    for ev in ops[:8]:
        log("profile_op", ms=f"{dev_us(ev) / 1e3:.3f}", count=ev.count, name=ev.key)
    log("profile", device_ms=f"{total_ms:.3f}", kernel_launches=sum(ev.count for ev in kernels),
        profiled_wall_ms=f"{wall_ms:.1f}", busy_share=f"{total_ms / wall_ms:.3f}")


def add_ms_by_curve(dev, rng) -> None:
    """The add kernel at 2^20 lanes on BLS12-381 (L=24) and BN254 (L=16):
    tiled random multiples of the generator, checked against the plain
    version on PLAIN_CHUNK lanes."""
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import g1_cuda

    for curve in ("BLS12_381", "BN254"):
        spec = get_spec(curve)
        eng, g = get_engine(spec), G1Ctx(spec, dev)
        pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 64)]
        P = g.encode_points(pool).repeat(1, 1, N_MAIN // 64).contiguous()
        Q = torch.roll(P, 1, dims=-1).contiguous()
        ms, out = cuda_ms(lambda: g1_cuda.add(g.F, P, Q), reps=5)
        sl = slice(0, PLAIN_CHUNK)
        if not torch.equal(out[..., sl], g1_cuda.add_plain(g.F, P[..., sl], Q[..., sl])):
            raise AssertionError(f"add kernel disagrees with its plain version on {curve}")
        log("profile_add", curve=curve, L=g.fp.L, lanes=N_MAIN, ms=f"{ms:.4f}")


def pairing_phases(dev, smi: str, results: dict, profile: bool) -> dict:
    """Phases 6 and 7; fills ``results`` for the pairing kernels and returns
    their launch counts over phase 7's main-path runs."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.kernels import fp_cuda, g1_cuda, pairing_cuda as pc

    rng = np.random.default_rng(0)

    def scalars(spec, count):
        return [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(count)]

    def random_pairs(eng, spec, count):
        g1s = [eng.g1.mul(eng.gen_g1, k) for k in scalars(spec, count)]
        return g1s, [eng.g2.mul(eng.gen_g2, k) for k in scalars(spec, count)]

    def check(name, got, want):
        check_equal(results, name, got, want)

    # ---- 6. the pairing kernels against their plain versions (exact)
    for curve in ("BLS12_381", "BN254", "BLS12_377"):
        spec = get_spec(curve)
        eng, be = get_engine(spec), BatchEngine(spec, dev)
        cfg = be.pair.cfg
        packed = be._encode_pairs(*random_pairs(eng, spec, N_LANES_CHECK))
        t = torch.from_numpy(packed.astype(np.int32)).to(dev)
        r2 = be.fp.r2_limbs.to(torch.int32)
        check("mont_mul", fp_cuda.mont_mul(be.fp, t, r2), fp_cuda.mont_mul_plain(be.fp, t, r2))
        xP, yP, Qx, Qy = be._pair_split_mont(packed)
        f = pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_VALID_CHECK)
        check("miller_lanes", f, pc.miller_lanes_plain(cfg, xP, yP, Qx, Qy, N_VALID_CHECK))
        if not (f[..., N_VALID_CHECK:] == be.pair.cfg.tower.f12_one_like(1, dev)).all():
            raise AssertionError(f"pad lanes of miller_lanes are not one on {curve}")
        for seg in (2, N_LANES_CHECK):
            check("f12_seg_product", pc.f12_seg_product(cfg, f, seg),
                  pc.f12_seg_product_plain(cfg, f, seg))
        log("pair_kernels_vs_plain", curve=curve, L=be.fp.L, lanes=N_LANES_CHECK,
            n=N_VALID_CHECK, segs=[2, N_LANES_CHECK], equal=True)

    # the same kernels at phase 7's shapes (BLS12-381), timed beside their
    # plain versions (run in PLAIN_PAIR_CHUNK-lane slices)
    spec = get_spec("BLS12_381")
    eng, be = get_engine(spec), BatchEngine(spec, dev)
    cfg, L = be.pair.cfg, be.fp.L
    g1s, g2s = random_pairs(eng, spec, N_PAIRS)
    packed = be._encode_pairs(g1s, g2s)
    t = torch.from_numpy(packed.astype(np.int32)).to(dev)
    r2 = be.fp.r2_limbs.to(torch.int32)
    xP, yP, Qx, Qy = be._pair_split_mont(packed)
    f = pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_PAIRS)
    f_b = f[..., : 2 * N_CHECKS].contiguous()
    limb_bytes = L * 4
    shapes = {  # name: (what, kernel, plain, bytes, field products)
        "mont_mul": (
            f"(6, {L}, {N_PAIRS})",
            lambda: fp_cuda.mont_mul(be.fp, t, r2),
            lambda: fp_cuda.mont_mul_plain(be.fp, t, r2),
            2 * 6 * limb_bytes * N_PAIRS, 6 * N_PAIRS),
        "miller_lanes": (
            f"{N_PAIRS} lanes",
            lambda: pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_PAIRS),
            lambda: chunked(lambda a, b, c, d: pc.miller_lanes_plain(cfg, a, b, c, d, PLAIN_PAIR_CHUNK),
                            N_PAIRS, xP, yP, Qx, Qy, step=PLAIN_PAIR_CHUNK),
            (6 + 12) * limb_bytes * N_PAIRS, miller_fp_muls(cfg, N_PAIRS)),
        "f12_seg_product": (
            f"{N_PAIRS} lanes, seg {N_PAIRS}",
            lambda: pc.f12_seg_product(cfg, f, N_PAIRS),
            lambda: pc.f12_seg_product_plain(cfg, f, N_PAIRS),
            12 * limb_bytes * (N_PAIRS + 1), seg_product_fp_muls(cfg, N_PAIRS, N_PAIRS)),
        "f12_seg_product_seg2": (
            f"{2 * N_CHECKS} lanes, seg 2",
            lambda: pc.f12_seg_product(cfg, f_b, 2),
            lambda: chunked(lambda a: pc.f12_seg_product_plain(cfg, a, 2), 2 * N_CHECKS, f_b,
                            step=PLAIN_PAIR_CHUNK),
            12 * limb_bytes * 3 * N_CHECKS, seg_product_fp_muls(cfg, 2 * N_CHECKS, 2)),
    }
    for name, (what, kern, plain, nbytes, fp_muls) in shapes.items():
        ms, got = cuda_ms(kern, reps=3)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name.replace("_seg2", ""), got, want)
        del got, want
        b = bound(nbytes, wide_mads(fp_muls, L))
        if name in KERNEL_INFO:
            results[name].update(ms=ms, plain_ms=plain_ms, **b)
        log("time", kernel=name, shape=repr(what), equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
    del f, f_b, t, xP, yP, Qx, Qy

    # ---- 7. the product check at full width through BatchEngine
    # (c) per-lane Miller values, reduced on the host, against the host pairing
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s[:8], g2s[:8]))
    lanes = be.tw.f12_decode(pc.miller_lanes(cfg, xP, yP, Qx, Qy, 8))
    for v, P, Q in zip(lanes, g1s, g2s):
        if eng.final_exp(v) != eng.pairing(P, Q):
            raise AssertionError("a reduced per-lane Miller value differs from the host pairing")
    log("pairing_lanes", lanes=8, equal_host_pairing=True)

    # (a) 2,048 pairs (a g1, b g2), each beside (-ab g1, g2)
    a_s, b_s = scalars(spec, N_PAIRS // 2), scalars(spec, N_PAIRS // 2)
    g1s, g2s = [], []
    for a, b in zip(a_s, b_s):
        g1s += [eng.g1.mul(eng.gen_g1, a), eng.g1.mul(eng.gen_g1, (-a * b) % spec.r)]
        g2s += [eng.g2.mul(eng.gen_g2, b), eng.gen_g2]
    bad_g1s = g1s[:-1] + [eng.g1.mul(eng.gen_g1, (-a_s[-1] * b_s[-1] + 1) % spec.r)]
    # (b) 1,024 BLS verifies e(sig, g2) e(-H, pk), a known half corrupted
    sks, hs = scalars(spec, N_CHECKS), scalars(spec, N_CHECKS)
    bad = set(int(i) for i in rng.permutation(N_CHECKS)[: N_CHECKS // 2])
    v_g1s, v_g2s, verdicts = [], [], []
    for k, (sk, h) in enumerate(zip(sks, hs)):
        H = eng.g1.mul(eng.gen_g1, h)
        sig = eng.g1.mul(H, sk + 1 if k in bad else sk)
        v_g1s += [sig, eng.g1.neg(H)]
        v_g2s += [eng.gen_g2, eng.g2.mul(eng.gen_g2, sk)]
        verdicts.append(k not in bad)

    def run_a():
        return be.pairing_product_is_one(g1s, g2s)

    def run_b():
        return be.pairing_products_are_one(v_g1s, v_g2s, 2)

    if be.pairing_product_is_one(bad_g1s, g2s) is not False:
        raise AssertionError("the check with one scalar changed did not fail")
    for mod in (g1_cuda, fp_cuda, pc):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # tensors of the earlier phases
    walls = {"a": [], "b": []}
    for name, run, want in (("a", run_a, True), ("b", run_b, verdicts)):
        got = run()  # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"phase 7 ({name}): wrong verdict(s)")
    launches = {**fp_cuda.launches(), **pc.launches()}
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"pairing kernels not launched on the pairing path: {missing}")
    log("pairing_check", pairs=N_PAIRS, is_one=True, twin_is_one=False,
        seconds=[round(x, 4) for x in walls["a"]],
        pairings_per_s=f"{N_PAIRS / min(walls['a']):.1f}", card=repr(smi))
    log("pairing_checks_grouped", checks=N_CHECKS, group=2, verdicts_right=N_CHECKS,
        corrupted=len(bad), seconds=[round(x, 4) for x in walls["b"]],
        checks_per_s=f"{N_CHECKS / min(walls['b']):.1f}",
        pairings_per_s=f"{2 * N_CHECKS / min(walls['b']):.1f}")
    log("pairing_peak", peak_mem_GB=f"{peak / 1e9:.3f}", held_before_GB=f"{held / 1e9:.3f}",
        path_peak_GB=f"{(peak - held) / 1e9:.3f}")
    log("pairing_launches", **launches)

    # stages of one more run of each (host clock; device time by CUDA events)
    for name, g1l, g2l, seg in (("a", g1s, g2s, None), ("b", v_g1s, v_g2s, 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = be._encode_pairs(g1l, g2l)
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        split = be._pair_split_mont(packed)
        ev[1].record()
        prod = (be.pair.product_miller(*split) if seg is None
                else be.pair.products_miller(*split, seg))
        ev[2].record()
        prod = prod.cpu()
        t2 = time.perf_counter()
        vals = be.tw.f12_decode(prod)
        t3 = time.perf_counter()
        ok = [eng.gt_is_one(eng.final_exp(v)) for v in vals[:64]]
        t4 = time.perf_counter()
        if seg is None and ok != [True]:
            raise AssertionError("stage run of (a) did not check True")
        log("pairing_stages", run=name, encode_host_s=f"{t1 - t0:.4f}",
            to_mont_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}",
            miller_and_product_device_ms=f"{ev[1].elapsed_time(ev[2]):.4f}",
            device_wall_s=f"{t2 - t1:.4f}", decode_host_s=f"{t3 - t2:.4f}",
            final_exp_host_ms_each=f"{1e3 * (t4 - t3) / len(ok):.3f}")
    if profile:
        profile_run(run_a)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one 2^20 MSM and time add on BLS12-381 vs BN254")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.host import get_engine

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError("mathlib_tpu_torch was not imported from this checkout")
    from mathlib_tpu_torch.ops import msm as M
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g1_cuda, pairing_cuda

    dev = mathlib_tpu_torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log("device", kind=repr(kind), count=count, smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load()  # builds here unless an up-to-date library is already there
    keys = ("Compiling entry", "Function properties", "spill", "registers")
    spills = [ln.strip() for ln in open(build.BUILD_LOG) if any(k in ln for k in keys)]
    log("build", seconds=f"{time.perf_counter() - t0:.1f}", log=build.BUILD_LOG)
    for ln in spills:
        print("  ptxas:", ln)

    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    g1 = G1Ctx(spec, dev)
    F = g1.F
    rng = np.random.default_rng(0)

    def rand_ints(count):
        """count uniform scalars in [0, r), as bench.py draws them."""
        return [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(count)]

    # ---- 3. kernels vs plain versions on the card (exact)
    pool = [eng.g1.mul(eng.gen_g1, k) for k in rand_ints(257)]
    n = N_CHECK
    ia, ib = rng.integers(0, len(pool), n), rng.integers(0, len(pool), n)
    A = [pool[i] for i in ia]
    B = [pool[i] for i in ib]
    for i in range(0, n, 7):
        B[i] = A[i]  # P == Q
    for i in range(3, n, 17):
        B[i] = eng.g1.neg(A[i])  # P == -Q
    for i in range(5, n, 11):
        A[i] = None
    for i in range(6, n, 13):
        B[i] = None
    P, Q = g1.encode_points(A), g1.encode_points(B)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(dev)
    results = {}

    def check(name, got, want):
        return check_equal(results, name, got, want)

    S1 = check("add", g1_cuda.add(F, P, Q), g1_cuda.add_plain(F, P, Q))  # relaxed outputs
    check("double", g1_cuda.double(F, S1), g1_cuda.double_plain(F, S1))
    check("addsel", g1_cuda.addsel(F, S1, Q, sel), g1_cuda.addsel_plain(F, S1, Q, sel))
    ks = rand_ints(N_SMUL)
    ks[:3] = [0, 1, spec.r - 1]
    Ks = g1.encode_scalars(ks)
    check("smul", g1_cuda.smul(F, S1[..., :N_SMUL], Ks, g1.nbits),
          g1_cuda.smul_plain(F, S1[..., :N_SMUL], Ks, g1.nbits))
    log("kernels_vs_plain", lanes=n, smul_lanes=N_SMUL, equal=True,
        max_abs_err={k: v["max_abs_err"] for k, v in results.items()})

    # the same check again at the main path's shapes, each kernel timed
    # beside its plain version: addsel on W*C lanes per scan step,
    # add/double on 2^20 lanes, smul on the 8,192 base points
    WC = M.n_windows(g1, C) * (N_MAIN // K)
    lanes_b = max(N_MAIN, WC)
    reps = -(-lanes_b // n)
    Pb = S1.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    Qb = Q.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    selb = torch.from_numpy(rng.random(WC) < 15 / 16).to(dev)
    Kb_ints = rand_ints(N_BASE)
    Kb = g1.encode_scalars(Kb_ints)
    shapes = {
        "add": (N_MAIN, lambda: g1_cuda.add(F, Pb[..., :N_MAIN], Qb[..., :N_MAIN]),
                lambda: chunked(lambda a, b: g1_cuda.add_plain(F, a, b), N_MAIN,
                                Pb[..., :N_MAIN], Qb[..., :N_MAIN])),
        "double": (N_MAIN, lambda: g1_cuda.double(F, Pb[..., :N_MAIN]),
                   lambda: chunked(lambda a: g1_cuda.double_plain(F, a), N_MAIN,
                                   Pb[..., :N_MAIN])),
        "addsel": (WC, lambda: g1_cuda.addsel(F, Pb[..., :WC], Qb[..., :WC], selb),
                   lambda: chunked(lambda a, b, s: g1_cuda.addsel_plain(F, a, b, s), WC,
                                   Pb[..., :WC], Qb[..., :WC], selb)),
        "smul": (N_BASE, lambda: g1_cuda.smul(F, Pb[..., :N_BASE], Kb, g1.nbits),
                 lambda: g1_cuda.smul_plain(F, Pb[..., :N_BASE], Kb, g1.nbits)),
    }
    # bytes each kernel must move (int32 limb tensors) and the field
    # products its inputs need (RCB add 12, double 8; addsel adds only on
    # selected lanes; the ladder doubles at every bit and adds at one-bits)
    pt_bytes = 3 * g1.fp.L * 4
    ones = sum(bin(k).count("1") for k in Kb_ints)
    work = {
        "add": (3 * pt_bytes * N_MAIN, 12 * N_MAIN),
        "double": (2 * pt_bytes * N_MAIN, 8 * N_MAIN),
        "addsel": ((3 * pt_bytes + 1) * WC, 12 * int(selb.sum())),
        "smul": ((2 * pt_bytes + 4 * Kb.shape[-2]) * N_BASE, 8 * g1.nbits * N_BASE + 12 * ones),
    }
    for name, (lanes, kern, plain) in shapes.items():
        ms, got = cuda_ms(kern, reps=5)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name, got, want)
        del got, want
        nbytes, fp_muls = work[name]
        results[name].update(ms=ms, plain_ms=plain_ms, lanes=lanes,
                             **bound(nbytes, wide_mads(fp_muls, g1.fp.L)))
        log("time", kernel=name, lanes=lanes, equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{results[name]['bound_ms']:.4f}", bound_by=results[name]["bound_by"])
    del Pb, Qb, selb

    # ---- 4. the n=512 gates
    pts0 = g1.scalar_mul(g1.gen, g1.encode_scalars(rand_ints(N_GATE)))
    ks0 = rand_ints(N_GATE)
    scs0 = g1.encode_scalars(ks0)
    want = g1.decode_point(M.msm_naive(g1, pts0, scs0))
    host = eng.g1.msm(g1.decode_points(pts0), ks0)
    got_h = M.horner_host(g1, M.msm_totals(g1, pts0, scs0, c=C, K=K, capture="dense"), C)
    split = M.bucket_table(g1, pts0, scs0, c=C, K=K, _limit=1 << 20)
    got_split = M.horner_host(g1, M.window_totals(g1, split, C), C)
    if not (want == host == got_h == got_split):
        raise AssertionError("n=512 gate failed: msm_totals/split/msm_naive/host disagree")
    log("gates", n=N_GATE, msm_totals_eq_naive=True, split_eq_naive=True, naive_eq_host=True)

    # ---- 5. the main path at 2^20 points
    for mod in (g1_cuda, fp_cuda, pairing_cuda):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base_ks = rand_ints(N_BASE)
    base = g1.scalar_mul(g1.gen, g1.encode_scalars(base_ks))
    base_aff = g1.decode_points(base)
    if base_aff != [eng.g1.mul(eng.gen_g1, k) for k in base_ks]:
        raise AssertionError("base points from scalar_mul disagree with the host engine")
    points = base.repeat(1, 1, N_MAIN // N_BASE).contiguous()
    ks_main = rand_ints(N_MAIN)
    scalars = g1.encode_scalars(ks_main)

    def run():
        return M.horner_host(g1, M.msm_totals(g1, points, scalars, c=C, K=K, capture="dense"), C)

    got = run()  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out != got:
            raise AssertionError("main-path MSM is not deterministic across runs")
    launches = g1_cuda.launches()
    peak = torch.cuda.max_memory_allocated()
    folded = [sum(ks_main[j::N_BASE]) % spec.r for j in range(N_BASE)]
    if got != eng.g1.msm(base_aff, folded):
        raise AssertionError("2^20 MSM disagrees with the folded host oracle")
    pps = N_MAIN / min(times)
    log("main_path", n=N_MAIN, c=C, K=K, capture="dense", equals_folded_host_oracle=True,
        seconds=[round(t, 4) for t in times], points_per_s=f"{pps:.1f}",
        peak_mem_GB=f"{peak / 1e9:.2f}", card=repr(smi))
    log("launches", **launches)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # stage breakdown of one more run (host clock, synchronised between stages)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = M.bucket_table(g1, points, scalars, c=C, K=K, capture="dense")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    totals = M.window_totals(g1, table, C)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    M.horner_host(g1, totals, C)
    t3 = time.perf_counter()
    log("stages", bucket_table_s=f"{t1 - t0:.4f}", window_totals_s=f"{t2 - t1:.4f}",
        horner_host_s=f"{t3 - t2:.4f}")
    if args.profile:
        profile_run(run)
        add_ms_by_curve(dev, rng)

    # ---- 6 and 7. the pairing-product check
    pair_launches = pairing_phases(dev, smi, results, args.profile)
    launches.update(pair_launches)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": None}  # no single PyTorch call computes any of these
        for name, (src, replaces) in KERNEL_INFO.items()
    ]
    log("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
