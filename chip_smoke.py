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

Prints one JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code != 0) before that line.  Imports no JAX.

    python3 chip_smoke.py --profile

adds, after phase 5, one MSM under ``torch.profiler`` (device time by kernel
and by operator, and the device's busy share of the profiled wall time) and
the ``add`` kernel's time at 2^20 lanes on BLS12-381 (12 words) beside BN254
(8 words).
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

REPLACES = {
    "add": "mathlib_tpu/ops/kernels/g1_pallas.py:174",
    "double": "mathlib_tpu/ops/kernels/g1_pallas.py:182",
    "addsel": "mathlib_tpu/ops/kernels/g1_pallas.py:210",
    "smul": "mathlib_tpu/ops/kernels/g1_pallas.py:476",
}
SOURCE = "mathlib_tpu_torch/csrc/g1_kernels.cu"


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
    and the output of the last run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def chunked(fn, lanes: int, *args):
    """fn on PLAIN_CHUNK-lane slices of its (..., lanes) arguments, joined."""
    import torch

    return torch.cat(
        [fn(*[a[..., lo : lo + PLAIN_CHUNK] for a in args]) for lo in range(0, lanes, PLAIN_CHUNK)],
        dim=-1,
    )


def profile_msm(run) -> None:
    """Device time of one run() by kernel and by operator (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(ev):
        us = getattr(ev, "self_device_time_total", None)
        return ev.self_cuda_time_total if us is None else us

    events = prof.key_averages()
    kernels = sorted(
        (ev for ev in events if str(ev.device_type).endswith("CUDA") and dev_us(ev) > 0),
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
    from mathlib_tpu.curves.params import get_spec
    from mathlib_tpu.host.engine import get_engine
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one 2^20 MSM and time add on BLS12-381 vs BN254")
    args = ap.parse_args()

    import numpy as np
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mathlib_tpu_torch
    from mathlib_tpu.curves.params import get_spec
    from mathlib_tpu.host.engine import get_engine

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError("mathlib_tpu_torch was not imported from this checkout")
    from mathlib_tpu_torch.ops import msm as M
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import build, g1_cuda

    dev = mathlib_tpu_torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log("device", kind=repr(kind), count=count, smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load()  # builds here unless an up-to-date library is already there
    keys = ("entry function", "Function properties", "spill", "registers")
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
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"kernel {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel {name} disagrees with its plain version ({err=})")
        res = results.setdefault(name, {"max_abs_err": 0})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        return got

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
    Kb = g1.encode_scalars(rand_ints(N_BASE))
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
    for name, (lanes, kern, plain) in shapes.items():
        ms, got = cuda_ms(kern, reps=5)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name, got, want)
        del got, want
        results[name].update(ms=ms, plain_ms=plain_ms, lanes=lanes)
        log("time", kernel=name, lanes=lanes, equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x")
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
    g1_cuda.reset_launches()
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
        profile_msm(run)
        add_ms_by_curve(dev, rng)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in ("add", "double", "addsel", "smul")
    ]
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
