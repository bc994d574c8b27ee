"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``mathlib_tpu_torch/csrc/*.cu`` compiles to an object file in its own
``nvcc`` process, all started together, and the objects link into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds to a minute).  The twins ``csrc/*_nw9.cu`` compile their sources
again at nine 32-bit words (L = 18, FP256BN's field on the card), in
processes of their own beside the others, so that a third word count does
not lengthen the build's wall; each launcher hands L = 18 on to its twin's
(``csrc/words.cuh``), so a kernel has one launcher:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o build/mathlib_tpu_torch/obj/<name>.o csrc/<name>.cu
    nvcc -shared -o build/mathlib_tpu_torch/libmlt_kernels.so build/mathlib_tpu_torch/obj/*.o

The library lands in ``build/mathlib_tpu_torch/`` at the repository root and
is rebuilt when a source is newer than it.  A failed build raises with nvcc's
output; there is no fallback.  (``csrc/host/engine.cpp`` is the C++ host
engine, built with g++ by ``host/native.py``, not here.)

The wrappers (``g1_cuda``, ``g2_cuda``, ``fp_cuda``, ``pairing_cuda``,
``hash_cuda``, ``gather_cuda``) reach the library through ``launch``, ``consts`` (a prime's
constants as the launchers take them) and ``stream`` (the tensor's current
CUDA stream).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mathlib_tpu_torch")
LIB = os.path.join(BUILD_DIR, "libmlt_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
SECONDS: dict = {}  # wall seconds of each source's nvcc in the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_Q = ctypes.c_int64
# C launchers (csrc/*.cu): every one returns cudaGetLastError()
SIGNATURES = {
    # (csrc/g1_split_kernels.cu) P, Q, [sel,] out, n, L, consts, b3, stream
    "mlt_g1_add": [_P, _P, _P, _I, _I, _P, _I, _P],
    "mlt_g1_addsel": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    # P, out, n, L, consts, b3, stream
    "mlt_g1_double": [_P, _P, _I, _I, _P, _I, _P],
    # Q, scalars, out, n, L, S, nbits, consts, b3, stream
    "mlt_g1_smul": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    # Q, bits, nbits, out, n, L, consts, b3, stream
    "mlt_g1_smul_static": [_P, _P, _I, _P, _I, _I, _P, _I, _P],
    # P, Q, sel, out, n, L, consts, b3, stream (Q affine (2, L, n) for maddsel)
    "mlt_g1_dbladd": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    "mlt_g1_maddsel": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    # P, Q, sel, neg, out, n, L, consts, b3, stream
    "mlt_g1_addselneg": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    "mlt_g1_maddselneg": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    # (csrc/g2_point_kernels.cu, g2_dblsel_kernels.cu) P, [Q, [sel,]] out, n, L,
    # consts, b3.c0, b3.c1, stream; (csrc/g2_smul_kernels.cu) the ladders Q,
    # scalars, S, nbits / Q, bits, nbits, then out, n, L, consts, b3.c0, b3.c1,
    # stream
    "mlt_g2_add": [_P, _P, _P, _I, _I, _P, _I, _I, _P],
    "mlt_g2_double": [_P, _P, _I, _I, _P, _I, _I, _P],
    "mlt_g2_addsel": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
    "mlt_g2_dblsel": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P],
    "mlt_g2_smul": [_P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _P],
    "mlt_g2_smul_static": [_P, _P, _I, _P, _I, _I, _P, _I, _I, _P],
    # (csrc/miller_split_kernels.cu) xP, yP, Qx, Qy, bits, nbits, nvalid, out, lanes,
    # L, consts, tower ints, tail words, program, program meta, stream
    "mlt_pairing_miller_lanes": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                                 _P],
    # xP, yP, Qx, Qy, bits, nbits, f out, T out, lanes, L, consts, tower ints,
    # tail words, program, program meta, stream
    "mlt_pairing_miller_ft": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    # f in, T in, Qx, Qy, xP, yP, f out, T out, lanes, L, consts, program,
    # program meta, stream
    "mlt_pairing_add_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # (csrc/fexp_split_kernels.cu) base, script, steps, out, lanes, L, consts,
    # program, program meta, stream
    "mlt_f12_pow": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    # f in, script, steps, inverse bits, n, gammas, out, lanes, L, consts,
    # program, program meta, stream
    "mlt_final_exp": [_P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    # in, out, lanes, levels, script, steps, L, consts, program, program meta, stream
    "mlt_f12_tree": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    # (csrc/gather_kernels.cu) table, idx, idx is int64, out, M, Wr, stream
    "mlt_gather_rows": [_P, _P, _I, _P, _Q, _I, _P],
    "mlt_gather_rows_t": [_P, _P, _I, _P, _Q, _I, _P],
    # (csrc/check_kernels.cu) xP, yP, Qx, Qy, nvalid, inverse bits, n, gammas, ok
    # out, product out, scratch, ticket, lanes, blocks, L, consts, tower ints, tail
    # words, code (programs and scripts), meta, stream
    "mlt_pairing_check": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                          _P, _P, _P, _P],
    # (csrc/fp_kernels.cu) a, b, b_step, out, rows, n, L, consts, threads an
    # element, stream
    "mlt_fp_mont_mul": [_P, _P, _I, _P, _I, _I, _I, _P, _I, _P],
    # a, bits, nbits, out, rows, n, L, consts, threads an element, stream
    "mlt_fp_pow": [_P, _P, _I, _P, _I, _I, _I, _P, _I, _P],
    # (csrc/hash_kernels.cu) u0, u1, inverse bits, n, sqrt bits, n, h bits, n, h < 0,
    # curve constants, sign mode, out, n, L, consts, b3, stream
    "mlt_hash_g1": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P],
}
# the limb counts the launchers take: 8, 9 and 12 32-bit words (the static
# ladders, the device hash and the one-launch check refuse 18: csrc/words.cuh)
KERNEL_LS = (16, 18, 24)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    built = os.path.getmtime(LIB)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(f) > built for f in deps)


def build() -> None:
    """Compile every source in parallel, then link (the ptxas register and
    spill report of each, and its nvcc seconds, go to build.log and
    ``SECONDS``)."""
    obj_dir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    tmp = f"{LIB}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    jobs = []
    t0 = time.perf_counter()
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    def finish(proc):
        out, err = proc.communicate(timeout=900)
        return out, err, time.perf_counter() - t0

    log, failed = [], []
    try:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            done = list(pool.map(finish, [proc for _, _, proc in jobs]))
        SECONDS.clear()
        for (cmd, _, proc), (out, err, secs) in zip(jobs, done):
            SECONDS[os.path.basename(cmd[-1])] = round(secs, 1)
            log.append(" ".join(cmd) + f"\n(nvcc {secs:.1f} s)\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): {cmd[-1]}\n{err[-8000:]}")
        if not failed:
            cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"nvcc link failed (exit {res.returncode}):\n{res.stderr[-8000:]}")
        with open(BUILD_LOG, "w") as f:
            f.write("\n".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, LIB)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(obj_dir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@lru_cache(maxsize=None)
def consts(p: int, L: int) -> ctypes.Array:
    """Kernel constants as 32-bit words: p, 2p, R mod p, then -p^-1 mod 2^32."""
    nw = L // 2
    R = 1 << (16 * L)

    def words(x):
        return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(nw)]

    vals = words(p) + words(2 * p) + words(R % p) + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
    return (ctypes.c_uint32 * len(vals))(*vals)


def launch(name: str, *args) -> None:
    """Call the C launcher ``name``; raise on a nonzero CUDA error."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a handle for a launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream
