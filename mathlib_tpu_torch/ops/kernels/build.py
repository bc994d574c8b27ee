"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All of ``mathlib_tpu_torch/csrc/*.cu`` compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/mathlib_tpu_torch/libmlt_kernels.so csrc/*.cu

The library lands in ``build/mathlib_tpu_torch/`` at the repository root and
is rebuilt when a source is newer than it.  A failed build raises with nvcc's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mathlib_tpu_torch")
LIB = os.path.join(BUILD_DIR, "libmlt_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C launchers (csrc/g1_kernels.cu): every one returns cudaGetLastError()
SIGNATURES = {
    # P, Q, out, n, L, consts, b3, stream
    "mlt_g1_add": [_P, _P, _P, _I, _I, _P, _I, _P],
    # P, out, n, L, consts, b3, stream
    "mlt_g1_double": [_P, _P, _I, _I, _P, _I, _P],
    # P, Q, sel, out, n, L, consts, b3, stream
    "mlt_g1_addsel": [_P, _P, _P, _P, _I, _I, _P, _I, _P],
    # Q, scalars, out, n, L, S, nbits, consts, b3, stream
    "mlt_g1_smul": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
}


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
    """Compile the library (ptxas register/spill report goes to build.log)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.tmp.{os.getpid()}"
    cmd = [
        _nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, *_sources(),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        with open(BUILD_LOG, "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {res.returncode}):\n{res.stderr[-8000:]}"
            )
        os.replace(tmp, LIB)
    finally:
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
