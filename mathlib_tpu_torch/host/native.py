"""ctypes binding for the port's C++ host engine (``csrc/host/engine.cpp``).

The port's own copy of the parts of ``mathlib_tpu/host/native.py`` that it
calls: the byte codec, the per-curve context, the G1 group law and MSM, the
G2 scalar mul, the Miller loop, the final exponentiation and the Fp12 ops.
``NativeEngine`` keeps the ``HostEngine`` interface, and the pure-Python
``HostEngine`` stays the exact oracle (``tests/test_torch_host.py`` holds the
two equal).

Build: ``g++ -O2 -shared -fPIC`` into ``build/mathlib_tpu_torch/`` at the
repository root, at first use.  The library is named after a hash of the
source, so a stale build can never load, and it is written to a per-process
temporary file that ``os.replace`` moves into place, so concurrent builders
(test workers) cannot race.  A failed build or load raises with g++'s
output; nothing falls back to the pure-Python engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from functools import lru_cache
from typing import Optional

from ..curves.params import CurveSpec, Family, hard_part_digits
from .engine import HostEngine

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "host", "engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mathlib_tpu_torch")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32, _I64, _S = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
SIGNATURES = {
    "mlt_g1_add": [_I32, _S, _S, _S],
    "mlt_g2_add": [_I32, _S, _S, _S],
    "mlt_f12_mul": [_I32, _S, _S, _S],
    "mlt_f12_inv": [_I32, _S, _S],
    "mlt_final_exp": [_I32, _S, _S],
    "mlt_g1_mul": [_I32, _S, _S, _I32, _S],
    "mlt_g2_mul": [_I32, _S, _S, _I32, _S],
    "mlt_g1_msm": [_I32, _I64, _S, _S, _I32, _S],
    "mlt_miller": [_I32, _I32, _S, _S, _S],
    "mlt_f12_pow": [_I32, _S, _S, _I32, _I32, _S],
}


def library_path() -> str:
    """Where the build of the current source lives (named by its hash)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmlt_host_{digest}.so")


def build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed (exit {res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout[-4000:]}{res.stderr[-8000:]}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The host engine library, built first if this source has no build."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            lib = ctypes.CDLL(path)
            lib.mlt_ctx_new.restype = ctypes.c_int32
            lib.mlt_ctx_new.argtypes = [_S, _I64]
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = argtypes
            _lib = lib
        return _lib


class _Codec:
    """int/tuple <-> wire bytes for one curve (little-endian 64-bit limbs)."""

    def __init__(self, spec: CurveSpec):
        self.L = (spec.p.bit_length() + 63) // 64
        self.fb = 8 * self.L
        self.p = spec.p
        self.r = spec.r
        self.klen = (spec.r.bit_length() + 7) // 8

    def fp(self, x: int) -> bytes:
        return (x % self.p).to_bytes(self.fb, "little")

    def un_fp(self, b: bytes) -> int:
        return int.from_bytes(b, "little")

    def g1(self, P) -> bytes:
        if P is None:
            return b"\x01" + b"\x00" * (2 * self.fb)
        return b"\x00" + self.fp(P[0]) + self.fp(P[1])

    def un_g1(self, b: bytes):
        if b[0]:
            return None
        return (
            self.un_fp(b[1 : 1 + self.fb]),
            self.un_fp(b[1 + self.fb : 1 + 2 * self.fb]),
        )

    def g2(self, P) -> bytes:
        if P is None:
            return b"\x01" + b"\x00" * (4 * self.fb)
        (x0, x1), (y0, y1) = P
        return b"\x00" + self.fp(x0) + self.fp(x1) + self.fp(y0) + self.fp(y1)

    def un_g2(self, b: bytes):
        if b[0]:
            return None
        f = self.fb
        c = [self.un_fp(b[1 + i * f : 1 + (i + 1) * f]) for i in range(4)]
        return ((c[0], c[1]), (c[2], c[3]))

    def f12(self, a) -> bytes:
        return b"".join(self.fp(c) for f6 in a for f2 in f6 for c in f2)

    def un_f12(self, b: bytes):
        f = self.fb
        vals = [self.un_fp(b[i * f : (i + 1) * f]) for i in range(12)]
        return tuple(
            tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1]) for j in range(3))
            for i in range(2)
        )

    def scalar(self, k: int) -> bytes:
        return (k % self.r).to_bytes(self.klen, "little")


def _build_cfg(spec: CurveSpec, tower) -> bytes:
    """The context blob ``mlt_ctx_new`` parses (csrc/host/engine.cpp)."""
    co = _Codec(spec)

    def u32(v):
        return int(v).to_bytes(4, "little")

    parts = [
        u32(co.L),
        u32(0 if spec.family == Family.BLS12 else 1),
        u32(0 if spec.twist == "M" else 1),
        u32(1 if spec.x < 0 else 0),
        abs(spec.x).to_bytes(8, "little"),
        spec.p.to_bytes(co.fb, "little"),
        co.fp(spec.beta),
        co.fp(spec.xi[0]),
        co.fp(spec.xi[1]),
        co.fp(spec.b),
        co.fp(spec.b2[0]),
        co.fp(spec.b2[1]),
        co.fp(tower.frob_v[0]),
        co.fp(tower.frob_v[1]),
        co.fp(tower.frob_w[0]),
        co.fp(tower.frob_w[1]),
    ]
    # base-p digits of the hard-part exponent (as fields.py f12_final_exp)
    digits = hard_part_digits(spec)
    parts.append(u32(len(digits)))
    parts += [d.to_bytes(co.fb, "little") for d in digits]
    return b"".join(parts)


class _NativeGroup:
    """WeierstrassCurve facade backed by the C++ library; anything not
    implemented there falls through to the exact Python curve."""

    def __init__(self, lib, handle: int, co: _Codec, pyc, g2: bool):
        self._h = handle
        self._co = co
        self._py = pyc
        self._g2 = g2
        self._lib = lib
        self._psz = 1 + (4 if g2 else 2) * co.fb
        self._enc = co.g2 if g2 else co.g1
        self._dec = co.un_g2 if g2 else co.un_g1
        self._fadd = lib.mlt_g2_add if g2 else lib.mlt_g1_add
        self._fmul = lib.mlt_g2_mul if g2 else lib.mlt_g1_mul

    def __getattr__(self, name):
        return getattr(self._py, name)

    def add(self, P, Q):
        out = ctypes.create_string_buffer(self._psz)
        self._fadd(self._h, self._enc(P), self._enc(Q), out)
        return self._dec(out.raw)

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def neg(self, P):
        return self._py.neg(P)

    def double(self, P):
        return self.add(P, P)

    def mul(self, P, k: int):
        """[k]P by the library's ladder; any k, any point on the curve."""
        if k < 0:
            return self.mul(self.neg(P), -k)
        if P is None or k == 0:
            return None
        kb = k.to_bytes((k.bit_length() + 7) // 8, "little")
        out = ctypes.create_string_buffer(self._psz)
        self._fmul(self._h, self._enc(P), kb, len(kb), out)
        return self._dec(out.raw)

    mul_any = mul

    def msm(self, points, scalars):
        if self._g2:
            return self._py.msm(points, scalars)
        pts = b"".join(self._enc(P) for P in points)
        ks = b"".join(self._co.scalar(int(s)) for s in scalars)
        out = ctypes.create_string_buffer(self._psz)
        self._lib.mlt_g1_msm(self._h, len(points), pts, ks, self._co.klen, out)
        return self._dec(out.raw)


class NativeEngine(HostEngine):
    """``HostEngine`` with the hot single-element ops in C++ (bit-exact to the
    pure-Python engine, which stays authoritative)."""

    def __init__(self, spec: CurveSpec):
        super().__init__(spec)
        lib = load()
        self._lib = lib
        self._co = _Codec(spec)
        cfg = _build_cfg(spec, self.tw)
        h = lib.mlt_ctx_new(cfg, len(cfg))
        if h < 0:
            raise RuntimeError(f"the native host engine rejected {spec.name}'s context")
        self._h = h
        self.g1 = _NativeGroup(lib, h, self._co, self.g1, g2=False)
        self.g2 = _NativeGroup(lib, h, self._co, self.g2, g2=True)

    def _f12_out(self, fn, *args):
        out = ctypes.create_string_buffer(12 * self._co.fb)
        fn(self._h, *args, out)
        return self._co.un_f12(out.raw)

    # -------------------------------------------------------------- pairing —
    def miller_loop(self, pairs):
        co = self._co
        ps = b"".join(co.g1(P) for P, _ in pairs)
        qs = b"".join(co.g2(Q) for _, Q in pairs)
        return self._f12_out(self._lib.mlt_miller, len(pairs), ps, qs)

    def final_exp(self, f):
        return self._f12_out(self._lib.mlt_final_exp, self._co.f12(f))

    # ------------------------------------------------------------------- Gt —
    def gt_exp(self, a, e: int):
        mag = abs(e)
        eb = mag.to_bytes(max(1, (mag.bit_length() + 7) // 8), "little")
        return self._f12_out(
            self._lib.mlt_f12_pow, self._co.f12(a), eb, len(eb), 1 if e < 0 else 0
        )

    def gt_mul(self, a, b):
        return self._f12_out(self._lib.mlt_f12_mul, self._co.f12(a), self._co.f12(b))

    def gt_inv(self, a):
        return self._f12_out(self._lib.mlt_f12_inv, self._co.f12(a))


@lru_cache(maxsize=None)
def get_engine(spec: CurveSpec) -> NativeEngine:
    """The C++ host engine for ``spec``.  Raises if it cannot be built or
    loaded; the pure-Python ``HostEngine`` is reached only by name."""
    return NativeEngine(spec)
