"""ctypes binding for the port's C++ host engine (``csrc/host/engine.cpp``).

The port's own copy of ``mathlib_tpu/host/native.py`` without its
pure-Python fallback: the byte codec, the per-curve context, the G1 group
law and MSM, the G2 scalar mul, the Miller loop, the final exponentiation
and the Fp12 ops, and the API's scalar muls: GLV on G1 and GLS on BLS12
G2 (``mul``), each finished by a joint multiplication of the library
(``mlt_g1_mul2``, ``mlt_g2_muln``), and ``mul2``.
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
    "mlt_g1_mul2": [_I32, _S, _S, _I32, _S, _S, _I32, _S],
    "mlt_g2_muln": [_I32, _I32, _S, _S, _I32, _S],
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


def _glv_constants(spec: CurveSpec):
    """Candidate (lam, beta) cube roots of unity for the GLV endomorphism
    [lam]P == (beta * x, y) on G1 (matching pair selected empirically on
    the generator by NativeEngine), or None."""
    p, r = spec.p, spec.r
    if r % 3 != 1 or p % 3 != 1:
        return None

    def cube_roots(m):
        # roots of z^2 + z + 1: (-1 +- sqrt(-3)) / 2 mod m
        s = _sqrt_mod(m - 3, m)
        if s is None:
            return []
        inv2 = pow(2, -1, m)
        return [((-1 + s) * inv2) % m, ((-1 - s) * inv2) % m]

    lams = cube_roots(r)
    betas = cube_roots(p)
    if not lams or not betas:
        return None
    return lams, betas


def _glv_lattice(r: int, lam: int):
    """Short lattice basis for the GLV split (GLV 2001, extended Euclid).

    Returns (v1, v2, det) with v = (a, b) satisfying a + b*lam = 0 mod r
    and |a|, |b| ~ sqrt(r); det = v1[0]*v2[1] - v1[1]*v2[0] (= +-r).
    The naive divmod split only balances when r = lam^2 + lam + 1 as
    INTEGERS (BLS12); BN-family roots are ~0.75 r bits, so the lattice
    reduction is what actually delivers ~sqrt(r) halves there.
    """
    import math

    sq = math.isqrt(r)
    # EEA rows: r_i = s_i*r + t_i*lam
    r0, t0 = r, 0
    r1, t1 = lam, 1
    rows = [(r0, t0), (r1, t1)]
    while rows[-1][0] != 0:
        q = rows[-2][0] // rows[-1][0]
        rows.append((rows[-2][0] - q * rows[-1][0], rows[-2][1] - q * rows[-1][1]))
    l = next(i for i in range(len(rows)) if rows[i][0] < sq)
    # v = (r_i, -t_i) is in {(x, y) : x + y*lam = 0 mod r}
    cands = [(rows[i][0], -rows[i][1]) for i in (l - 1, l, min(l + 1, len(rows) - 1))]
    cands.sort(key=lambda v: max(abs(v[0]), abs(v[1])))
    v1, v2 = cands[0], cands[1]
    det = v1[0] * v2[1] - v1[1] * v2[0]
    if det == 0:
        v2 = cands[2]
        det = v1[0] * v2[1] - v1[1] * v2[0]
    return v1, v2, det


def _rnd_div(a: int, b: int) -> int:
    """round(a / b) to nearest (b may be negative)."""
    if b < 0:
        a, b = -a, -b
    return (2 * a + b) // (2 * b)


def _sqrt_mod(a: int, m: int):
    """Tonelli-Shanks square root mod prime m (None if non-residue)."""
    a %= m
    if a == 0:
        return 0
    if pow(a, (m - 1) // 2, m) != 1:
        return None
    if m % 4 == 3:
        return pow(a, (m + 1) // 4, m)
    q, s = m - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (m - 1) // 2, m) != m - 1:
        z += 1
    c = pow(z, q, m)
    x = pow(a, (q + 1) // 2, m)
    t = pow(a, q, m)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % m
            i += 1
        b = pow(c, 1 << (s - i - 1), m)
        x = x * b % m
        t = t * b * b % m
        c = b * b % m
        s = i
    return x


def _psi_constants(spec: CurveSpec):
    """(cx, cy): psi(x, y) = (conj(x)*cx, conj(y)*cy) on the twist —
    untwist-Frobenius-retwist, eigenvalue p = x mod r on BLS12 G2."""
    from .fields import get_tower

    t = get_tower(spec)
    fw2 = t.f2_sqr(t.frob_w)
    fw3 = t.f2_mul(fw2, t.frob_w)
    if spec.twist == "M":
        return t.f2_inv(fw2), t.f2_inv(fw3)
    return fw2, fw3


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
        self._glv = None  # (lam, beta, v1, v2, det), set by NativeEngine for G1
        self._gls = None  # (x_abs, x_neg, psi), set by NativeEngine for BLS12 G2

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

    def mul_any(self, P, k: int):
        """Endomorphism-free scalar mul — correct for any twist/curve
        point, not just the r-torsion (see WeierstrassCurve.mul_any)."""
        if k < 0:
            return self.mul_any(self.neg(P), -k)
        if P is None or k == 0:
            return None
        kb = self._co.scalar(k) if k < self._co.r else k.to_bytes(
            (k.bit_length() + 7) // 8, "little"
        )
        out = ctypes.create_string_buffer(self._psz)
        self._fmul(self._h, self._enc(P), kb, len(kb), out)
        return self._dec(out.raw)

    def mul(self, P, k: int):
        if k < 0:
            return self.mul(self.neg(P), -k)
        if self._gls is not None and P is not None and 0 < k < self._co.r:
            # 4-dim GLS: k = sum k_i |x|^i (digits base |x| of k < r <= x^4),
            # [x^i]Q = psi^i(Q), so [k]Q = sum [k_i] (sgn^i) psi^i(Q)
            x_abs, x_neg, psi = self._gls
            digits, kk = [], k
            pts, cur = [], P
            for i in range(4):
                kk, d = divmod(kk, x_abs)
                digits.append(d)
                pts.append(self._py.neg(cur) if (x_neg and i % 2) else cur)
                cur = psi(cur)
            klen = (x_abs.bit_length() + 7) // 8
            ks = b"".join(d.to_bytes(klen, "little") for d in digits)
            ps = b"".join(self._enc(q) for q in pts)
            out = ctypes.create_string_buffer(self._psz)
            self._lib.mlt_g2_muln(self._h, 4, ps, ks, klen, out)
            return self._dec(out.raw)
        if self._glv is not None and P is not None and 0 < k < self._co.r:
            # Babai round-off against the short lattice basis:
            # (k1, k2) = (k, 0) - b1 v1 - b2 v2, |k_i| ~ sqrt(r), signed
            lam, beta, v1, v2, det = self._glv
            b1 = _rnd_div(k * v2[1], det)
            b2 = _rnd_div(-k * v1[1], det)
            k1 = k - b1 * v1[0] - b2 * v2[0]
            k2 = -b1 * v1[1] - b2 * v2[1]
            phiP = (P[0] * beta % self._co.p, P[1])  # [lam]P
            P1 = self._py.neg(P) if k1 < 0 else P
            P2 = self._py.neg(phiP) if k2 < 0 else phiP
            return self.mul2(P1, abs(k1), P2, abs(k2), _plain=True)
        return self.mul_any(P, k)

    def mul2(self, P, e: int, Q, f: int, _plain: bool = False):
        if self._g2 or e < 0 or f < 0:
            return self.add(self.mul(P, e), self.mul(Q, f))
        if not _plain and self._glv is not None and P is not None and Q is not None:
            # GLV both halves: one 4-way joint mul beats two 2-way ones,
            # but two joint calls keep the C seam simple and still halve
            # the doublings.
            return self.add(self.mul(P, e), self.mul(Q, f))
        blen = (max(e, f, 1).bit_length() + 7) // 8
        eb = e.to_bytes(blen, "little")
        fb_ = f.to_bytes(blen, "little")
        out = ctypes.create_string_buffer(self._psz)
        self._lib.mlt_g1_mul2(
            self._h, self._enc(P), eb, len(eb), self._enc(Q), fb_, len(fb_), out
        )
        return self._dec(out.raw)

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
        # GLV: find the (lam, beta) pairing that matches on the generator,
        # then build the short lattice basis and self-check the split
        roots = _glv_constants(spec)
        if roots:
            lams, betas = roots
            G = spec.g1_gen
            for lam in lams:
                want = self.g1.mul(G, lam)  # plain path (_glv still None)
                beta = next(
                    (b for b in betas if want == (G[0] * b % spec.p, G[1])),
                    None,
                )
                if beta is not None:
                    v1, v2, det = _glv_lattice(spec.r, lam)
                    # sanity: decomposition is exact and short for a probe k
                    k = (spec.r * 2) // 3 + 12345
                    b1 = _rnd_div(k * v2[1], det)
                    b2 = _rnd_div(-k * v1[1], det)
                    k1 = k - b1 * v1[0] - b2 * v2[0]
                    k2 = -b1 * v1[1] - b2 * v2[1]
                    half = 1 << (spec.r.bit_length() // 2 + 3)
                    if (k1 + k2 * lam - k) % spec.r == 0 and abs(k1) < half and abs(k2) < half:
                        self.g1._glv = (lam, beta, v1, v2, det)
                    break
        # GLS on G2 (BLS12 only: psi eigenvalue is exactly the parameter x)
        if spec.family == Family.BLS12:
            from .fields import get_tower

            t = get_tower(spec)
            cx, cy = _psi_constants(spec)

            def psi(Q, _t=t, _cx=cx, _cy=cy):
                return (
                    _t.f2_mul(_t.f2_conj(Q[0]), _cx),
                    _t.f2_mul(_t.f2_conj(Q[1]), _cy),
                )

            G2g = spec.g2_gen
            if self.g2.mul(G2g, spec.x % spec.r) == psi(G2g):
                self.g2._gls = (abs(spec.x), spec.x < 0, psi)

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
