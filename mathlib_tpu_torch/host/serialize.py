"""Bit-exact wire formats of the upstream backends: the port's own copy of
``mathlib_tpu/host/serialize.py``, on the port's curves and host engine
(``tests/test_torch_serialize.py`` holds the two byte for byte equal).

Three formats, selected by CurveSpec.ser_format:

  ZCASH — BLS12-381 (kilic & gnark agree; pinned by Test381Compat,
          math_test.go:879-911). 3 flag bits in the MSB of the leading
          coordinate: 0x80 compressed, 0x40 infinity, 0x20 lexicographically
          larger y. Sizes 96/48 (G1), 192/96 (G2). (kilic/bls12-381.go:312-334)

  GNARK — BN254 and BLS12-377 (gnark-crypto scheme, 2 flag bits):
          0b00 uncompressed, 0b01 compressed-infinity, 0b10 compressed with
          lexicographically smaller y, 0b11 compressed larger. Uncompressed
          infinity is the all-zero buffer. Sizes 64/32, 128/64 (BN254);
          96/48, 192/96 (BLS12-377). (gurvy/bn254.go:307-329)

  AMCL  — FP256BN: 0x04 prefix uncompressed G1 (65 B), 0x02/0x03 (y parity)
          compressed G1 (33 B), G2 = xa||xb||ya||yb (128 B, no prefix).
          (amcl/fp256bn.go:103-125, :230-242)

Scalars: 32-byte big-endian with the BigToBytes two's-complement convention
for negatives and mod-q canonicalization (driver/common/big.go:25-39,101-113).

Gt: 12 coordinates. kilic/gnark lay out Fp12 coefficients in descending
tower order (C1.B2.A1 first ... C0.B0.A0 last); AMCL uses its Fp4 tower in
ascending order — we convert bases (both towers are generated by w, so the
map is a coefficient permutation).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..curves.params import CurveSpec, SerFormat
from .engine import HostEngine
from .fields import Fp12

Point = Optional[Tuple]


class SerializationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# scalars (Zr) — common to all curves
# ---------------------------------------------------------------------------

SCALAR_BYTES = 32
_ONE_BITS = (1 << (8 * SCALAR_BYTES)) - 1


def big_to_bytes(v: int) -> bytes:
    """driver/common/big.go:25-39 BigToBytes, incl. negative two's complement."""
    if v >= 0:
        return v.to_bytes(SCALAR_BYTES, "big")
    twos = _ONE_BITS + v + 1  # onebig - (-v) + 1
    return twos.to_bytes(SCALAR_BYTES, "big")


def zr_to_bytes(v: int, modulus: int) -> bytes:
    """BaseZr.Bytes: canonicalize mod q only if negative or > q (sic: the
    value q itself round-trips as q, driver/common/big.go:101-113)."""
    target = v
    if v < 0 or v > modulus:
        target = v % modulus
        if target < 0:
            target += modulus
    return big_to_bytes(target)


def zr_from_bytes(b: bytes) -> int:
    """NewZrFromBytes: plain unsigned big-endian, no reduction
    (driver/common/curve.go:58-63)."""
    return int.from_bytes(b, "big")


# ---------------------------------------------------------------------------
# field coordinate helpers
# ---------------------------------------------------------------------------


def _fp_to(v: int, size: int) -> bytes:
    return v.to_bytes(size, "big")


def _fp_from(b: bytes, p: int) -> int:
    v = int.from_bytes(b, "big")
    if v >= p:
        raise SerializationError("coordinate not a canonical field element")
    return v


def _lex_larger_fp(y: int, p: int) -> bool:
    """y lexicographically larger than -y  <=>  y > (p-1)/2."""
    return y > (p - 1) // 2


def _lex_larger_fp2(y: Tuple[int, int], p: int) -> bool:
    """Compare (c1, c0) against the negation, c1 first (kilic/gnark agree)."""
    y0, y1 = y
    if y1 != 0:
        return _lex_larger_fp(y1, p)
    return _lex_larger_fp(y0, p)


# ---------------------------------------------------------------------------
# G1 / G2 codecs
# ---------------------------------------------------------------------------


class Codec:
    def __init__(self, spec: CurveSpec, engine: HostEngine):
        self.spec = spec
        self.e = engine
        self.n = spec.fp_bytes

    # ---------------- G1 ----------------
    def g1_to_bytes(self, P: Point, compressed: bool) -> bytes:
        f = self.spec.ser_format
        if f in (SerFormat.AMCL, SerFormat.AMCL_MIRACL):
            return self._amcl_g1(P, compressed)
        if compressed:
            return self._flag_g1_compressed(P)
        return self._flag_g1_uncompressed(P)

    def g1_from_bytes(self, b: bytes, compressed: Optional[bool] = None) -> Point:
        if b is None:
            raise SerializationError("nil input")
        b = bytes(b)
        f = self.spec.ser_format
        if f in (SerFormat.AMCL, SerFormat.AMCL_MIRACL):
            return self._amcl_g1_from(b)
        # gnark accepts either length from the same entry point (SetBytes);
        # zcash (kilic) distinguishes by the compression flag + length.
        if len(b) == 2 * self.n:
            return self._flag_g1_from_uncompressed(b)
        if len(b) == self.n:
            return self._flag_g1_from_compressed(b)
        raise SerializationError(f"invalid G1 encoding length {len(b)}")

    def _flag_g1_uncompressed(self, P: Point) -> bytes:
        n, spec = self.n, self.spec
        if P is None:
            if spec.ser_format == SerFormat.ZCASH:
                return bytes([0x40]) + bytes(2 * n - 1)
            return bytes(2 * n)  # gnark: all-zero buffer
        x, y = P
        return _fp_to(x, n) + _fp_to(y, n)

    def _flag_g1_compressed(self, P: Point) -> bytes:
        n, spec, p = self.n, self.spec, self.spec.p
        zcash = spec.ser_format == SerFormat.ZCASH
        if P is None:
            if zcash:
                return bytes([0xC0]) + bytes(n - 1)
            return bytes([0x40]) + bytes(n - 1)
        x, y = P
        out = bytearray(_fp_to(x, n))
        if zcash:
            out[0] |= 0x80
            if _lex_larger_fp(y, p):
                out[0] |= 0x20
        else:
            out[0] |= 0xC0 if _lex_larger_fp(y, p) else 0x80
        return bytes(out)

    def _flag_g1_from_uncompressed(self, b: bytes) -> Point:
        n, spec = self.n, self.spec
        flags = b[0] & 0xE0
        if spec.ser_format == SerFormat.ZCASH:
            if flags & 0x80:
                raise SerializationError("compression flag set on uncompressed input")
            if flags & 0x40:
                if any(b[1:]) or (b[0] & 0x3F):
                    raise SerializationError("malformed infinity encoding")
                return None
            body = b
        else:
            if b[0] & 0xC0:
                raise SerializationError("unexpected flags on uncompressed input")
            if not any(b):
                return None  # gnark all-zero = infinity
            body = b
        x = _fp_from(body[:n], spec.p)
        # strip zcash flag bits from the x coordinate's top byte
        if spec.ser_format == SerFormat.ZCASH:
            x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:n], "big")
            if x >= spec.p:
                raise SerializationError("x out of range")
        y = _fp_from(body[n:], spec.p)
        P = (x, y)
        self._check_g1(P)
        return P

    def _flag_g1_from_compressed(self, b: bytes) -> Point:
        n, spec, p = self.n, self.spec, self.spec.p
        zcash = spec.ser_format == SerFormat.ZCASH
        if zcash:
            if not b[0] & 0x80:
                raise SerializationError("compression flag missing")
            if b[0] & 0x40:
                if (b[0] & 0x3F) or any(b[1:]):
                    raise SerializationError("malformed infinity encoding")
                return None
            larger = bool(b[0] & 0x20)
            x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
        else:
            flags = (b[0] & 0xC0) >> 6
            if flags == 0b01:
                if (b[0] & 0x3F) or any(b[1:]):
                    raise SerializationError("malformed infinity encoding")
                return None
            if flags not in (0b10, 0b11):
                raise SerializationError("compression flag missing")
            larger = flags == 0b11
            x = int.from_bytes(bytes([b[0] & 0x3F]) + b[1:], "big")
        if x >= p:
            raise SerializationError("x out of range")
        rhs = (x * x % p * x + self.spec.b) % p
        y = self.e.tw.fp_sqrt(rhs)
        if y is None:
            raise SerializationError("x not on curve")
        if _lex_larger_fp(y, p) != larger:
            y = p - y
        P = (x, y)
        self._check_g1(P, subgroup=True)
        return P

    def _amcl_g1(self, P: Point, compressed: bool) -> bytes:
        n = self.n
        if P is None:
            # AMCL serializes infinity as (0, 0) with the usual prefix
            if compressed:
                return bytes([0x02]) + bytes(n)
            return bytes([0x04]) + bytes(2 * n)
        x, y = P
        if compressed:
            return bytes([0x02 | (y & 1)]) + _fp_to(x, n)
        return bytes([0x04]) + _fp_to(x, n) + _fp_to(y, n)

    def _amcl_g1_from(self, b: bytes) -> Point:
        n, p = self.n, self.spec.p
        if len(b) == 2 * n + 1 and b[0] == 0x04:
            x = _fp_from(b[1 : n + 1], p)
            y = _fp_from(b[n + 1 :], p)
            if x == 0 and y == 0:
                return None
            P = (x, y)
            self._check_g1(P)
            return P
        if len(b) == n + 1 and b[0] in (0x02, 0x03):
            x = _fp_from(b[1:], p)
            rhs = (x * x % p * x + self.spec.b) % p
            if x == 0 and rhs == self.spec.b and b[0] == 0x02:
                # (0,0) marker for infinity only if 0 not on curve
                if self.e.tw.fp_sqrt(rhs) is None:
                    return None
            y = self.e.tw.fp_sqrt(rhs)
            if y is None:
                if x == 0:
                    return None
                raise SerializationError("x not on curve")
            if (y & 1) != (b[0] & 1):
                y = p - y
            P = (x, y)
            self._check_g1(P)
            return P
        raise SerializationError("invalid AMCL G1 encoding")

    def _check_g1(self, P: Point, subgroup: bool = False):
        if not self.e.g1.is_on_curve(P):
            raise SerializationError("point not on curve")
        if (subgroup or self.spec.h1 != 1) and self.e.g1.mul(P, self.spec.r) is not None:
            raise SerializationError("point not in the r-torsion subgroup")

    def _sgn0_fp2(self, y: Tuple[int, int]) -> int:
        """miracl-core FP2.sign(): parity of re, or of im when re == 0."""
        return (y[0] & 1) if y[0] != 0 else (y[1] & 1)

    def _miracl_g2(self, P: Point, compressed: bool) -> bytes:
        """miracl-core ECP2.ToBytes: 0x04 | xa|xb|ya|yb (129 B) uncompressed,
        (0x02 | sgn0(y)) | xa|xb (65 B) compressed (fp256bn_miracl.go:118-125).
        Infinity follows miracl's affine-of-infinity convention (x=0, y=1)."""
        n = self.n
        if P is None:
            x, y = (0, 0), (1, 0)
        else:
            x, y = P
        if compressed:
            return bytes([0x02 | self._sgn0_fp2(y)]) + _fp_to(x[0], n) + _fp_to(x[1], n)
        return (
            bytes([0x04])
            + _fp_to(x[0], n)
            + _fp_to(x[1], n)
            + _fp_to(y[0], n)
            + _fp_to(y[1], n)
        )

    def _miracl_g2_from(self, b: bytes) -> Point:
        n, p = self.n, self.spec.p
        t = self.e.tw
        if len(b) == 4 * n + 1 and b[0] == 0x04:
            x = (_fp_from(b[1 : n + 1], p), _fp_from(b[n + 1 : 2 * n + 1], p))
            y = (_fp_from(b[2 * n + 1 : 3 * n + 1], p), _fp_from(b[3 * n + 1 :], p))
            if x == (0, 0) and y == (1, 0):
                return None  # miracl's infinity image
            P = (x, y)
            self._check_g2(P)
            return P
        if len(b) == 2 * n + 1 and b[0] in (0x02, 0x03):
            x = (_fp_from(b[1 : n + 1], p), _fp_from(b[n + 1 :], p))
            rhs = t.f2_add(t.f2_mul(t.f2_mul(x, x), x), self.spec.b2)
            y = t.f2_sqrt(rhs)
            if y is None:
                if x == (0, 0):
                    return None
                raise SerializationError("x not on twist curve")
            if self._sgn0_fp2(y) != (b[0] & 1):
                y = t.f2_neg(y)
            P = (x, y)
            self._check_g2(P)
            return P
        raise SerializationError("invalid MIRACL G2 encoding")

    # ---------------- G2 ----------------
    def g2_to_bytes(self, P: Point, compressed: bool) -> bytes:
        spec, n = self.spec, self.n
        if spec.ser_format == SerFormat.AMCL_MIRACL:
            return self._miracl_g2(P, compressed)
        if spec.ser_format == SerFormat.AMCL:
            # xa||xb||ya||yb, no compressed form (fp256bn.go:299-311)
            if P is None:
                return bytes(4 * n)
            (x0, x1), (y0, y1) = P
            return _fp_to(x0, n) + _fp_to(x1, n) + _fp_to(y0, n) + _fp_to(y1, n)
        zcash = spec.ser_format == SerFormat.ZCASH
        if not compressed:
            if P is None:
                if zcash:
                    return bytes([0x40]) + bytes(4 * n - 1)
                return bytes(4 * n)
            (x0, x1), (y0, y1) = P
            return _fp_to(x1, n) + _fp_to(x0, n) + _fp_to(y1, n) + _fp_to(y0, n)
        if P is None:
            return (bytes([0xC0]) if zcash else bytes([0x40])) + bytes(2 * n - 1)
        (x0, x1), y = P
        out = bytearray(_fp_to(x1, n) + _fp_to(x0, n))
        if zcash:
            out[0] |= 0x80
            if _lex_larger_fp2(y, spec.p):
                out[0] |= 0x20
        else:
            out[0] |= 0xC0 if _lex_larger_fp2(y, spec.p) else 0x80
        return bytes(out)

    def g2_from_bytes(self, b: bytes, compressed: Optional[bool] = None) -> Point:
        if b is None:
            raise SerializationError("nil input")
        b = bytes(b)
        spec, n, p = self.spec, self.n, self.spec.p
        if spec.ser_format == SerFormat.AMCL_MIRACL:
            return self._miracl_g2_from(b)
        if spec.ser_format == SerFormat.AMCL:
            if len(b) != 4 * n:
                raise SerializationError("invalid AMCL G2 encoding")
            if not any(b):
                return None
            x = (_fp_from(b[:n], p), _fp_from(b[n : 2 * n], p))
            y = (_fp_from(b[2 * n : 3 * n], p), _fp_from(b[3 * n :], p))
            P = (x, y)
            self._check_g2(P)
            return P
        zcash = spec.ser_format == SerFormat.ZCASH
        if len(b) == 4 * n:
            if zcash:
                if b[0] & 0x80:
                    raise SerializationError("compression flag set")
                if b[0] & 0x40:
                    if (b[0] & 0x3F) or any(b[1:]):
                        raise SerializationError("malformed infinity")
                    return None
                x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:n], "big")
            else:
                if b[0] & 0xC0:
                    raise SerializationError("unexpected flags")
                if not any(b):
                    return None
                x1 = _fp_from(b[:n], p)
            if x1 >= p:
                raise SerializationError("coordinate out of range")
            x0 = _fp_from(b[n : 2 * n], p)
            y1 = _fp_from(b[2 * n : 3 * n], p)
            y0 = _fp_from(b[3 * n :], p)
            P = ((x0, x1), (y0, y1))
            self._check_g2(P)
            return P
        if len(b) == 2 * n:
            if zcash:
                if not b[0] & 0x80:
                    raise SerializationError("compression flag missing")
                if b[0] & 0x40:
                    if (b[0] & 0x3F) or any(b[1:]):
                        raise SerializationError("malformed infinity")
                    return None
                larger = bool(b[0] & 0x20)
                x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:n], "big")
            else:
                flags = (b[0] & 0xC0) >> 6
                if flags == 0b01:
                    if (b[0] & 0x3F) or any(b[1:]):
                        raise SerializationError("malformed infinity")
                    return None
                if flags not in (0b10, 0b11):
                    raise SerializationError("compression flag missing")
                larger = flags == 0b11
                x1 = int.from_bytes(bytes([b[0] & 0x3F]) + b[1:n], "big")
            if x1 >= p:
                raise SerializationError("coordinate out of range")
            x0 = _fp_from(b[n:], p)
            x = (x0, x1)
            t = self.e.tw
            rhs = t.f2_add(t.f2_mul(t.f2_mul(x, x), x), self.spec.b2)
            y = t.f2_sqrt(rhs)
            if y is None:
                raise SerializationError("x not on twist curve")
            if _lex_larger_fp2(y, p) != larger:
                y = t.f2_neg(y)
            P = (x, y)
            self._check_g2(P, subgroup=True)
            return P
        raise SerializationError(f"invalid G2 encoding length {len(b)}")

    def _check_g2(self, P: Point, subgroup: bool = True):
        if not self.e.g2.is_on_curve(P):
            raise SerializationError("point not on twist curve")
        if subgroup and self.e.g2.mul(P, self.spec.r) is not None:
            raise SerializationError("point not in the r-torsion subgroup")

    # ---------------- Gt ----------------
    def gt_to_bytes(self, a: Fp12) -> bytes:
        n = self.n
        coeffs = self._gt_coeff_order(a)
        return b"".join(_fp_to(c, n) for c in coeffs)

    def gt_from_bytes(self, b: bytes) -> Fp12:
        if b is None:
            raise SerializationError("nil input")
        b = bytes(b)
        n = self.n
        if len(b) != 12 * n:
            raise SerializationError(f"invalid Gt encoding length {len(b)}")
        vals = [_fp_from(b[i * n : (i + 1) * n], self.spec.p) for i in range(12)]
        return self._gt_from_coeffs(vals)

    def _gt_coeff_order(self, a: Fp12):
        (c0, c1) = a
        if self.spec.ser_format in (SerFormat.AMCL, SerFormat.AMCL_MIRACL):
            # AMCL Fp4 tower, ascending (see module docstring): the w-power
            # basis maps my (e*, f*) coefficients onto AMCL (a,b,c) FP4s.
            e0, e1, e2 = c0
            f0, f1, f2 = c1
            # a=(e0,f1), b=(f0,e2), c=(e1,f2), each FP4 = (fp2, fp2) ascending
            quads = [(e0, f1), (f0, e2), (e1, f2)]
            out = []
            for (lo, hi) in quads:
                out += [lo[0], lo[1], hi[0], hi[1]]
            return out
        # kilic/gnark: descending C1.B2.A1 ... C0.B0.A0
        out = []
        for six in (c1, c0):
            for duo in reversed(six):
                out += [duo[1], duo[0]]
        return out

    def _gt_from_coeffs(self, vals) -> Fp12:
        if self.spec.ser_format in (SerFormat.AMCL, SerFormat.AMCL_MIRACL):
            (aa0, aa1, ab0, ab1, ba0, ba1, bb0, bb1, ca0, ca1, cb0, cb1) = vals
            e0, f1 = (aa0, aa1), (ab0, ab1)
            f0, e2 = (ba0, ba1), (bb0, bb1)
            e1, f2 = (ca0, ca1), (cb0, cb1)
            return ((e0, e1, e2), (f0, f1, f2))
        c1 = tuple(reversed([(vals[2 * i + 1], vals[2 * i]) for i in range(3)]))
        c0 = tuple(reversed([(vals[2 * i + 7], vals[2 * i + 6]) for i in range(3)]))
        return (c0, c1)
