"""mathlib-compatible public API: the port of ``mathlib_tpu/api.py``.

Drop-in equivalent of the upstream L4 surface (math.go): a `Curves`
registry indexed by `CurveID`, wrapper types Zr/G1/G2/Gt carrying curve
provenance, the full ~60-method operation surface, and the JSON envelope
(marshaler.go). Semantics follow the reference backends:

  * Zr is lazily reduced, exactly like driver/common/big.go BaseZr:
    Plus/Minus do NOT reduce; Bytes()/Mod canonicalize; Equals compares the
    raw integer values; String() is hex of the raw value.
  * In-place vs value-returning methods match math.go:307-499
    (Add/Sub/Neg/Mod/InvModP/InvModOrder/Clone/Mul2InPlace mutate;
    Mul/Plus/Minus/PowMod/Exp/Copy/Mul2 return fresh values).
  * FExp is the identity for the kilic-backed curve IDs because their
    Pairing already includes the final exponentiation
    (driver/kilic/bls12-381.go:260-281); the gurvy/amcl-backed IDs defer it.
  * HashToG2 raises for the FP256BN IDs (driver/amcl/fp256bn.go:180-186).

A `Curve` resolves its device once (``mathlib_tpu_torch.device``): the
card unless the caller passes ``device="cpu"``; without a card, building a
card `Curve` raises.  `Curves` is the card's registry, ``curves("cpu")`` the
CPU's.  MultiScalarMul over 64 or more points runs ``msm_host_bridge`` on
that device (the port's G1 kernels on the card; a curve they refuse raises
their error, nothing falls back to the host); everything else (scalar ops,
the group law, Pairing, Pairing2, FExp, Gt.Exp, hashing) runs on the exact
host engine, as in the reference.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmaclib
import json
import secrets
from typing import Sequence

from . import device as _device
from .curves.params import CURVE_ID_SPEC, CurveID, CurveSpec, get_spec
from .host import HostEngine, get_engine
from .host.hash_to_curve import Hasher, get_hasher
from .host.serialize import (
    Codec,
    SerializationError,
    zr_from_bytes,
    zr_to_bytes,
)

__all__ = [
    "CurveID",
    "Curves",
    "Curve",
    "Zr",
    "G1",
    "G2",
    "Gt",
    "CurveIDToString",
    "SerializationError",
    "curves",
]


def CurveIDToString(cid: CurveID) -> str:
    return CurveID(cid).name


_KILIC_IDS = {CurveID.BLS12_381, CurveID.BLS12_381_BBS}
_BBS_IDS = {CurveID.BLS12_381_BBS, CurveID.BLS12_381_BBS_GURVY}
_FP256_IDS = {CurveID.FP256BN_AMCL, CurveID.FP256BN_AMCL_MIRACL}


class Zr:
    """Scalar field element with BaseZr (lazy) semantics."""

    __slots__ = ("value", "curve_id", "_modulus")

    def __init__(self, value: int, curve_id: CurveID):
        self.value = value
        self.curve_id = CurveID(curve_id)
        self._modulus = get_spec(CURVE_ID_SPEC[self.curve_id]).r

    # -- provenance
    def CurveID(self) -> CurveID:
        return self.curve_id

    # -- predicates (raw-value semantics, big.go:46-54)
    def IsZero(self) -> bool:
        return self.value == 0

    def IsOne(self) -> bool:
        return self.value == 1

    def BigInt(self) -> int:
        return self.value

    # -- value-returning arithmetic
    def Plus(self, a: "Zr") -> "Zr":
        return Zr(self.value + a.value, self.curve_id)

    def Minus(self, a: "Zr") -> "Zr":
        return Zr(self.value - a.value, self.curve_id)

    def Mul(self, a: "Zr") -> "Zr":
        return Zr(self.value * a.value % self._modulus, self.curve_id)

    def PowMod(self, x: "Zr") -> "Zr":
        return Zr(pow(self.value, x.value, self._modulus), self.curve_id)

    def Copy(self) -> "Zr":
        return Zr(self.value, self.curve_id)

    # -- mutating ops
    def Mod(self, a: "Zr") -> None:
        self.value %= a.value

    def InvModP(self, p: "Zr") -> None:
        self.value = pow(self.value, -1, p.value)

    def InvModOrder(self) -> None:
        self.value = pow(self.value, -1, self._modulus)

    def Clone(self, a: "Zr") -> None:
        # reference Clone round-trips through |a|'s magnitude bytes
        # (driver/common/big.go:126-129)
        self.value = abs(a.value)

    def Neg(self) -> None:
        self.value = -self.value

    # -- codec
    def Bytes(self) -> bytes:
        return zr_to_bytes(self.value, self._modulus)

    def Equals(self, a: "Zr") -> bool:
        return self.value == a.value

    def __eq__(self, other):
        return isinstance(other, Zr) and self.Equals(other)

    def __str__(self) -> str:
        v = self.value
        return format(v, "x") if v >= 0 else "-" + format(-v, "x")

    String = __str__

    def Uint(self) -> int:
        """math.go:376-385: error unless top 24 bytes are all-0 or all-1."""
        b = self.Bytes()
        if b[:24] != b"\x00" * 24 and b[:24] != b"\xff" * 24:
            raise ValueError("out of range")
        return int.from_bytes(b[24:], "big")

    def Int(self) -> int:
        u = self.Uint()
        return u - (1 << 64) if u >= (1 << 63) else u

    # -- JSON envelope (marshaler.go:16-34)
    def MarshalJSON(self) -> bytes:
        return _marshal_element(self.curve_id, self.Bytes())

    @staticmethod
    def UnmarshalJSON(raw: bytes, device=None) -> "Zr":
        cid, elt = _unmarshal_element(raw)
        return curves(device)[cid].NewZrFromBytes(elt)


class _Element:
    """What G1, G2 and Gt share: the curve ID, and the `Curve` (and so the
    device) that made the element; the card's `Curve` when none is given."""

    __slots__ = ("curve_id", "_curve")

    def CurveID(self) -> CurveID:
        return self.curve_id

    def _c(self) -> "Curve":
        if self._curve is None:
            self._curve = _curve(self.curve_id, None)
        return self._curve


class G1(_Element):
    __slots__ = ("point",)

    def __init__(self, point, curve_id: CurveID, curve: "Curve" = None):
        self.point = point  # affine (x, y) or None
        self.curve_id = CurveID(curve_id)
        self._curve = curve

    def Clone(self, a: "G1") -> None:
        self.point = a.point

    def Copy(self) -> "G1":
        return G1(self.point, self.curve_id, self._curve)

    def Add(self, a: "G1") -> None:
        self.point = self._c().engine.g1.add(self.point, a.point)

    def Sub(self, a: "G1") -> None:
        self.point = self._c().engine.g1.sub(self.point, a.point)

    def Mul(self, a: Zr) -> "G1":
        c = self._c()
        return G1(c.engine.g1.mul(self.point, a.value % c.spec.r), self.curve_id, c)

    def Mul2(self, e: Zr, Q: "G1", f: Zr) -> "G1":
        c = self._c()
        r = c.spec.r
        return G1(
            c.engine.g1.mul2(self.point, e.value % r, Q.point, f.value % r),
            self.curve_id,
            c,
        )

    def Mul2InPlace(self, e: Zr, Q: "G1", f: Zr) -> None:
        self.point = self.Mul2(e, Q, f).point

    def Equals(self, a: "G1") -> bool:
        return self.point == a.point

    __eq__ = lambda self, o: isinstance(o, G1) and self.Equals(o)  # noqa: E731

    def IsInfinity(self) -> bool:
        return self.point is None

    def Neg(self) -> None:
        self.point = self._c().engine.g1.neg(self.point)

    def Bytes(self) -> bytes:
        return self._c().codec.g1_to_bytes(self.point, compressed=False)

    def Compressed(self) -> bytes:
        return self._c().codec.g1_to_bytes(self.point, compressed=True)

    def __str__(self) -> str:
        if self.point is None:
            return "(0,0)" if self.curve_id not in _FP256_IDS else "infinity"
        x, y = self.point
        if self.curve_id in _FP256_IDS:
            # AMCL prints hex, left-trimmed (amcl/fp256bn.go:248-255)
            return f"({format(x, 'x').lstrip('0')},{format(y, 'x').lstrip('0')})"
        return f"({x},{y})"

    String = __str__

    def MarshalJSON(self) -> bytes:
        return _marshal_element(self.curve_id, self.Bytes())

    @staticmethod
    def UnmarshalJSON(raw: bytes, device=None) -> "G1":
        cid, elt = _unmarshal_element(raw)
        p, err = curves(device)[cid].NewG1FromBytes(elt)
        if err is not None:
            raise err
        return p


class G2(_Element):
    __slots__ = ("point",)

    def __init__(self, point, curve_id: CurveID, curve: "Curve" = None):
        self.point = point
        self.curve_id = CurveID(curve_id)
        self._curve = curve

    def Clone(self, a: "G2") -> None:
        self.point = a.point

    def Copy(self) -> "G2":
        return G2(self.point, self.curve_id, self._curve)

    def Add(self, a: "G2") -> None:
        self.point = self._c().engine.g2.add(self.point, a.point)

    def Sub(self, a: "G2") -> None:
        self.point = self._c().engine.g2.sub(self.point, a.point)

    def Mul(self, a: Zr) -> "G2":
        c = self._c()
        return G2(c.engine.g2.mul(self.point, a.value % c.spec.r), self.curve_id, c)

    def Affine(self) -> None:
        pass  # host points are always affine

    def Equals(self, a: "G2") -> bool:
        return self.point == a.point

    __eq__ = lambda self, o: isinstance(o, G2) and self.Equals(o)  # noqa: E731

    def Bytes(self) -> bytes:
        return self._c().codec.g2_to_bytes(self.point, compressed=False)

    def Compressed(self) -> bytes:
        return self._c().codec.g2_to_bytes(self.point, compressed=True)

    def __str__(self) -> str:
        # the reference's default BLS12-381 backend returns "" here
        # (kilic/bls12-381.go:166-169, an upstream FIXME); match it for the
        # kilic-backed IDs and give the informative coordinate tuple on the
        # others (whose reference formats are backend-specific anyway)
        if self.curve_id in _KILIC_IDS:
            return ""
        return "" if self.point is None else str(self.point)

    String = __str__

    def MarshalJSON(self) -> bytes:
        return _marshal_element(self.curve_id, self.Bytes())

    @staticmethod
    def UnmarshalJSON(raw: bytes, device=None) -> "G2":
        cid, elt = _unmarshal_element(raw)
        p, err = curves(device)[cid].NewG2FromBytes(elt)
        if err is not None:
            raise err
        return p


class Gt(_Element):
    __slots__ = ("val",)

    def __init__(self, val, curve_id: CurveID, curve: "Curve" = None):
        self.val = val  # host Fp12
        self.curve_id = CurveID(curve_id)
        self._curve = curve

    def Equals(self, a: "Gt") -> bool:
        return self.val == a.val

    __eq__ = lambda self, o: isinstance(o, Gt) and self.Equals(o)  # noqa: E731

    def Inverse(self) -> None:
        self.val = self._c().engine.gt_inv(self.val)

    def Mul(self, a: "Gt") -> None:
        self.val = self._c().engine.gt_mul(self.val, a.val)

    def Exp(self, x: Zr) -> "Gt":
        c = self._c()
        return Gt(c.engine.gt_exp(self.val, x.value), self.curve_id, c)

    def IsUnity(self) -> bool:
        return self._c().engine.gt_is_one(self.val)

    def __str__(self) -> str:
        return ""  # matches kilic's unimplemented ToString

    String = __str__

    def Bytes(self) -> bytes:
        return self._c().codec.gt_to_bytes(self.val)

    def MarshalJSON(self) -> bytes:
        return _marshal_element(self.curve_id, self.Bytes())

    @staticmethod
    def UnmarshalJSON(raw: bytes, device=None) -> "Gt":
        cid, elt = _unmarshal_element(raw)
        p, err = curves(device)[cid].NewGtFromBytes(elt)
        if err is not None:
            raise err
        return p


class Curve:
    def __init__(self, curve_id: CurveID, device=None):
        self.curve_id = CurveID(curve_id)
        self.device = _device(device)
        self.spec: CurveSpec = get_spec(CURVE_ID_SPEC[self.curve_id])
        self.engine: HostEngine = get_engine(self.spec)
        self.codec = Codec(self.spec, self.engine)
        self.hasher: Hasher = get_hasher(self.spec)

        self.GenG1 = G1(self.spec.g1_gen, self.curve_id, self)
        self.GenG2 = G2(self.spec.g2_gen, self.curve_id, self)
        self.GenGt = Gt(self.engine.gen_gt(), self.curve_id, self)
        self.GroupOrder = Zr(self.spec.r, self.curve_id)
        self.CoordByteSize = self.spec.fp_bytes
        self.G1ByteSize = self.spec.g1_uncompressed_size
        self.CompressedG1ByteSize = self.spec.g1_compressed_size
        self.G2ByteSize = self.spec.g2_uncompressed_size
        self.CompressedG2ByteSize = self.spec.g2_compressed_size
        self.ScalarByteSize = self.spec.scalar_bytes

    def ID(self) -> CurveID:
        return self.curve_id

    # -- randomness ---------------------------------------------------------
    def Rand(self):
        return secrets.SystemRandom()

    def NewRandomZr(self, rng) -> Zr:
        return Zr(rng.randrange(self.spec.r), self.curve_id)

    # -- constructors ---------------------------------------------------------
    def NewZrFromBytes(self, b: bytes) -> Zr:
        return Zr(zr_from_bytes(b), self.curve_id)

    def NewZrFromInt(self, i: int) -> Zr:
        return Zr(int(i), self.curve_id)

    NewZrFromInt64 = NewZrFromInt
    NewZrFromUint64 = NewZrFromInt
    NewZrFromBigInt = NewZrFromInt

    def NewG1(self) -> G1:
        return G1(None, self.curve_id, self)

    def NewG2(self) -> G2:
        return G2(None, self.curve_id, self)

    def _recover(self, fn):
        """Reference converts constructor panics to errors (math.go:761-832);
        we return (value, error) pairs the same way."""
        try:
            return fn(), None
        except Exception as ex:  # noqa: BLE001
            return None, SerializationError(f"failure [{ex}]")

    def NewG1FromBytes(self, b):
        return self._recover(lambda: G1(self.codec.g1_from_bytes(b), self.curve_id, self))

    def NewG2FromBytes(self, b):
        return self._recover(lambda: G2(self.codec.g2_from_bytes(b), self.curve_id, self))

    def NewG1FromCompressed(self, b):
        return self._recover(lambda: G1(self.codec.g1_from_bytes(b), self.curve_id, self))

    def NewG2FromCompressed(self, b):
        return self._recover(lambda: G2(self.codec.g2_from_bytes(b), self.curve_id, self))

    def NewGtFromBytes(self, b):
        return self._recover(lambda: Gt(self.codec.gt_from_bytes(b), self.curve_id, self))

    # -- pairing ----------------------------------------------------------------
    # For non-kilic IDs Pairing returns the UNREDUCED Miller value; as in
    # the reference (kilic pre-reduces, gurvy/amcl do not — SURVEY.md
    # appendix), an unreduced Gt is an engine-specific representative and
    # only FExp(...) yields the canonical value.  The native engine's
    # sparse-line Miller loop differs from the Python oracle's textbook
    # value pre-FExp by subfield factors the final exponentiation kills.
    def Pairing(self, a: G2, b: G1) -> Gt:
        reduce = self.curve_id in _KILIC_IDS
        f = self.engine.miller_loop([(b.point, a.point)])
        if reduce:
            f = self.engine.final_exp(f)
        return Gt(f, self.curve_id, self)

    def Pairing2(self, p: G2, q: G1, r: G2, s: G1) -> Gt:
        reduce = self.curve_id in _KILIC_IDS
        f = self.engine.miller_loop([(q.point, p.point), (s.point, r.point)])
        if reduce:
            f = self.engine.final_exp(f)
        return Gt(f, self.curve_id, self)

    def FExp(self, a: Gt) -> Gt:
        if self.curve_id in _KILIC_IDS:
            return Gt(a.val, self.curve_id, self)  # kilic: already reduced, identity
        return Gt(self.engine.final_exp(a.val), self.curve_id, self)

    # -- hashing ----------------------------------------------------------------
    def HashToZr(self, data: bytes) -> Zr:
        digest = hashlib.sha256(bytes(data)).digest()
        return Zr(int.from_bytes(digest, "big") % self.spec.r, self.curve_id)

    def HashToG1(self, data: bytes) -> G1:
        if self.curve_id == CurveID.FP256BN_AMCL:
            # distinct entry point: Bls_hash directly, NO HMAC
            # (fp256bn.go:169-171); HashToG1WithDomain always HMACs, even
            # with an empty domain (HMAC with empty key != identity)
            return G1(self.hasher.amcl_bls_hash(bytes(data)), self.curve_id, self)
        return self.HashToG1WithDomain(data, b"")

    def HashToG1WithDomain(self, data: bytes, domain: bytes) -> G1:
        data, domain = bytes(data), bytes(domain)
        if self.curve_id in _BBS_IDS:
            p = self.hasher.hash_to_g1_bbs(data, domain)
        elif self.curve_id == CurveID.FP256BN_AMCL:
            # legacy: unconditional HMAC-SHA256 domain separation then
            # Bls_hash (fp256bn.go:173-178)
            data = hmaclib.new(domain, data, hashlib.sha256).digest()
            p = self.hasher.amcl_bls_hash(data)
        else:
            # miracl-core path for FP256BN_AMCL_MIRACL: hash_to_field
            # (XMD:SHA-256, L=48, ctr=2) + map2point + Cfp
            # (driver/amcl/custom.go:19-32); RFC path for the gurvy curves.
            p = self.hasher.hash_to_g1(data, domain)
        return G1(p, self.curve_id, self)

    def HashToG2(self, data: bytes) -> G2:
        return self.HashToG2WithDomain(data, b"")

    def HashToG2WithDomain(self, data: bytes, domain: bytes) -> G2:
        if self.curve_id in _FP256_IDS:
            raise RuntimeError("HashToG2 is not available for this curve")
        return G2(self.hasher.hash_to_g2(bytes(data), bytes(domain)), self.curve_id, self)

    # -- modular helper surface (math.go:908-987) --------------------------------
    def ModAdd(self, a: Zr, b: Zr, m: Zr) -> Zr:
        return Zr((a.value + b.value) % m.value, self.curve_id)

    def ModSub(self, a: Zr, b: Zr, m: Zr) -> Zr:
        return Zr((a.value - b.value) % m.value, self.curve_id)

    def ModMul(self, a: Zr, b: Zr, m: Zr) -> Zr:
        return Zr(a.value * b.value % m.value, self.curve_id)

    def ModNeg(self, a: Zr, m: Zr) -> Zr:
        return Zr((m.value - a.value) % m.value, self.curve_id)

    def ModAddMul(self, a: Sequence[Zr], b: Sequence[Zr], m: Zr) -> Zr:
        acc = 0
        for x, y in zip(a, b):
            acc = (acc + x.value * y.value) % m.value
        return Zr(acc, self.curve_id)

    def ModAddMul2(self, a1, a2, b1, b2, m) -> Zr:
        return Zr((a1.value * a2.value + b1.value * b2.value) % m.value, self.curve_id)

    def ModAddMul3(self, a1, a2, b1, b2, c1, c2, m) -> Zr:
        return Zr(
            (a1.value * a2.value + b1.value * b2.value + c1.value * c2.value)
            % m.value,
            self.curve_id,
        )

    def ModMulInPlace(self, result: Zr, a: Zr, b: Zr, m: Zr) -> None:
        result.value = a.value * b.value % m.value

    def ModAddMul2InPlace(self, result, a1, c1, b1, c2, m) -> None:
        result.value = (a1.value * c1.value + b1.value * c2.value) % m.value

    def ModAddMul3InPlace(self, result, a1, a2, b1, b2, c1, c2, m) -> None:
        result.value = (
            a1.value * a2.value + b1.value * b2.value + c1.value * c2.value
        ) % m.value

    # -- MSM ---------------------------------------------------------------------
    def MultiScalarMul(self, a: Sequence[G1], b: Sequence[Zr]) -> G1:
        if len(a) != len(b):
            raise ValueError("point/scalar length mismatch")
        r = self.spec.r
        points = [g.point for g in a]
        scalars = [z.value % r for z in b]
        if len(points) >= 64:
            # the bridge on this curve's device: the G1 kernels on the card
            from .ops.msm import msm_host_bridge

            return G1(msm_host_bridge(self.spec, points, scalars, device=self.device),
                      self.curve_id, self)
        return G1(self.engine.g1.msm(points, scalars), self.curve_id, self)


# ---------------------------------------------------------------------------
# JSON envelope helpers (marshaler.go:11-14; Go encodes []byte as base64)
# ---------------------------------------------------------------------------


def _marshal_element(cid: CurveID, b: bytes) -> bytes:
    return json.dumps(
        {"curve": int(cid), "element": base64.b64encode(b).decode()},
        separators=(",", ":"),
    ).encode()


def _unmarshal_element(raw) -> tuple:
    d = json.loads(raw)
    elt = d.get("element")
    if not isinstance(elt, str):
        raise SerializationError(
            "json: cannot unmarshal number into Go struct field "
            "curveElement.element of type []uint8"
        )
    return CurveID(d.get("curve", 0)), base64.b64decode(elt)


_CURVES: dict = {}


def _curve(cid: CurveID, device) -> Curve:
    """One `Curve` per curve ID and device (``device`` resolved here)."""
    key = (CurveID(cid), _device(device))
    c = _CURVES.get(key)
    if c is None:
        c = _CURVES[key] = Curve(key[0], key[1])
    return c


class _CurveRegistry:
    """Lazily-instantiated equivalent of the upstream `Curves` slice
    (math.go:142-255; upstream eagerly builds all 8 at import, which
    costs a pairing per curve — we defer until first use), bound to one
    device: the card unless ``"cpu"`` is asked for, resolved at each use."""

    def __init__(self, device=None):
        self.device = device

    def __getitem__(self, cid) -> Curve:
        return _curve(CurveID(cid), self.device)

    def __len__(self) -> int:
        return len(CurveID)

    def __iter__(self):
        return (self[cid] for cid in CurveID)


def curves(device=None) -> _CurveRegistry:
    """The `Curves` registry on ``device`` (``"cpu"`` by name; the card by
    default)."""
    return _CurveRegistry(device)


Curves = _CurveRegistry()
