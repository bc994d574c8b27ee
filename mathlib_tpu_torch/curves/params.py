"""Curve parameter specs (the port's own copy of ``mathlib_tpu/curves/params.py``).

The PyTorch port keeps its own copy of the curve constants so that it never
imports the JAX package.  ``tests/test_torch_host.py`` holds every field of
every spec here equal to the reference's, the wire format (``SerFormat``,
read by ``host/serialize.py``) and the serialized sizes (read by ``api.py``)
included.  The curve-ID registry (``CurveID``, ``CURVE_ID_SPEC``) is the
API's and ``BatchEngine.for_curve``'s.  ``FP256BN_MIRACL`` is ``FP256BN``
under the miracl-core wire format.

Four curves, all derived from the family polynomials and the group orders
pinned by the upstream IBM/mathlib test suite (math_test.go:261-270):

  BLS12: r(x) = x^4 - x^2 + 1,            p(x) = (x-1)^2 r(x)/3 + x,  t = x+1
  BN:    r(u) = 36u^4 + 36u^3 + 18u^2 + 6u + 1,  p(u) = r(u) + 6u^2,  t = 6u^2+1

The sextic-twist choice (M vs D) and the G2 cofactor are determined
computationally at spec-build time by finding which twist has order divisible
by r (see _twist_orders / _build_g2_side below).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache
from math import isqrt
from typing import Optional, Tuple

Fp2Int = Tuple[int, int]  # c0 + c1*u over host ints


class Family(enum.Enum):
    BLS12 = "bls12"
    BN = "bn"


class SerFormat(enum.Enum):
    """Wire formats of the upstream backends (see host/serialize.py)."""

    ZCASH = "zcash"  # BLS12-381: 3 flag bits in MSB of x (kilic & gnark agree)
    GNARK = "gnark"  # BN254 / BLS12-377: gnark 2-bit flag scheme
    AMCL = "amcl"  # FP256BN legacy: 0x04/0x02/0x03 G1 prefix, bare 128-B G2
    AMCL_MIRACL = "amcl_miracl"  # FP256BN miracl-core: prefixed G2, 129/65 B


@dataclass(frozen=True)
class CurveSpec:
    name: str
    family: Family
    x: int  # BLS parameter x / BN parameter u (signed)
    p: int  # base field modulus
    r: int  # subgroup order (scalar field modulus)
    b: int  # G1: y^2 = x^3 + b
    beta: int  # Fp2 = Fp[u]/(u^2 - beta); beta is a non-residue (as int mod p)
    xi: Fp2Int  # Fp6 = Fp2[v]/(v^3 - xi); Fp12 = Fp6[w]/(w^2 - v)
    twist: str  # 'M' (b2 = b*xi) or 'D' (b2 = b/xi)
    b2: Fp2Int  # G2 twist curve constant
    h1: int  # G1 cofactor  (#E(Fp)  = h1 * r)
    h2: int  # G2 cofactor  (#E'(Fp2) = h2 * r)
    t: int  # trace of Frobenius over Fp
    g1_gen: Tuple[int, int]
    g2_gen: Tuple[Fp2Int, Fp2Int]
    fp_bytes: int  # size of one Fp coordinate on the wire
    ser_format: SerFormat
    # final-exponentiation hard-part multiplier: the de-facto wire convention
    # is Gt = f^(easy * fexp_factor * (p^4 - p^2 + 1)/r). BLS12 backends use the
    # Hayashida-Hayasaka-Teruya chain (factor 3, eprint 2020/875); gnark's BN254
    # uses the Fuentes-Castaneda variant (factor 2x(6x^2+3x+1)); AMCL FP256BN
    # computes the exact hard part (factor 1).
    fexp_factor: int = 1
    g2_derived: bool = False  # True if g2_gen was derived (no published pin)

    # ---- derived helpers -------------------------------------------------
    @property
    def hard_part_exp(self) -> int:
        """Hard part of the final exponentiation (includes convention factor)."""
        assert (self.p**4 - self.p**2 + 1) % self.r == 0
        return self.fexp_factor * ((self.p**4 - self.p**2 + 1) // self.r)

    @property
    def easy_exp(self) -> int:
        return (self.p**6 - 1) * (self.p**2 + 1)

    @property
    def final_exp(self) -> int:
        return self.easy_exp * self.hard_part_exp

    @property
    def _amcl_like(self) -> bool:
        return self.ser_format in (SerFormat.AMCL, SerFormat.AMCL_MIRACL)

    @property
    def g1_uncompressed_size(self) -> int:
        return 2 * self.fp_bytes + (1 if self._amcl_like else 0)

    @property
    def g1_compressed_size(self) -> int:
        return self.fp_bytes + (1 if self._amcl_like else 0)

    @property
    def g2_uncompressed_size(self) -> int:
        if self.ser_format == SerFormat.AMCL_MIRACL:
            return 4 * self.fp_bytes + 1  # fp256bn_miracl.go:118-121
        return 4 * self.fp_bytes

    @property
    def g2_compressed_size(self) -> int:
        if self.ser_format == SerFormat.AMCL:
            return 4 * self.fp_bytes  # AMCL has no compressed G2 (fp256bn.go:119-121)
        if self.ser_format == SerFormat.AMCL_MIRACL:
            return 2 * self.fp_bytes + 1  # fp256bn_miracl.go:123-125
        return 2 * self.fp_bytes

    @property
    def gt_size(self) -> int:
        return 12 * self.fp_bytes

    @property
    def scalar_bytes(self) -> int:
        return 32  # driver/common/big.go:23


def hard_part_digits(spec) -> Tuple[int, ...]:
    """The base-p digits of ``spec.hard_part_exp``, lowest first."""
    digits, e = [], spec.hard_part_exp
    while e:
        digits.append(e % spec.p)
        e //= spec.p
    return tuple(digits)


# ---------------------------------------------------------------------------
# family polynomial constructions
# ---------------------------------------------------------------------------


def _bls12_pr(x: int) -> Tuple[int, int, int]:
    r = x**4 - x**2 + 1
    num = (x - 1) ** 2 * r + 3 * x
    assert num % 3 == 0
    return num // 3, r, x + 1


def _bn_pr(u: int) -> Tuple[int, int, int]:
    r = 36 * u**4 + 36 * u**3 + 18 * u**2 + 6 * u + 1
    p = r + 6 * u**2
    return p, r, 6 * u**2 + 1


def _twist_orders(p: int, t: int) -> Tuple[int, int]:
    """The two possible orders of a sextic twist of E over Fp2.

    With t2 = t^2 - 2p and 4p^2 = t2^2 + 3f^2, the sextic twists of E(Fp2)
    have orders p^2 + 1 - (-3f + t2)/2 and p^2 + 1 - (3f + t2)/2.
    """
    t2 = t * t - 2 * p
    f2 = (4 * p * p - t2 * t2) // 3
    f = isqrt(f2)
    assert f * f == f2, "trace discriminant is not a perfect square"
    assert (t2 + 3 * f) % 2 == 0
    return (p * p + 1 - (t2 + 3 * f) // 2, p * p + 1 - (t2 - 3 * f) // 2)


# ---------------------------------------------------------------------------
# minimal host Fp2/curve arithmetic needed for spec construction
# (full towers live in mathlib_tpu.host.fields)
# ---------------------------------------------------------------------------


def _f2_mul(a: Fp2Int, b: Fp2Int, p: int, beta: int) -> Fp2Int:
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + beta * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)


def _f2_inv(a: Fp2Int, p: int, beta: int) -> Fp2Int:
    a0, a1 = a
    norm = (a0 * a0 - beta * a1 * a1) % p
    ninv = pow(norm, -1, p) if norm else 0  # = norm^(p-2): Euclid, ~10x faster
    return (a0 * ninv % p, (-a1 * ninv) % p)


def _f2_sqrt(a: Fp2Int, p: int, beta: int) -> Optional[Fp2Int]:
    """Square root in Fp2 via the complex method (works for any p odd)."""
    a0, a1 = a
    if a1 == 0:
        # sqrt of base-field element inside Fp2
        s = _fp_sqrt(a0, p)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue in Fp: sqrt lies on the u-axis: (x*u)^2 = beta x^2
        t = _fp_sqrt(a0 * pow(beta, p - 2, p) % p, p)
        return None if t is None else (0, t)
    # norm must be a QR in Fp
    n = (a0 * a0 - beta * a1 * a1) % p
    sn = _fp_sqrt(n, p)
    if sn is None:
        return None
    inv2 = pow(2, p - 2, p)
    for s in (sn, (-sn) % p):
        x0sq = (a0 + s) * inv2 % p
        x0 = _fp_sqrt(x0sq, p)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * inv2 % p * pow(x0, p - 2, p) % p
        if _f2_mul((x0, x1), (x0, x1), p, beta) == (a0 % p, a1 % p):
            return (x0, x1)
    return None


def _fp_sqrt(a: int, p: int) -> Optional[int]:
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks (needed for BLS12-377 where p % 4 == 1)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, rres = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, rres = t * c % p, rres * b % p
    return rres


def _g2_add(P, Q, p, beta, b2):
    """Affine addition on the twist curve y^2 = x^3 + b2 over Fp2."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if (y1[0] + y2[0]) % p == 0 and (y1[1] + y2[1]) % p == 0:
            return None
        num = _f2_mul((3, 0), _f2_mul(x1, x1, p, beta), p, beta)
        den = _f2_mul((2, 0), y1, p, beta)
    else:
        num = ((y2[0] - y1[0]) % p, (y2[1] - y1[1]) % p)
        den = ((x2[0] - x1[0]) % p, (x2[1] - x1[1]) % p)
    lam = _f2_mul(num, _f2_inv(den, p, beta), p, beta)
    x3 = _f2_mul(lam, lam, p, beta)
    x3 = ((x3[0] - x1[0] - x2[0]) % p, (x3[1] - x1[1] - x2[1]) % p)
    y3 = _f2_mul(lam, ((x1[0] - x3[0]) % p, (x1[1] - x3[1]) % p), p, beta)
    y3 = ((y3[0] - y1[0]) % p, (y3[1] - y1[1]) % p)
    return (x3, y3)


def _g2_mul(P, k, p, beta, b2):
    R = None
    while k:
        if k & 1:
            R = _g2_add(R, P, p, beta, b2)
        P = _g2_add(P, P, p, beta, b2)
        k >>= 1
    return R


def _build_g2_side(p, t, r, b, beta, xi, twist_pref, g2_gen):
    """Determine twist type/constant/cofactor; derive a G2 generator if needed.

    Returns (twist, b2, h2, g2_gen, derived).
    """
    n_a, n_b = _twist_orders(p, t)
    candidates = []
    for tw in ("M", "D"):
        if tw == "M":
            b2 = _f2_mul((b, 0), xi, p, beta)
        else:
            b2 = _f2_mul((b, 0), _f2_inv(xi, p, beta), p, beta)
        for n in (n_a, n_b):
            if n % r == 0 and _check_twist_order(p, beta, b2, n):
                candidates.append((tw, b2, n))
    if not candidates:
        raise ValueError("no sextic twist with r-divisible order found")
    # prefer the conventional twist type if both verify (they should not)
    candidates.sort(key=lambda c: (c[0] != twist_pref,))
    tw, b2, n = candidates[0]
    h2 = n // r
    derived = g2_gen is None
    if derived:
        g2_gen = _derive_g2_gen(p, beta, b2, h2, r)
    else:
        # sanity: the pinned generator is on the twist and in the r-subgroup
        (gx, gy) = g2_gen
        lhs = _f2_mul(gy, gy, p, beta)
        x3 = _f2_mul(_f2_mul(gx, gx, p, beta), gx, p, beta)
        rhs = ((x3[0] + b2[0]) % p, (x3[1] + b2[1]) % p)
        assert lhs == rhs, "pinned G2 generator not on twist curve"
        assert _g2_mul(g2_gen, r, p, beta, b2) is None, "pinned G2 gen not order r"
    return tw, b2, h2, g2_gen, derived


def _check_twist_order(p, beta, b2, n, trials=2):
    import random

    rng = random.Random(0xC0FFEE)
    ok = 0
    while ok < trials:
        x = (rng.randrange(p), rng.randrange(p))
        x3 = _f2_mul(_f2_mul(x, x, p, beta), x, p, beta)
        rhs = ((x3[0] + b2[0]) % p, (x3[1] + b2[1]) % p)
        y = _f2_sqrt(rhs, p, beta)
        if y is None:
            continue
        if _g2_mul((x, y), n, p, beta, b2) is not None:
            return False
        ok += 1
    return True


def _derive_g2_gen(p, beta, b2, h2, r):
    """Deterministic G2 generator: cofactor-cleared smallest-x point.

    The reference pins no cross-library G2 generator for BLS12-377/FP256BN
    (math_test.go only pins G1 generators), so we fix a canonical choice:
    the lexicographically smallest (c1, c0) x-coordinate with a valid y
    (smaller of +-y by (c1, c0) order), multiplied by the cofactor.
    """
    for c1 in range(4):
        for c0 in range(1000):
            x = (c0, c1)
            x3 = _f2_mul(_f2_mul(x, x, p, beta), x, p, beta)
            rhs = ((x3[0] + b2[0]) % p, (x3[1] + b2[1]) % p)
            y = _f2_sqrt(rhs, p, beta)
            if y is None:
                continue
            ny = ((-y[0]) % p, (-y[1]) % p)
            if (ny[1], ny[0]) < (y[1], y[0]):
                y = ny
            G = _g2_mul((x, y), h2, p, beta, b2)
            if G is None:
                continue
            assert _g2_mul(G, r, p, beta, b2) is None
            return G
    raise ValueError("no small-x G2 point found")


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------

# BLS12-381 G2 generator: the standard value from the BLS12-381 ciphersuite
# (used identically by kilic and gnark; pinned transitively by Test381Compat,
#  math_test.go:879-911).
_BLS12_381_G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# BLS12-377 G2 generator: the standard zexe/arkworks value, which gnark-crypto
# uses verbatim (reference seam: driver/gurvy/bls12-377.go:266-273 caches
# bls12377.Generators()).  Validated on-twist and order-r at spec build.
_BLS12_377_G2_GEN = (
    (
        233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
    ),
    (
        63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
    ),
)

# BN254 G2 generator: the standard EIP-197 value (gnark uses the same curve
# and generators as the EVM alt_bn128 precompiles).
_BN254_G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def _make_bls12_381() -> CurveSpec:
    x = -0xD201000000010000
    p, r, t = _bls12_pr(x)
    h1 = (x - 1) ** 2 // 3
    beta = p - 1  # u^2 = -1
    xi = (1, 1)  # 1 + u
    twist, b2, h2, g2_gen, derived = _build_g2_side(
        p, t, r, 4, beta, xi, "M", _BLS12_381_G2_GEN
    )
    g1_gen = (
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    )  # pinned by math_test.go:254
    return CurveSpec(
        name="BLS12_381",
        family=Family.BLS12,
        x=x,
        p=p,
        r=r,
        b=4,
        beta=beta,
        xi=xi,
        twist=twist,
        b2=b2,
        h1=h1,
        h2=h2,
        t=t,
        g1_gen=g1_gen,
        g2_gen=g2_gen,
        fp_bytes=48,
        ser_format=SerFormat.ZCASH,
        fexp_factor=3,
        g2_derived=derived,
    )


def _make_bls12_377() -> CurveSpec:
    x = 0x8508C00000000001
    p, r, t = _bls12_pr(x)
    h1 = (x - 1) ** 2 // 3
    beta = p - 5  # u^2 = -5
    xi = (0, 1)  # u
    twist, b2, h2, g2_gen, derived = _build_g2_side(
        p, t, r, 1, beta, xi, "D", _BLS12_377_G2_GEN
    )
    g1_gen = (
        81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
        241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    )  # pinned by math_test.go:255
    return CurveSpec(
        name="BLS12_377",
        family=Family.BLS12,
        x=x,
        p=p,
        r=r,
        b=1,
        beta=beta,
        xi=xi,
        twist=twist,
        b2=b2,
        h1=h1,
        h2=h2,
        t=t,
        g1_gen=g1_gen,
        g2_gen=g2_gen,
        fp_bytes=48,
        ser_format=SerFormat.GNARK,
        fexp_factor=3,
        g2_derived=derived,
    )


def _make_bn254() -> CurveSpec:
    u = 4965661367192848881  # derived from the pinned order (math_test.go:263)
    p, r, t = _bn_pr(u)
    beta = p - 1  # u^2 = -1
    xi = (9, 1)  # 9 + u
    twist, b2, h2, g2_gen, derived = _build_g2_side(
        p, t, r, 3, beta, xi, "D", _BN254_G2_GEN
    )
    # gnark BN254 Gt convention: Fuentes-Castaneda hard part, factor 2x(6x^2+3x+1)
    fexp_factor = 2 * u * (6 * u * u + 3 * u + 1)
    return CurveSpec(
        name="BN254",
        family=Family.BN,
        x=u,
        p=p,
        r=r,
        b=3,
        beta=beta,
        xi=xi,
        twist=twist,
        b2=b2,
        h1=1,
        h2=h2,
        t=t,
        g1_gen=(1, 2),
        g2_gen=g2_gen,
        fp_bytes=32,
        ser_format=SerFormat.GNARK,
        fexp_factor=fexp_factor,
        g2_derived=derived,
    )


def _make_fp256bn() -> CurveSpec:
    u = -7530851732716300289  # derived from the pinned order (math_test.go:262)
    p, r, t = _bn_pr(u)
    beta = p - 1  # u^2 = -1 (p % 4 == 3)
    xi = (1, 1)  # 1 + u (AMCL FP256BN tower)
    twist, b2, h2, g2_gen, derived = _build_g2_side(p, t, r, 3, beta, xi, "M", None)
    return CurveSpec(
        name="FP256BN",
        family=Family.BN,
        x=u,
        p=p,
        r=r,
        b=3,
        beta=beta,
        xi=xi,
        twist=twist,
        b2=b2,
        h1=1,
        h2=h2,
        t=t,
        g1_gen=(1, 2),
        g2_gen=g2_gen,
        fp_bytes=32,
        ser_format=SerFormat.AMCL,
        fexp_factor=1,
        g2_derived=derived,
    )


def _make_fp256bn_miracl() -> CurveSpec:
    """The miracl-core flavour of FP256BN: the same curve arithmetic under
    the miracl-core wire format (prefixed G2, 129/65 B; fp256bn_miracl.go:
    110-125) and the standards-track hash-to-point (driver/amcl/custom.go)."""
    import dataclasses

    return dataclasses.replace(
        get_spec("FP256BN"), name="FP256BN_MIRACL", ser_format=SerFormat.AMCL_MIRACL
    )


@lru_cache(maxsize=None)
def get_spec(name: str) -> CurveSpec:
    builders = {
        "BLS12_381": _make_bls12_381,
        "BLS12_377": _make_bls12_377,
        "BN254": _make_bn254,
        "FP256BN": _make_fp256bn,
        "FP256BN_MIRACL": _make_fp256bn_miracl,
    }
    return builders[name]()


class CurveID(enum.IntEnum):
    """Mirrors the reference registry order (math.go:70-103)."""

    FP256BN_AMCL = 0
    BN254 = 1
    FP256BN_AMCL_MIRACL = 2
    BLS12_381 = 3
    BLS12_377_GURVY = 4
    BLS12_381_GURVY = 5
    BLS12_381_BBS = 6
    BLS12_381_BBS_GURVY = 7


#: CurveID -> underlying CurveSpec name (several IDs share a spec; they differ
#: only in hash-to-curve variant and backend provenance in the reference).
CURVE_ID_SPEC = {
    CurveID.FP256BN_AMCL: "FP256BN",
    CurveID.BN254: "BN254",
    CurveID.FP256BN_AMCL_MIRACL: "FP256BN_MIRACL",
    CurveID.BLS12_381: "BLS12_381",
    CurveID.BLS12_377_GURVY: "BLS12_377",
    CurveID.BLS12_381_GURVY: "BLS12_381",
    CurveID.BLS12_381_BBS: "BLS12_381",
    CurveID.BLS12_381_BBS_GURVY: "BLS12_381",
}

