"""The port's codec (``mathlib_tpu_torch/host/serialize.py``) against the JAX
package's ``Codec``, on the CPU, in all four wire formats: ZCASH
(BLS12-381), GNARK (BN254, BLS12-377), AMCL (FP256BN) and AMCL_MIRACL
(FP256BN_MIRACL).

G1, G2, Gt and Zr encodings are byte-equal to the reference's and decode to
what was encoded, infinity included; the BLS12-381 generators encode to
their public bytes; and malformed inputs (a wrong length, flag bits, x not
on the curve, a point outside the subgroup, x >= p) raise
``SerializationError`` in both packages, with the same message.
"""

import random

import pytest

from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host import serialize as ref_ser
from mathlib_tpu.host.engine import get_engine as ref_get_engine
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host import get_engine, serialize

SPECS = ["BLS12_381", "BN254", "BLS12_377", "FP256BN", "FP256BN_MIRACL"]

# the public BLS12-381 generator encodings (ZCash / IETF BLS ciphersuite)
G1_GEN_COMPRESSED = bytes.fromhex(
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb"
)
G2_GEN_COMPRESSED = bytes.fromhex(
    "93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
    "334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051"
    "c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8"
)


def _codecs(name):
    spec, eng = get_spec(name), get_engine(get_spec(name))
    ref_spec = ref_get_spec(name)
    return spec, eng, serialize.Codec(spec, eng), ref_ser.Codec(ref_spec, ref_get_engine(ref_spec))


def _off_subgroup(spec, eng, rng, g2: bool):
    """A point on the curve (G1) or its twist (G2) outside the r-torsion."""
    t = eng.tw
    while True:
        if g2:
            x = (rng.randrange(spec.p), rng.randrange(spec.p))
            y = t.f2_sqrt(t.f2_add(t.f2_mul(t.f2_mul(x, x), x), spec.b2))
        else:
            x = rng.randrange(spec.p)
            y = t.fp_sqrt((x * x % spec.p * x + spec.b) % spec.p)
        if y is not None:
            P = (x, y)
            if (eng.g2 if g2 else eng.g1).mul_any(P, spec.r) is not None:
                return P


@pytest.mark.parametrize("name", SPECS)
def test_encodings_equal_the_reference_and_round_trip(name):
    spec, eng, co, ref = _codecs(name)
    rng = random.Random(name)
    g1s = [None, spec.g1_gen] + [eng.g1.mul(spec.g1_gen, rng.randrange(1, spec.r)) for _ in range(3)]
    g2s = [None, spec.g2_gen] + [eng.g2.mul(spec.g2_gen, rng.randrange(1, spec.r)) for _ in range(3)]
    for P in g1s:
        for compressed in (False, True):
            b = co.g1_to_bytes(P, compressed)
            assert b == ref.g1_to_bytes(P, compressed)
            assert co.g1_from_bytes(b) == ref.g1_from_bytes(b) == P
    for Q in g2s:
        for compressed in (False, True):
            b = co.g2_to_bytes(Q, compressed)
            assert b == ref.g2_to_bytes(Q, compressed)
            assert co.g2_from_bytes(b) == ref.g2_from_bytes(b) == Q
    gts = [eng.gen_gt(), eng.gt_exp(eng.gen_gt(), rng.randrange(spec.r)), eng.tw.F12_ONE]
    for a in gts:
        b = co.gt_to_bytes(a)
        assert b == ref.gt_to_bytes(a) and len(b) == spec.gt_size
        assert co.gt_from_bytes(b) == ref.gt_from_bytes(b) == a
    r = spec.r
    for v in (0, 1, r - 1, r, r + 1, -1, -r, rng.randrange(r), -rng.randrange(r), 2**256 - 1):
        b = serialize.zr_to_bytes(v, r)
        assert b == ref_ser.zr_to_bytes(v, r) and len(b) == spec.scalar_bytes
        assert serialize.zr_from_bytes(b) == ref_ser.zr_from_bytes(b)
    for v in (0, 5, -5, -(2**255)):
        assert serialize.big_to_bytes(v) == ref_ser.big_to_bytes(v)


def test_bls12_381_generators_encode_to_their_public_bytes():
    spec, _, co, _ = _codecs("BLS12_381")
    assert co.g1_to_bytes(spec.g1_gen, True) == G1_GEN_COMPRESSED
    assert co.g2_to_bytes(spec.g2_gen, True) == G2_GEN_COMPRESSED
    unc = co.g1_to_bytes(spec.g1_gen, False)
    assert unc[0] == G1_GEN_COMPRESSED[0] & 0x1F and unc[1:48] == G1_GEN_COMPRESSED[1:]
    assert co.g1_from_bytes(G1_GEN_COMPRESSED) == spec.g1_gen
    assert co.g2_from_bytes(G2_GEN_COMPRESSED) == spec.g2_gen


def _flip(b: bytes, i: int, mask: int) -> bytes:
    out = bytearray(b)
    out[i] ^= mask
    return bytes(out)


@pytest.mark.parametrize("name", SPECS)
def test_malformed_inputs_raise_in_both(name):
    spec, eng, co, ref = _codecs(name)
    rng = random.Random("bad-" + name)
    n, p = spec.fp_bytes, spec.p
    amcl = spec.ser_format.name.startswith("AMCL")
    P = eng.g1.mul(spec.g1_gen, rng.randrange(1, spec.r))
    Q = eng.g2.mul(spec.g2_gen, rng.randrange(1, spec.r))
    g1u, g1c = co.g1_to_bytes(P, False), co.g1_to_bytes(P, True)
    g2u, g2c = co.g2_to_bytes(Q, False), co.g2_to_bytes(Q, True)
    p_bytes = p.to_bytes(n, "big")
    head = 1 if amcl else 0  # the AMCL prefix byte before x
    bad_g1 = [None, b"", g1u[:-1], g1c + b"\x00", g1u[: head] + p_bytes + g1u[head + n:],
              g1u[:-1] + bytes([g1u[-1] ^ 1])]  # x >= p; y off the curve
    bad_g2 = [None, b"", g2u[:-1], g2c + b"\x00", g2u[:-1] + bytes([g2u[-1] ^ 1])]
    if amcl:  # prefixes other than 0x04 and 0x02/0x03
        bad_g1 += [bytes([0x05]) + g1u[1:], bytes([0x07]) + g1c[1:]]
    else:  # the flag bits: compression on an uncompressed input and missing
        bad_g1 += [_flip(g1u, 0, 0x80), _flip(g1c, 0, 0x80)]
        bad_g2 += [_flip(g2u, 0, 0x80), _flip(g2c, 0, 0x80)]
    if spec.ser_format.name == "ZCASH":  # the infinity flag over a point's body
        bad_g1.append(bytes([g1c[0] | 0x40]) + g1c[1:])
        bad_g2.append(bytes([g2c[0] | 0x40]) + g2c[1:])
    # x not on the curve (compressed): the first x whose x^3 + b is no square
    x = next(x for x in range(1, 100) if eng.tw.fp_sqrt((x**3 + spec.b) % p) is None)
    bad_g1.append(co.g1_to_bytes((x, 1), True))
    if spec.h1 != 1:  # a point on the curve outside the subgroup
        bad_g1 += [co.g1_to_bytes(_off_subgroup(spec, eng, rng, False), c) for c in (False, True)]
    off2 = _off_subgroup(spec, eng, rng, True)
    bad_g2 += [co.g2_to_bytes(off2, c) for c in (False, True)]
    gt = co.gt_to_bytes(eng.gen_gt())
    bad_gt = [None, gt[:-1], gt + b"\x00", p_bytes + gt[n:]]
    for fn_name, bad in (("g1_from_bytes", bad_g1), ("g2_from_bytes", bad_g2),
                         ("gt_from_bytes", bad_gt)):
        for b in bad:
            with pytest.raises(serialize.SerializationError) as got:
                getattr(co, fn_name)(b)
            with pytest.raises(ref_ser.SerializationError) as want:
                getattr(ref, fn_name)(b)
            assert str(got.value) == str(want.value), (fn_name, b)
