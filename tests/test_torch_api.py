"""The port's public API (``mathlib_tpu_torch.api``) against the JAX package's
(``mathlib_tpu.api``), on the CPU, for all 8 curve IDs.

Each test runs the same seeded script of operations through both APIs (the
port's on ``curves("cpu")``) and compares what comes out byte for byte:
``Bytes()``, ``Compressed()``, ``MarshalJSON()``, ``String()``, the
predicates and every constructor's (value, error) pair.  The surface is the
reference's ``tests/test_api_mathlib.py``.  ``MultiScalarMul`` at 64 points
(the smallest count that dispatches) runs the port's ``msm_host_bridge`` on
the CPU, never the reference's jitted bridge, and is held to the host fold.
"""

import json
import random

import pytest
import torch

import mathlib_tpu.api as ref_api
import mathlib_tpu_torch.api as api
from mathlib_tpu_torch.ops import msm as port_msm

torch.set_num_threads(1)

ALL_IDS = list(api.CurveID)
FP256 = {api.CurveID.FP256BN_AMCL, api.CurveID.FP256BN_AMCL_MIRACL}
MAXINT64 = 2**63 - 1


def _both(cid):
    """(reference Curve, port Curve on the CPU) of one curve ID."""
    return ref_api.Curves[int(cid)], api.curves("cpu")[int(cid)]


def _same(script, cid, seed=0):
    """Run script(curve, rng) on both APIs with one seed; compare outputs."""
    ref_c, c = _both(cid)
    want = script(ref_c, random.Random(seed))
    got = script(c, random.Random(seed))
    assert got == want
    return got


ids = pytest.mark.parametrize("cid", ALL_IDS, ids=[c.name for c in ALL_IDS])


def _err(err):
    return None if err is None else (type(err).__name__, str(err))


def _out(x):
    """What an element or a value shows of itself, for comparison."""
    if hasattr(x, "MarshalJSON"):
        extra = (x.Compressed(),) if hasattr(x, "Compressed") else ()
        return (type(x).__name__, x.Bytes(), str(x), x.MarshalJSON()) + extra
    return x


@ids
def test_curve_constants_and_sizes(cid):
    def script(c, rng):
        return [_out(c.GenG1), _out(c.GenG2), _out(c.GenGt), _out(c.GroupOrder), int(c.ID()),
                c.CoordByteSize, c.G1ByteSize, c.CompressedG1ByteSize, c.G2ByteSize,
                c.CompressedG2ByteSize, c.ScalarByteSize]

    _same(script, cid)
    assert api.CurveIDToString(cid) == ref_api.CurveIDToString(int(cid))


@ids
def test_zr_arithmetic_strings_and_mod_helpers(cid):
    def script(c, rng):
        out = []
        a, b, m = c.NewRandomZr(rng), c.NewRandomZr(rng), c.GroupOrder
        big = c.NewZrFromInt(MAXINT64).Plus(c.NewZrFromInt(MAXINT64)).Plus(c.NewZrFromInt(2))
        neg = a.Copy()
        neg.Neg()
        out += [_out(v) for v in (a.Plus(b), a.Minus(b), b.Minus(a), a.Mul(b), a.PowMod(b),
                                  big, neg, c.NewZrFromBytes(neg.Bytes()), c.NewZrFromInt(-5))]
        for mutate in ("Mod", "InvModP", "InvModOrder", "Clone", "Neg"):
            x = a.Copy()
            if mutate == "Mod":
                x.Mod(c.NewZrFromInt(1000003))
            elif mutate == "InvModP":
                x.InvModP(m)
            elif mutate == "Clone":
                x.Clone(neg)
            else:
                getattr(x, mutate)()
            out.append(_out(x))
        u = c.NewZrFromUint64(2**64 - 1)
        out += [u.Uint(), u.Int(), c.NewZrFromInt(MAXINT64).Int(), a.IsZero(), a.IsOne(),
                c.NewZrFromInt(1).IsOne(), c.NewZrFromInt(0).IsZero(), a.Equals(a.Copy())]
        try:
            big.Int()
        except ValueError as e:
            out.append(str(e))
        a2, b2, a3, b3 = (c.NewRandomZr(rng) for _ in range(4))
        out += [_out(v) for v in (
            c.ModAdd(a, b, m), c.ModSub(a, b, m), c.ModMul(a, b, m), c.ModNeg(a, m),
            c.ModAddMul([a, a2], [b, b2], m), c.ModAddMul2(a, b, a2, b2, m),
            c.ModAddMul3(a, b, a2, b2, a3, b3, m),
            c.HashToZr(b"Amazing Grace"), c.HashToZr(bytes(range(128))))]
        for fn, args in ((c.ModMulInPlace, (a, b, m)), (c.ModAddMul2InPlace, (a, b, a2, b2, m)),
                         (c.ModAddMul3InPlace, (a, b, a2, b2, a3, b3, m))):
            res = c.NewZrFromInt(0)
            fn(res, *args)
            out.append(_out(res))
        return out

    _same(script, cid)


@ids
def test_g1_group_law_codecs_and_hashes(cid):
    def script(c, rng):
        out = []
        a, b = c.NewRandomZr(rng), c.NewRandomZr(rng)
        P, Q = c.GenG1.Mul(a), c.GenG1.Mul(b)
        S = P.Copy()
        S.Add(Q)
        D = P.Copy()
        D.Sub(Q)
        N = P.Copy()
        N.Neg()
        Z = P.Copy()
        Z.Sub(P)
        J = P.Copy()
        J.Mul2InPlace(a, Q, b)
        big = c.NewZrFromInt(MAXINT64)
        out += [_out(v) for v in (P, Q, S, D, N, Z, J, P.Mul2(a, Q, b),
                                  c.GenG1.Mul2(big, c.GenG1, big), c.GenG1.Mul(c.GroupOrder),
                                  P.Mul(c.NewZrFromInt(0)), c.NewG1())]
        out += [Z.IsInfinity(), P.IsInfinity(), P.Equals(Q), S.Equals(P.Mul2(c.NewZrFromInt(1), Q,
                                                                               c.NewZrFromInt(1)))]
        C = c.NewG1()
        C.Clone(P)
        out.append(C.Equals(P))
        out += [_out(v) for v in (c.HashToG1(b"Amazing Grace (how sweet the sound)"),
                                  c.HashToG1WithDomain(b"it's a heavy metal universe",
                                                       b"powerplant"),
                                  c.HashToG1WithDomain(b"msg", b""))]
        for enc in (P.Bytes(), P.Compressed(), c.NewG1().Bytes(), c.NewG1().Compressed()):
            back, err = c.NewG1FromBytes(enc)
            back2, err2 = c.NewG1FromCompressed(enc)
            out += [_out(back), _err(err), _out(back2), _err(err2)]
        return out

    _same(script, cid)


@ids
def test_g2_group_law_codecs_and_hashes(cid):
    def script(c, rng):
        out = []
        a, b = c.NewRandomZr(rng), c.NewRandomZr(rng)
        P, Q = c.GenG2.Mul(a), c.GenG2.Mul(b)
        S = P.Copy()
        S.Add(Q)
        D = S.Copy()
        D.Sub(Q)
        Z = P.Copy()
        Z.Sub(P)
        P.Affine()
        out += [_out(v) for v in (P, Q, S, D, Z, c.NewG2(), c.GenG2.Mul(c.GroupOrder))]
        out += [D.Equals(P), P.Equals(Q)]
        C = c.NewG2()
        C.Clone(Q)
        out.append(C.Equals(Q))
        for enc in (P.Bytes(), P.Compressed(), c.NewG2().Bytes()):
            back, err = c.NewG2FromBytes(enc)
            back2, err2 = c.NewG2FromCompressed(enc)
            out += [_out(back), _err(err), _out(back2), _err(err2)]
        for hash_ in (lambda: c.HashToG2(b"Amazing Grace (how sweet the sound)"),
                      lambda: c.HashToG2WithDomain(b"it's a heavy metal universe",
                                                   b"with a Heavy Metal sound")):
            try:
                out.append(_out(hash_()))
            except RuntimeError as e:
                out.append(("raised", str(e)))
        return out

    got = _same(script, cid)
    assert (("raised", "HashToG2 is not available for this curve") in got) == (cid in FP256)


@ids
def test_pairing_fexp_and_gt(cid):
    def script(c, rng):
        out = []
        a, b, x = c.NewRandomZr(rng), c.NewRandomZr(rng), c.NewRandomZr(rng)
        P, Q = c.GenG1.Mul(a), c.GenG2.Mul(b)
        e = c.Pairing(Q, P)
        e2 = c.Pairing2(Q, P, c.GenG2, c.GenG1)
        f = c.FExp(e)
        inv = c.FExp(e)
        inv.Inverse()
        prod = c.NewGtFromBytes(inv.Bytes())[0]
        prod.Mul(f)
        out += [_out(v) for v in (e, e2, f, c.FExp(e2), inv, prod, f.Exp(x),
                                  c.GenGt.Exp(c.NewZrFromInt(0)), c.GenGt.Exp(c.NewZrFromInt(1)),
                                  c.GenGt.Exp(c.NewZrFromInt(-3)))]
        out += [prod.IsUnity(), f.IsUnity(), f.Equals(c.GenGt.Exp(a.Mul(b))),
                c.FExp(c.Pairing(c.GenG2, c.GenG1)).Equals(c.GenGt)]
        back, err = c.NewGtFromBytes(f.Bytes())
        out += [_out(back), _err(err)]
        return out

    got = _same(script, cid)
    assert got[-2 - 4] is True and got[-2 - 1] is True  # prod is one; e(g2, g1) is GenGt


@ids
def test_json_envelope_and_constructor_errors(cid):
    def script(c, rng):
        out = []
        z = c.NewRandomZr(rng)
        g1, g2 = c.GenG1.Mul(z), c.GenG2.Mul(z)
        gt = c.Pairing(g2, g1)
        mod = api if isinstance(c, api.Curve) else ref_api
        kw = {"device": "cpu"} if mod is api else {}
        for cls, v in ((mod.Zr, z), (mod.G1, g1), (mod.G2, g2), (mod.Gt, gt)):
            raw = json.dumps(json.loads(v.MarshalJSON()))
            out.append(_out(cls.UnmarshalJSON(raw, **kw)))
            for bad in (b'{"element":1}', b'{"element":"YQo="}'):
                try:
                    out.append(_out(cls.UnmarshalJSON(bad, **kw)))
                except Exception as e:  # noqa: BLE001
                    out.append((type(e).__name__, str(e)))
        n = c.CoordByteSize
        g1b, g2b = g1.Bytes(), g2.Bytes()
        bad_inputs = [None, b"", b"\x00" * 7, g1b[:-1], bytes([g1b[0] ^ 0x80]) + g1b[1:],
                      bytes([g1b[0] | 0x40]) + g1b[1:], g1b[:-1] + bytes([g1b[-1] ^ 1]),
                      b"\xff" * len(g1b), g1.Compressed()[:-1] + b"\x07",
                      bytes([0x04]) + b"\xff" * (2 * n), g2b[:-1], g2b[:-1] + bytes([g2b[-1] ^ 1]),
                      b"\xff" * len(g2b), gt.Bytes()[:-1], b"\xff" * (12 * n)]
        for b in bad_inputs:
            for fn in (c.NewG1FromBytes, c.NewG1FromCompressed, c.NewG2FromBytes,
                       c.NewG2FromCompressed, c.NewGtFromBytes):
                v, err = fn(b)
                out.append((_out(v), _err(err)))
        return out

    _same(script, cid)


@ids
def test_multi_scalar_mul_below_the_dispatch(cid, monkeypatch):
    """n = 10 runs the host engine's MSM, as the reference's does."""
    monkeypatch.setattr(port_msm, "msm_host_bridge", _refuse)

    def script(c, rng):
        g1s = [c.GenG1.Mul(c.NewRandomZr(rng)) for _ in range(10)]
        zrs = [c.NewRandomZr(rng) for _ in range(10)]
        zrs[2] = c.NewZrFromInt(0)
        g1s[4] = c.NewG1()
        return [_out(c.MultiScalarMul(g1s, zrs)), _out(c.MultiScalarMul([], []))]

    _same(script, cid)


def _refuse(*args, **kwargs):
    raise AssertionError("the bridge must not run below 64 points")


def test_multi_scalar_mul_dispatches_to_the_port_bridge(monkeypatch):
    """n = 64 runs the port's ``msm_host_bridge`` on the curve's device (the
    CPU here), with repeated points, a zero scalar and an infinity point; the
    result is the host fold's (as the reference's test of its own dispatch)."""
    c = api.curves("cpu")[api.CurveID.BLS12_381]
    calls = []
    bridge = port_msm.msm_host_bridge

    def counted(spec, points, scalars, device=None):
        calls.append(device)
        return bridge(spec, points, scalars, device=device)

    monkeypatch.setattr(port_msm, "msm_host_bridge", counted)
    rng = random.Random(64)
    g1s = [c.GenG1.Mul(c.NewZrFromInt(i % 19 + 1)) for i in range(64)]
    zrs = [c.NewRandomZr(rng) for _ in range(64)]
    zrs[3] = c.NewZrFromInt(0)
    g1s[7] = c.NewG1()
    acc = c.NewG1()
    for g, z in zip(g1s, zrs):
        acc.Add(g.Mul(z))
    got = c.MultiScalarMul(g1s, zrs)
    assert calls == [torch.device("cpu")]
    assert got.Bytes() == acc.Bytes() and got.Equals(acc)
    with pytest.raises(ValueError):
        c.MultiScalarMul(g1s, zrs[:-1])


def test_a_card_curve_raises_without_a_card(monkeypatch):
    """No fallback: the card's registry, a Curve without a device and an
    element made without a curve all need the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: api.Curves[api.CurveID.BLS12_381], lambda: api.Curve(api.CurveID.BN254),
                 lambda: api.curves()[api.CurveID.BN254],
                 lambda: api.G1(None, api.CurveID.BN254).Bytes()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert api.curves("cpu")[api.CurveID.BN254].device == torch.device("cpu")
    assert len(api.Curves) == 8
