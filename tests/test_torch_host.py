"""The port's own curve constants and host engine against the JAX package's.

The port keeps copies of ``mathlib_tpu.curves.params``,
``mathlib_tpu.curves.isogeny_data`` and ``mathlib_tpu.host`` (and of
``native/engine.cpp``) so that it never imports the JAX package.  These
tests hold the copies equal to the originals: every ``CurveSpec`` field on
all four curves, the pure-Python and C++ engines on the group law, the MSM,
the Miller loop and the final exponentiation, the isogeny data, and the host
hasher's outputs.
"""

import dataclasses
import os
import random

import pytest

from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host.engine import HostEngine as RefHostEngine
from mathlib_tpu_torch import CurveSpec, get_spec
from mathlib_tpu_torch.host import HostEngine, NativeEngine, get_engine, native

CURVES = ["BLS12_381", "BN254", "BLS12_377", "FP256BN"]


ENUM_FIELDS = ("family", "ser_format")  # the port's own enums: compared by name and value
SIZES = ("g1_uncompressed_size", "g1_compressed_size", "g2_uncompressed_size",
         "g2_compressed_size", "gt_size", "scalar_bytes")


@pytest.mark.parametrize("curve", CURVES + ["FP256BN_MIRACL"])
def test_every_spec_field_equals_the_reference(curve):
    """Every field, the wire format and every serialized size included."""
    spec, ref = get_spec(curve), ref_get_spec(curve)
    assert isinstance(spec, CurveSpec)
    for f in dataclasses.fields(spec):
        got, want = getattr(spec, f.name), getattr(ref, f.name)
        if f.name in ENUM_FIELDS:
            assert (got.name, got.value) == (want.name, want.value)
        else:
            assert got == want, f.name
    assert [f.name for f in dataclasses.fields(spec)] == [f.name for f in dataclasses.fields(ref)]
    for prop in ("hard_part_exp", "easy_exp") + SIZES:
        assert getattr(spec, prop) == getattr(ref, prop), prop


def test_curve_id_registry_equals_the_reference():
    from mathlib_tpu.curves import params as ref_params
    from mathlib_tpu_torch.curves import params

    assert [(c.name, c.value) for c in params.CurveID] == [
        (c.name, c.value) for c in ref_params.CurveID]
    assert {c.name: v for c, v in params.CURVE_ID_SPEC.items()} == {
        c.name: v for c, v in ref_params.CURVE_ID_SPEC.items()}
    spec, ref = get_spec("FP256BN_MIRACL"), ref_get_spec("FP256BN_MIRACL")
    for f in dataclasses.fields(spec):
        if f.name not in ENUM_FIELDS:
            assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    assert spec.ser_format.name == ref.ser_format.name == "AMCL_MIRACL"


@pytest.mark.parametrize("curve", CURVES)
def test_native_and_python_engines_equal_the_reference_engine(curve):
    spec = get_spec(curve)
    ref = RefHostEngine(ref_get_spec(curve))
    py, nat = HostEngine(spec), get_engine(spec)
    assert isinstance(nat, NativeEngine)
    rng = random.Random(curve)
    ks = [rng.randrange(1, spec.r) for _ in range(4)]
    P = ref.g1.mul(ref.gen_g1, ks[0])
    Q = ref.g2.mul(ref.gen_g2, ks[1])
    for eng in (py, nat):
        assert eng.g1.mul(ref.gen_g1, ks[0]) == P
        assert eng.g2.mul(ref.gen_g2, ks[1]) == Q
        assert eng.g1.add(P, ref.gen_g1) == ref.g1.add(P, ref.gen_g1)
        pts = [ref.gen_g1, P, None]
        assert eng.g1.msm(pts, ks[1:]) == ref.g1.msm(pts, ks[1:])
    # the C++ Miller loop clears denominators differently: its unreduced
    # value is another representative, equal after the final exponentiation
    f = ref.miller_loop([(P, Q)])
    assert py.miller_loop([(P, Q)]) == f
    e = ref.final_exp(f)
    assert py.final_exp(f) == e == nat.final_exp(f)
    assert nat.final_exp(nat.miller_loop([(P, Q)])) == e
    assert nat.gt_is_one(nat.final_exp(nat.miller_loop([(P, Q), (ref.g1.neg(P), Q)])))


@pytest.mark.parametrize("curve", CURVES)
def test_glv_gls_mul_mul2_and_mul_any_equal_the_reference_native_engine(curve):
    """The API's scalar muls: ``mul`` (GLV on G1, GLS on BLS12 G2, each
    finished by a joint multiplication of the library), ``mul2`` and
    ``mul_any``, against the reference's native engine on seeded points and
    scalars, k = 0, 1, r - 1, negative k, k >= r and infinity among them."""
    from mathlib_tpu.host.engine import get_engine as ref_get_engine

    spec = get_spec(curve)
    ref, nat = ref_get_engine(ref_get_spec(curve)), get_engine(spec)
    assert type(ref).__name__ == "NativeEngine"  # not the reference's Python fallback
    assert (nat.g1._glv is None) == (ref.g1._glv is None)
    assert nat.g1._glv == ref.g1._glv
    assert (nat.g2._gls is None) == (ref.g2._gls is None) == (curve not in ("BLS12_381", "BLS12_377"))
    rng = random.Random("glv-" + curve)
    r = spec.r
    ks = [0, 1, 2, r - 1, r, r + 5, -1, -rng.randrange(r)] + [rng.randrange(r) for _ in range(3)]
    P = ref.g1.mul(ref.gen_g1, rng.randrange(1, r))
    Q = ref.g2.mul(ref.gen_g2, rng.randrange(1, r))
    for k in ks:
        for group, pt in ((nat.g1, P), (nat.g2, Q)):
            want_group = ref.g1 if group is nat.g1 else ref.g2
            for fn in ("mul", "mul_any"):
                assert getattr(group, fn)(pt, k) == getattr(want_group, fn)(pt, k), (fn, k)
            assert group.mul(None, k) is None
    pairs = [(0, 0), (1, 0), (0, r - 1), (r - 1, r - 1), (-3, 5)] + [
        (rng.randrange(r), rng.randrange(r)) for _ in range(3)]
    P2 = ref.g1.mul(ref.gen_g1, rng.randrange(1, r))
    for e, f in pairs:
        for A, B in ((P, P2), (P, P), (P, ref.g1.neg(P)), (None, P2), (P, None)):
            assert nat.g1.mul2(A, e, B, f) == ref.g1.mul2(A, e, B, f), (e, f)
        assert nat.g2.mul2(Q, e, None, f) == ref.g2.mul2(Q, e, None, f)


def test_isogeny_data_and_the_host_hasher_equal_the_reference():
    """The copies of ``curves/isogeny_data.py`` and ``host/hash_to_curve.py``:
    the data, and the hasher's outputs (XMD on both hashes, G1 by SSWU on
    BLS12-381 and by SVDW on BN254, the BBS+ map, G2)."""
    from mathlib_tpu.curves import isogeny_data as ref_iso
    from mathlib_tpu.host import hash_to_curve as ref_h2c
    from mathlib_tpu_torch.curves import isogeny_data
    from mathlib_tpu_torch.host import hash_to_curve

    assert isogeny_data.G1 == ref_iso.G1 and isogeny_data.G2 == ref_iso.G2
    for name in ("sha256", "blake2b512"):
        assert hash_to_curve.expand_message_xmd(b"abc", b"DST", 200, name) == \
            ref_h2c.expand_message_xmd(b"abc", b"DST", 200, name)
    for curve in ("BLS12_381", "BN254"):
        h, ref = hash_to_curve.get_hasher(get_spec(curve)), ref_h2c.get_hasher(ref_get_spec(curve))
        assert h.is_rfc_compatible("g1") == ref.is_rfc_compatible("g1")
        for msg in (b"", b"msg-1"):
            assert h.hash_to_g1(msg, b"DST") == ref.hash_to_g1(msg, b"DST")
        assert h.hash_to_g1_bbs(b"bbs", b"DST") == ref.hash_to_g1_bbs(b"bbs", b"DST")
        assert h.hash_to_g2(b"g2", b"DST") == ref.hash_to_g2(b"g2", b"DST")
        p = h.spec.p
        assert hash_to_curve.hash_to_field_fp2(b"x", b"D", p, 2) == \
            ref_h2c.hash_to_field_fp2(b"x", b"D", p, 2)


def test_native_library_is_named_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / "engine.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(native, "SRC", str(src))
    first = native.library_path()
    src.write_text("int y;\n")
    second = native.library_path()
    assert first != second
    assert os.path.dirname(first) == native.BUILD_DIR
    assert os.path.basename(second).startswith("libmlt_host_")


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "engine.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    path = native.library_path()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(path)
    assert not os.path.exists(path)
    assert not [f for f in os.listdir(tmp_path / "out") if ".tmp." in f]
