"""The port's pairing slice (``BatchEngine.pairing_batch``: Miller (f, T),
add step, f12 pow, final exp and Fp pow) against the JAX package, on the CPU.

* Each kernel's plain version against the reference kernel body of
  ``mathlib_tpu/ops/kernels/pairing_pallas.py``, run on numpy rows through
  the stand-ins of ``tests/test_pairing_pallas.py``: bit-equal limbs.  The
  chains are short (a prefix of the loop bits, an 8-bit exponent, short
  inverse and x chains; the kernels take every exponent as an input), so
  every step runs and the whole chain is held to the host engine below and,
  on the card, to these plain versions.
* ``FpCtx.inv``/``sqrt``/``batch_inv`` against Python's ``pow``, and
  ``TowerCtx``'s inverses and Frobenius maps against the port's host tower,
  canonically.
* The slice: ``BatchEngine(spec, "cpu").pairing_batch`` on BLS12-381 against
  the reference's ``HostEngine.pairing``, exactly (BN254's final exp:
  ``tests/test_torch_final_exp_bn.py``).
* The strategies: ``MATHLIB_PAIR_FUSED=check`` reaches the one-launch
  ``pairing_check``; ``split`` and ``MATHLIB_GROUP_FEXP=device`` finish on the
  device path.

Nothing here jits the reference's pairing, Miller loop, final exp or pow
chains.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.fp_rows as ref_fp_rows
import mathlib_tpu.ops.kernels.pairing_pallas as ref_pp
import mathlib_tpu.curves.params as ref_params
from mathlib_tpu.host.engine import HostEngine as RefHostEngine
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.field import FpCtx, ints_to_limbs
from mathlib_tpu_torch.ops.kernels import fp_cuda
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.kernels.tower_rows import (
    f12_pow_mults,
    final_exp_mults,
    mults_per_step,
    pow_mults,
)
from mathlib_tpu_torch.ops.tower import TowerCtx
from test_pairing_pallas import _FakeJax, _FakePl, _FakePltpu, _Ref

torch.set_num_threads(1)

B = 3  # lanes of the kernel-body comparisons
LOOP_PREFIX = 2  # Miller loop bits of the kernel-body comparison: 1, 0 on both curves


@pytest.fixture(scope="module")
def numpy_pallas():
    """The reference kernel bodies on numpy rows (as test_pairing_pallas)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_fp_rows, "jnp", np)
        mp.setattr(ref_pp, "jnp", np)
        mp.setattr(ref_pp, "pl", _FakePl)
        mp.setattr(ref_pp, "jax", _FakeJax)
        mp.setattr(ref_pp, "pltpu", _FakePltpu)
        mp.setattr(ref_pp, "MUL_CHUNK", 1 << 12)  # one stacked product a batch
        yield


def _relaxed(spec, shape, seed):
    """int32 limbs of random values in [0, 2p), shaped shape[:-1] + (L, lanes)."""
    rng = np.random.default_rng(seed)
    L = -(-(spec.p.bit_length() + 2) // 16)
    vals = [int.from_bytes(rng.bytes(64), "big") % (2 * spec.p) for _ in range(int(np.prod(shape)))]
    arr = np.moveaxis(ints_to_limbs(vals, L).reshape(shape + (L,)), -1, -2)
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32))


def _rows(t):
    """(..., L, lanes) int32 -> (K*L, 1, lanes) uint32 rows: coefficient q at
    rows [q*L, (q+1)*L), as the reference kernels lay refs out."""
    return np.ascontiguousarray(t.numpy().astype(np.uint32).reshape(-1, 1, t.shape[-1]))


def _same(got, rows):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_rows(got), rows)


def _ref_tower(spec):
    """The reference's in-kernel tower for a curve.  Its helpers read only the
    spec's p, beta, xi and twist, which tests/test_torch_host.py holds equal
    to the reference's, so the port's spec serves (building the reference's
    spec costs seconds)."""
    p, L, n, xi0, twist = ref_pp._cfg(spec)
    return ref_pp.RowTower(p, L, n, xi0, twist)


# ------------------------------------------------------------------ fp_pow --
@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
def test_fp_pow_plain_is_bit_equal_to_the_reference_body(curve, numpy_pallas):
    spec = get_spec(curve)
    fp = FpCtx(spec.p, "cpu")
    a = _relaxed(spec, (B,), 1)
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 1], dtype=np.uint32)  # an 8-bit exponent
    out = np.zeros((fp.L, 1, B), np.uint32)
    one = tuple((fp.r_mod_p >> (16 * k)) & 0xFFFF for k in range(fp.L))
    ref_pp._fp_pow_kernel(ref_fp_rows.RowCtx(spec.p, fp.L), one, len(bits), _Ref(bits),
                          _Ref(_rows(a)), _Ref(out))
    _same(fp_cuda.fp_pow(fp, a, bits), out)
    # pow_bits takes the little-endian bits, as the reference's FpCtx
    _same(fp.pow_bits(a, bits[::-1].copy()), out)


@pytest.mark.parametrize("curve", ["BLS12_381", "BN254"])
@pytest.mark.parametrize("op", ["inv", "batch_inv", "sqrt"])
def test_inverse_sqrt_and_batch_inverse_equal_python_pow(curve, op, monkeypatch):
    spec = get_spec(curve)
    p = spec.p
    fp = FpCtx(p, "cpu")
    rng = np.random.default_rng(2)
    vals = [0, 1, 2, p - 1, 0] + [int.from_bytes(rng.bytes(48), "big") % p for _ in range(4)]
    a = fp.encode(vals)  # 9 lanes: batch_inv pads its tree to 16
    e = (p + 1) // 4 if op == "sqrt" else p - 2
    # batch_inv's tree stops at 2 lanes here (2,048 on the path): 3 levels up and down
    monkeypatch.setattr(FpCtx, "BATCH_INV_CUTOFF", 2)
    got = getattr(fp, op)(a)
    assert list(fp.decode(got)) == [pow(v, e, p) for v in vals]


def test_sqrt_refuses_p_1_mod_4():
    fp = FpCtx(get_spec("BLS12_377").p, "cpu")
    with pytest.raises(ValueError, match="p % 4"):
        fp.sqrt(fp.encode([4]))


# ---------------------------------------------------- miller_ft, add_step --
@pytest.fixture(scope="module", params=["BLS12_381", "BN254"])
def pair_inputs(request):
    curve = request.param
    spec = get_spec(curve)
    eng = get_engine(spec)
    rng = np.random.default_rng(3)
    ks = [int(k) for k in rng.integers(1, 1 << 62, 2 * B)]
    be = BatchEngine(spec, "cpu")
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(
        [eng.g1.mul(eng.gen_g1, k) for k in ks[:B]], [eng.g2.mul(eng.gen_g2, k) for k in ks[B:]]))
    return curve, be, (xP, yP, Qx, Qy)


def test_miller_ft_plain_is_bit_equal_to_the_reference_body(pair_inputs, numpy_pallas):
    curve, be, (xP, yP, Qx, Qy) = pair_inputs
    # the loop bits are held to the reference's by tests/test_torch_pairing.py
    bits = np.asarray(be.pair.loop_bits[:LOOP_PREFIX], dtype=np.uint32)
    assert list(bits) == [1, 0]  # a doubling step with an addition step, and one without
    L = be.fp.L
    f_out = np.zeros((12 * L, 1, B), np.uint32)
    t_out = np.zeros((6 * L, 1, B), np.uint32)
    ref_pp._miller_kernel(_ref_tower(be.spec), len(bits), _Ref(bits), _Ref(_rows(xP)),
                          _Ref(_rows(yP)), _Ref(_rows(Qx)), _Ref(_rows(Qy)), _Ref(f_out),
                          _Ref(t_out))
    cfg = pc.MillerCfg(be.pair.cfg.tc, bits.astype(np.uint8), be.pair.conj_end)
    f, T = pc.miller_ft(cfg, xP, yP, Qx, Qy)
    assert f.shape == (2, 3, 2, L, B) and T.shape == (3, 2, L, B)
    _same(f, f_out)
    _same(T, t_out)


def test_add_step_plain_is_bit_equal_to_the_reference_body(pair_inputs, numpy_pallas):
    curve, be, (xP, yP, Qx, Qy) = pair_inputs
    spec, L = be.spec, be.fp.L
    f, T = _relaxed(spec, (2, 3, 2, B), 4), _relaxed(spec, (3, 2, B), 5)
    f_out = np.zeros((12 * L, 1, B), np.uint32)
    t_out = np.zeros((6 * L, 1, B), np.uint32)
    ref_pp._add_step_kernel(_ref_tower(spec), _Ref(_rows(f)), _Ref(_rows(T)), _Ref(_rows(Qx)),
                            _Ref(_rows(Qy)), _Ref(_rows(xP)), _Ref(_rows(yP)), _Ref(f_out),
                            _Ref(t_out))
    f2, T2 = pc.add_step(be.pair.cfg, f, T, Qx, Qy, xP, yP)
    _same(f2, f_out)
    _same(T2, t_out)


# ------------------------------------------------------- f12_pow, final_exp --
def _unitary(tw, seed):
    """B host Fp12 values made unitary by the easy part of the final exp,
    and their Montgomery limbs (2, 3, 2, L, B)."""
    h = tw.host
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(B):
        f = tuple(tuple((int.from_bytes(rng.bytes(48), "big") % tw.spec.p,
                         int.from_bytes(rng.bytes(48), "big") % tw.spec.p) for _ in range(3))
                  for _ in range(2))
        t = h.f12_mul(h.f12_conj(f), h.f12_inv(f))
        vals.append(h.f12_mul(h.f12_frob(t, 2), t))
    return vals, torch.cat([tw.f12_encode(v) for v in vals], dim=-1)


@pytest.mark.parametrize("cyclo", [False, True])
def test_f12_pow_plain_is_bit_equal_to_the_reference_body(cyclo, numpy_pallas):
    tw = TowerCtx(get_spec("BLS12_381"), "cpu")
    vals, base = _unitary(tw, 6)
    e = 0b101
    bits = pc.msb_bits(e).astype(np.uint32)
    out = np.zeros((12 * tw.fp.L, 1, B), np.uint32)
    ref_pp._f12_pow_kernel(_ref_tower(tw.spec), len(bits), cyclo, _Ref(bits), _Ref(_rows(base)),
                           _Ref(out))
    got = pc.f12_pow(tw.kcfg, base, bits, cyclo)
    _same(got, out)
    assert tw.f12_decode(got) == [tw.host.f12_pow(v, e) for v in vals]


@pytest.mark.parametrize("curve", ["BLS12_381", "BLS12_377"])
def test_final_exp_plain_is_bit_equal_to_the_reference_body(curve, numpy_pallas):
    spec = get_spec(curve)
    tw = TowerCtx(spec, "cpu")
    p, L = spec.p, tw.fp.L
    gammas = ref_pp.frob_gammas(spec, p, L)  # on the reference's host tower
    for n in (1, 2):  # the port's constants, as the reference lays them out
        want = [[[list(c) for c in gammas[n][j][h]] for j in range(3)] for h in range(2)]
        got = tw.kcfg.gamma_limbs(n, "cpu")[..., 0].tolist()
        assert got == want
    inv_bits = pc.msb_bits(p - 2)[:2].astype(np.uint32)
    x_bits = pc.msb_bits(abs(spec.x))[:1].astype(np.uint32)
    f = _relaxed(spec, (2, 3, 2, B), 7)
    out, acc, base = (np.zeros((12 * L, 1, B), np.uint32) for _ in range(3))
    ref_pp._final_exp_kernel(_ref_tower(spec), gammas, len(inv_bits), len(x_bits), spec.x < 0,
                             _Ref(inv_bits), _Ref(x_bits), _Ref(_rows(f)), _Ref(out),
                             _Ref(acc), _Ref(base))
    _same(pc.final_exp(tw.kcfg, f, inv_bits, x_bits, spec.x < 0), out)


# ------------------------------------------------------------- TowerCtx ---
@pytest.fixture(scope="module", params=["BN254", "BLS12_377"])  # beta = -1 and -5
def tower(request):
    spec = get_spec(request.param)
    return spec, TowerCtx(spec, "cpu")


def _lanes(tw, arr, coeffs):
    """(..., L, lanes) limbs -> per-lane host values of ``coeffs`` shape."""
    d = np.moveaxis(tw.fp.decode(arr), -1, 0)

    def nest(x, depth):
        if depth == len(coeffs):
            return int(x)
        return tuple(nest(x[i], depth + 1) for i in range(coeffs[depth]))

    return [nest(lane, 0) for lane in d]


@pytest.mark.parametrize("op", ["f2_inv", "f6_inv", "f12_inv", "f12_frob"])
def test_tower_inverses_and_frobenius_equal_the_host_tower(tower, op):
    spec, tw = tower
    h = tw.host
    shape = {"f2_inv": (2,), "f6_inv": (3, 2)}.get(op, (2, 3, 2))
    a = _relaxed(spec, shape + (B,), 8)
    if op == "f12_frob":
        want = [h.f12_frob(x, n) for n in (1, 2, 3) for x in _lanes(tw, a, shape)]
        got = [v for n in (1, 2, 3) for v in _lanes(tw, tw.f12_frob(a, n), shape)]
    else:
        want = [getattr(h, op)(x) for x in _lanes(tw, a, shape)]
        got = _lanes(tw, getattr(tw, op)(a), shape)
    assert got == want


# ---------------------------------------------------------------- counts ---
@pytest.mark.parametrize("curve", ["BLS12_381", "BLS12_377"])
def test_row_tower_counts_the_products_of_the_new_chains(curve):
    """``mults_per_step``'s new entries, ``f12_pow_mults`` and
    ``final_exp_mults`` (the basis of the kernels' operation counts) are what
    the plain tower queues: M-twist with n = 1, and D-twist with n = 5."""
    tw = TowerCtx(get_spec(curve), "cpu")
    row = tw.kcfg.tower
    counted = []
    mont = row.fp._mont_mul64

    def counting(a, b, _m=mont):  # products in a (..., L, lanes) call
        counted.append(a.numel() // (a.shape[-2] * a.shape[-1]))
        return _m(a, b)

    f = _relaxed(tw.spec, (2, 3, 2, 1), 9)
    f64 = f.to(torch.int64)
    gam = tw.kcfg.gamma_limbs(1, "cpu")
    bits = np.array([1, 0, 1], np.uint8)
    want = mults_per_step(row.n, row.twist)
    row.fp._mont_mul64 = counting
    try:
        for name, run, n in (
            ("f12_cyclo_sqr", lambda: row.f12_cyclo_sqr(f64), want["f12_cyclo_sqr"]),
            ("f12_frob", lambda: row.f12_frob(f64, gam, 1), want["f12_frob"]),
            ("f2_inv", lambda: row.f2_inv(f64[0, 0], []), want["f2_inv"]),
            ("f6_inv", lambda: row.f6_inv(f64[0], []), want["f6_inv"]),
            ("f12_inv", lambda: row.f12_inv(f64, bits), want["f12_inv"] + pow_mults(bits)),
            ("f12_pow", lambda: pc.f12_pow(tw.kcfg, f, bits, True),
             f12_pow_mults(row.n, row.twist, bits, True)),
            ("final_exp", lambda: pc.final_exp(tw.kcfg, f, bits, bits[:1], True),
             final_exp_mults(row.n, row.twist, bits, bits[:1])),
        ):
            counted.clear()
            run()
            assert sum(counted) == n, (curve, name)
    finally:
        del row.fp._mont_mul64


# ----------------------------------------------------------------- slice ---
def _ref_spec(spec):
    """The reference's ``CurveSpec`` holding the port's values, which
    tests/test_torch_host.py holds field for field to the ones the
    reference computes (computing them anew costs seconds of cofactor
    search); the port's enums map to the reference's by name."""
    vals = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    vals["family"] = ref_params.Family[spec.family.name]
    vals["ser_format"] = ref_params.SerFormat[spec.ser_format.name]
    return ref_params.CurveSpec(**vals)


def test_pairing_batch_equals_the_reference_host_pairing():
    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    P, Q = eng.g1.mul(eng.gen_g1, 12345), eng.g2.mul(eng.gen_g2, 777)
    be = BatchEngine(spec, "cpu")
    assert be.pairing_batch([P], [Q]) == [RefHostEngine(_ref_spec(spec)).pairing(P, Q)]


@pytest.fixture(scope="module")
def bls_checks():
    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    P, G = eng.g1.mul(eng.gen_g1, 99), eng.gen_g2
    return BatchEngine(spec, "cpu"), [P, eng.g1.neg(P)], [G, G]


def test_pair_fused_check_raises_not_ported(bls_checks, monkeypatch):
    """``MATHLIB_PAIR_FUSED=check`` no longer raises ``NotImplementedError``:
    the single check reaches the one-launch kernel's wrapper
    ``pairing_check`` with every pair valid, and no other final exp (a
    recorder stands in; its values are held by tests/test_torch_pair_check.py
    and on the card)."""
    be, g1s, g2s = bls_checks
    monkeypatch.setenv("MATHLIB_PAIR_FUSED", "check")
    calls = []
    monkeypatch.setattr(pc, "pairing_check",
                        lambda cfg, xP, *a: calls.append((xP.shape[-1], a[-1])) or
                        (torch.tensor(False), None))
    monkeypatch.setattr(be.tw, "f12_final_exp", lambda f: calls.append("device") or f)
    monkeypatch.setattr(be.host, "final_exp", lambda v: calls.append("host") or v)
    assert be.pairing_product_is_one(g1s, g2s) is False
    assert calls == [(2, 2)]


@pytest.mark.parametrize("env", [None, ("MATHLIB_PAIR_FUSED", "split"),
                                 ("MATHLIB_GROUP_FEXP", "device")])
def test_strategies_finish_where_the_reference_finishes(bls_checks, monkeypatch, env):
    """Which final exp each call reaches, under each variable: the host
    engine by default; the device path (``TowerCtx.f12_final_exp``, the
    ``final_exp`` kernel on a card) under ``split`` for the single check and
    under ``GROUP_FEXP=device`` for the grouped ones.  The final exps are
    stood in for by recorders; the values are tested above and on the card."""
    be, g1s, g2s = bls_checks
    for name in ("MATHLIB_PAIR_FUSED", "MATHLIB_GROUP_FEXP"):
        monkeypatch.delenv(name, raising=False)
    if env:
        monkeypatch.setenv(*env)
    calls = []
    one = be.tw.f12_one.to(torch.int32)
    monkeypatch.setattr(be.pair, "products_miller",
                        lambda *a, **k: one.repeat(1, 1, 1, 1, 2))
    monkeypatch.setattr(be.pair, "product_miller", lambda *a, **k: one)
    monkeypatch.setattr(be.tw, "f12_final_exp", lambda f: calls.append("device") or f)
    monkeypatch.setattr(be.host, "final_exp", lambda v: calls.append("host") or v)
    assert be.pairing_product_is_one(g1s, g2s) is True
    assert be.pairing_products_are_one(g1s * 2, g2s * 2, 2) == [True, True]
    split = env == ("MATHLIB_PAIR_FUSED", "split")
    grouped = env == ("MATHLIB_GROUP_FEXP", "device")
    assert calls == ["device" if split else "host"] + (["device"] if grouped else ["host"] * 2)


def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    """On a tensor that is neither on the CPU nor usable by the kernels the
    wrappers raise before any launch (here: the meta device), and the plain
    versions launch nothing."""
    spec = get_spec("BN254")
    tw = TowerCtx(spec, "cpu")
    cfg, L = tw.kcfg, tw.fp.L
    meta = {"device": "meta", "dtype": torch.int32}
    f, T = torch.empty((2, 3, 2, L, 4), **meta), torch.empty((3, 2, L, 4), **meta)
    q, x = torch.empty((2, L, 4), **meta), torch.empty((L, 4), **meta)
    pc.reset_launches()
    fp_cuda.reset_launches()
    for call in (lambda: pc.miller_ft(cfg, x, x, q, q), lambda: pc.add_step(cfg, f, T, q, q, x, x),
                 lambda: pc.f12_pow(cfg, f, [1, 0, 1]), lambda: fp_cuda.fp_pow(tw.fp, x, [1]),
                 lambda: pc.final_exp(cfg, f, [1], [1], False), lambda: pc.final_exp(cfg, f)):
        with pytest.raises(ValueError):
            call()
    pc.f12_pow(cfg, _relaxed(spec, (2, 3, 2, 1), 10), [1, 1])
    assert set(pc.launches().values()) == {0} and set(fp_cuda.launches().values()) == {0}
