"""Moving data between the reference and the port, and the port's edges:
constants equal to the reference's, round trips, the device helper, the
kernel wrappers' refusals, and a port that never loads jax."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.ops.field import FpCtx as RefFpCtx
from mathlib_tpu.ops.g1 import get_g1_ctx
import mathlib_tpu_torch
from mathlib_tpu_torch.convert import check_constants, to_numpy, to_torch
from mathlib_tpu_torch.ops.field import FpCtx
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.g2 import G2Ctx
from mathlib_tpu_torch.ops.kernels import build, g1_cuda, g2_cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ["BLS12_381", "BN254", "BLS12_377", "FP256BN"]


def test_round_trip_keeps_every_bit():
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(3, 24, 9), dtype=np.uint32)
    words = rng.integers(0, 1 << 32, size=(5, 7), dtype=np.uint64).astype(np.uint32)
    for arr in (limbs, words, np.array([0, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)):
        t = to_torch(arr, "cpu")
        assert t.dtype == torch.int32 and t.shape == arr.shape
        back = to_numpy(t)
        assert back.dtype == np.uint32
        np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(to_numpy(to_torch(limbs, "cpu").to(torch.int64)), limbs)


@pytest.mark.parametrize("curve", CURVES)
def test_field_constants_equal_reference(curve):
    spec = get_spec(curve)
    for p in (spec.p, spec.r):
        check_constants(FpCtx(p, "cpu"), RefFpCtx(p))


@pytest.mark.parametrize("curve", CURVES)
def test_g1_constants_equal_reference(curve):
    spec = get_spec(curve)
    check_constants(G1Ctx(spec, "cpu"), get_g1_ctx(spec))


def test_check_constants_reports_a_mismatch():
    spec = get_spec("BN254")
    port = FpCtx(spec.p, "cpu")
    port.one_mont = port.one_mont + 1
    with pytest.raises(ValueError, match="one_mont"):
        check_constants(port, RefFpCtx(spec.p))


def test_device_helper_never_hands_back_another_device():
    assert mathlib_tpu_torch.device("cpu") == torch.device("cpu")
    assert mathlib_tpu_torch.device(torch.device("cpu")) == torch.device("cpu")
    for kind in ("tpu", "cuda:0", torch.device("meta")):
        with pytest.raises(ValueError):
            mathlib_tpu_torch.device(kind)
    if torch.cuda.is_available():
        assert mathlib_tpu_torch.device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            mathlib_tpu_torch.device("cuda")


def test_kernel_wrappers_refuse_other_devices():
    g1 = G1Ctx(get_spec("BLS12_381"), "cpu")
    P = g1.gen.to("meta")
    with pytest.raises(ValueError):
        g1_cuda.add(g1.F, P, P)
    with pytest.raises(ValueError):
        g1_cuda.double(g1.F, P)
    with pytest.raises(ValueError):
        g1_cuda.addsel(g1.F, P, P, torch.ones(1, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        g1_cuda.smul(g1.F, P, g1.encode_scalars([3]).to("meta"), g1.nbits)
    sel = torch.ones(1, dtype=torch.bool, device="meta")
    for fn, args in ((g1_cuda.dbladd, (P, P, sel)), (g1_cuda.addselneg, (P, P, sel, sel)),
                     (g1_cuda.maddsel, (P, P[:2], sel)), (g1_cuda.maddselneg, (P, P[:2], sel, sel)),
                     (g1_cuda.smul_static, (P, [1, 0, 1]))):
        with pytest.raises(ValueError):
            fn(g1.F, *args)
    g2 = G2Ctx(get_spec("BLS12_381"), "cpu")
    Q = g2.gen.to("meta")
    for fn, args in ((g2_cuda.add, (Q, Q)), (g2_cuda.double, (Q,)), (g2_cuda.addsel, (Q, Q, sel)),
                     (g2_cuda.dblsel, (Q, Q, sel)),
                     (g2_cuda.smul, (Q, g2.encode_scalars([3]).to("meta"), g2.nbits)),
                     (g2_cuda.smul_static, (Q, [1, 0, 1]))):
        with pytest.raises(ValueError):
            fn(g2.rows, *args)


def test_plain_versions_launch_nothing():
    g1 = G1Ctx(get_spec("BLS12_381"), "cpu")
    g1_cuda.reset_launches()
    one = torch.ones(1, dtype=torch.bool)
    g1.add_select(g1.gen, g1.gen, one)
    g1.dbl_add_select(g1.gen, g1.gen, one)
    g1.add_select_neg(g1.gen, g1.gen, one, one)
    g1.madd_select(g1.gen, g1.gen[:2], one)
    g1.madd_select_neg(g1.gen, g1.gen[:2], one, one)
    g1_cuda.smul_static(g1.F, g1.gen, [1, 1])
    assert g1_cuda.launches() == {"add": 0, "double": 0, "addsel": 0, "smul": 0, "dbladd": 0,
                                  "addselneg": 0, "maddsel": 0, "maddselneg": 0,
                                  "smul_static": 0}
    g2 = G2Ctx(get_spec("BLS12_381"), "cpu")
    g2_cuda.reset_launches()
    g2.add_select(g2.gen, g2.gen, one)
    g2.dbl_add_select(g2.gen, g2.inf, one)
    g2_cuda.smul(g2.rows, g2.gen, g2.encode_scalars([5]), 3)
    g2_cuda.smul_static(g2.rows, g2.gen, [1, 1])
    assert g2_cuda.launches() == {"g2_add": 0, "g2_double": 0, "g2_addsel": 0, "g2_dblsel": 0,
                                  "g2_smul": 0, "g2_smul_static": 0}


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(0o755)
    return str(nvcc)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "LIB", str(tmp_path / "out" / "lib.so"))
    monkeypatch.setattr(build, "BUILD_LOG", str(tmp_path / "out" / "build.log"))
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no such intrinsic' >&2; exit 2")
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build()
    assert not os.path.exists(build.LIB)


def test_library_is_stale_when_a_source_is_newer(tmp_path, monkeypatch):
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(build, "LIB", str(lib))
    assert build._stale()
    lib.write_bytes(b"")
    deps = os.listdir(build.CSRC)
    newest = max(os.path.getmtime(os.path.join(build.CSRC, f)) for f in deps)
    os.utime(lib, (newest + 10, newest + 10))
    assert not build._stale()
    os.utime(lib, (newest - 10, newest - 10))
    assert build._stale()


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py as a module,
    leaves both jax and the JAX package unloaded (run apart: conftest loads
    jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mathlib_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mathlib_tpu_torch.__path__,\n"
        "                                               'mathlib_tpu_torch.')]\n"
        "assert 'mathlib_tpu_torch.batch' in names and len(names) > 15, names\n"
        "new = {'mathlib_tpu_torch.' + m for m in ('ops.hash', 'ops.xmd', 'ops.kernels.hash_cuda',\n"
        "                                        'host.hash_to_curve', 'curves.isogeny_data',\n"
        "                                        'ops.g2', 'ops.kernels.g2_cuda', 'api',\n"
        "                                        'host.serialize')}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mathlib_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_nothing_of_the_reference():
    """No .py file of the port, and not chip_smoke.py, imports jax or the
    JAX package, at any depth of the code (an AST scan)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mathlib_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for name in ("api.py", os.path.join("host", "serialize.py")):
        assert os.path.join(REPO, "mathlib_tpu_torch", name) in files, name
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mathlib_tpu"), (path, mod)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument every context runs on the card, and raises
    where torch sees none; "cpu" must be asked for by name."""
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.ops.hash import HashG1Ctx, HashG2Ctx
    from mathlib_tpu_torch.ops.pairing import PairingCtx
    from mathlib_tpu_torch.ops.tower import TowerCtx

    spec = get_spec("BN254")
    bls = get_spec("BLS12_381")
    ctors = [lambda d=None: FpCtx(spec.p, d), lambda d=None: G1Ctx(spec, d),
             lambda d=None: TowerCtx(spec, d), lambda d=None: PairingCtx(spec, d),
             lambda d=None: BatchEngine(spec, d), lambda d=None: HashG1Ctx(bls, d),
             lambda d=None: G2Ctx(spec, d), lambda d=None: HashG2Ctx(bls, d)]
    for ctor in ctors:
        assert ctor("cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctor in ctors:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctor()
