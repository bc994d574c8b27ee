"""Moving data between the reference and the port, and the port's edges:
constants equal to the reference's, round trips, the device helper, the
kernel wrappers' refusals, and a port that never loads jax."""

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
from mathlib_tpu_torch.ops.kernels import build, g1_cuda

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
    with pytest.raises(ValueError):
        mathlib_tpu_torch.device("tpu")
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


def test_plain_versions_launch_nothing():
    g1 = G1Ctx(get_spec("BLS12_381"), "cpu")
    g1_cuda.reset_launches()
    g1.add_select(g1.gen, g1.gen, torch.ones(1, dtype=torch.bool))
    assert g1_cuda.launches() == {"add": 0, "double": 0, "addsel": 0, "smul": 0}


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
    """Importing the port leaves jax unloaded (run apart: conftest loads jax)."""
    code = (
        "import sys\n"
        "import mathlib_tpu_torch.convert, mathlib_tpu_torch.ops.msm\n"
        "import mathlib_tpu_torch.ops.kernels.build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300)
