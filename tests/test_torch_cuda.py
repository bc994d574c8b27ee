"""The CUDA G1 kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (and nvcc), run this file on its own -- its imports need no jax, and the
repository's conftest (which imports jax) is left out:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (torch.equal on the limbs).
"""

import numpy as np
import pytest
import torch

from mathlib_tpu.curves.params import get_spec
from mathlib_tpu.host.engine import get_engine
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import g1_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(params=["BLS12_381", "BN254"])
def ctx(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(request.param)
    return get_engine(spec), G1Ctx(spec, torch.device("cuda"))


def _points(eng, g1, n, seed):
    rng = np.random.default_rng(seed)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 31)] + [None]
    return g1.encode_points([pool[i] for i in rng.integers(0, len(pool), n)])


def test_kernels_equal_plain_versions(ctx):
    eng, g1 = ctx
    F = g1.F
    n = 1000  # not a multiple of the block size
    P, Q = _points(eng, g1, n, 1), _points(eng, g1, n, 2)
    Q[..., ::9] = P[..., ::9]  # P == Q lanes
    g1_cuda.reset_launches()
    S = g1_cuda.add(F, P, Q)
    assert torch.equal(S, g1_cuda.add_plain(F, P, Q))
    assert torch.equal(g1_cuda.double(F, S), g1_cuda.double_plain(F, S))
    sel = torch.from_numpy(np.random.default_rng(5).random(n) < 0.8).to(S.device)
    assert torch.equal(g1_cuda.addsel(F, S, Q, sel), g1_cuda.addsel_plain(F, S, Q, sel))
    ks = g1.encode_scalars([0, 1, eng.spec.r - 1] + list(range(5, 5 + 29)))
    assert torch.equal(
        g1_cuda.smul(F, S[..., :32], ks, g1.nbits), g1_cuda.smul_plain(F, S[..., :32], ks, g1.nbits)
    )
    assert g1_cuda.launches() == {"add": 1, "double": 1, "addsel": 1, "smul": 1}


def test_leading_batch_dims_fold_into_lanes(ctx):
    eng, g1 = ctx
    F = g1.F
    P = _points(eng, g1, 2 * 3 * 5, 3).reshape(3, g1.fp.L, 2, 3, 5).movedim((0, 1), (-3, -2))
    Q = _points(eng, g1, 3 * 5, 4).reshape(3, g1.fp.L, 3, 5).movedim((0, 1), (-3, -2))
    # P: (2, 3, 3, L, 5); Q broadcasts over the leading 2
    sel = torch.from_numpy(np.random.default_rng(6).random((2, 3, 5)) < 0.5).to(P.device)
    assert torch.equal(g1_cuda.add(F, P, Q), g1_cuda.add_plain(F, *torch.broadcast_tensors(P, Q)))
    assert torch.equal(g1_cuda.addsel(F, P, Q, sel), g1_cuda.addsel_plain(F, P, Q, sel))
    assert torch.equal(g1_cuda.double(F, P), g1_cuda.double_plain(F, P))


def test_wrappers_refuse_what_the_kernels_do_not_take(ctx):
    _, g1 = ctx
    P = g1.gen
    with pytest.raises(ValueError):  # limb count other than the context's
        g1_cuda.add(g1.F, P[..., :-2, :], P[..., :-2, :])
    with pytest.raises(TypeError):
        g1_cuda.double(g1.F, P.to(torch.int64))
    odd = G1Ctx(get_spec("FP256BN"), P.device)  # p has L = 17
    with pytest.raises(ValueError):
        odd.add(odd.gen, odd.gen)
