"""The port's row gathers (``gather_cuda``: ``gather_rows``, ``gather_rows_t``)
against the JAX package's ``gather_rows_pallas`` and ``gather_rows_t_pallas``
run in interpret mode, on the CPU, exactly; and the MSM scan's use of
``gather_rows_t``.

The tables are numpy-seeded uint32 words: (64, 72) (a projective BLS12-381
point row) and (64, 48) (an affine one), M = 16 indices with the reference's
block of 8, one index repeated.  ``msm_totals`` itself is held to the
reference with the gather on its path by ``tests/test_torch_msm.py`` and
``tests/test_torch_msm_options.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathlib_tpu.ops.kernels.gather_pallas import gather_rows_pallas, gather_rows_t_pallas
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops import msm as M
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import gather_cuda

torch.set_num_threads(1)


def _inputs(wr: int, idx_dtype):
    rng = np.random.default_rng(wr)
    table = rng.integers(0, 2**32, (64, wr), dtype=np.uint32)
    idx = rng.integers(0, 64, 16).astype(np.int32)
    idx[9] = idx[2]  # a repeated index
    return table, idx, torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx).to(idx_dtype)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("wr", [72, 48])
def test_gathers_equal_the_reference_kernels(wr, idx_dtype):
    table, idx, t, i = _inputs(wr, idx_dtype)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx), blk=8,
                                         interpret=True))
    want_t = np.asarray(gather_rows_t_pallas(jnp.asarray(table), jnp.asarray(idx), blk=8,
                                             interpret=True))
    got, got_t = gather_cuda.gather_rows(t, i), gather_cuda.gather_rows_t(t, i)
    assert got.shape == (16, wr) and got_t.shape == (wr, 16) and got_t.is_contiguous()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got_t.numpy().view(np.uint32), want_t)


def test_gathers_refuse_what_the_kernels_do_not_take():
    """A table off the CPU and off a card, indices on another device, a
    non-integer index: ValueError before any launch."""
    gather_cuda.reset_launches()
    meta = torch.empty((64, 72), dtype=torch.int32, device="meta")
    for fn in (gather_cuda.gather_rows, gather_cuda.gather_rows_t):
        with pytest.raises(ValueError):
            fn(meta, torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="idx"):
        gather_cuda._check(meta, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="idx"):
        gather_cuda._check(meta, torch.zeros(4, dtype=torch.float32, device="meta"))
    assert gather_cuda.launches() == {"gather_rows": 0, "gather_rows_t": 0}


def test_msm_scan_gathers_through_gather_rows_t(monkeypatch):
    """Each of the K scan steps and the carry fix-up gather through
    ``gather_rows_t`` (a recorder around the plain version); the result is
    the host engine's MSM."""
    spec = get_spec("BN254")
    eng, g1 = get_engine(spec), G1Ctx(spec, "cpu")
    rng = np.random.default_rng(3)
    pts = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 16)]
    ks = [int(k) for k in rng.integers(0, 1 << 62, 16)]
    calls = []
    plain = gather_cuda.gather_rows_t

    def recorder(table, idx):
        calls.append((tuple(table.shape), idx.shape[0]))
        return plain(table, idx)

    monkeypatch.setattr(M, "gather_rows_t", recorder)
    got = M.msm_totals(g1, g1.encode_points(pts), g1.encode_scalars(ks), c=4, K=4)
    W, R = M.n_windows(g1, 4), 3 * g1.fp.L
    assert calls[:4] == [((16, R), W * 4)] * 4  # the 4 steps: W windows x 4 chunks
    assert len(calls) == 5 and calls[4][0] == (W * 16, R)  # the carries: the bucket table
    assert M.horner_host(g1, got, 4) == eng.g1.msm(pts, ks)
