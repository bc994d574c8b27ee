"""The plain versions of the two G2 ladder kernels against the reference's
kernel bodies, and ``BatchEngine.g2_scalar_mul`` against the host engine, on
the CPU (tolerance: zero).

* ``g2_cuda.smul_plain`` against ``g2_pallas._g2_smul_kernel`` and
  ``smul_static_plain`` against ``_g2_smul_static_kernel``, run on numpy rows
  (``tests/_torch_ref_bodies.py``), limb for limb, with short bit strings (a
  full 255-bit body takes minutes on numpy rows): k = 0 and Q = infinity
  among the lanes, relaxed inputs.
* ``BatchEngine(spec, "cpu").g2_scalar_mul`` at the full r.bit_length() bits
  on a few lanes against the host engine's ``mul``: on BLS12-381 the
  ``g2_smul`` kernel's plain version, on BN254 the reference's scan of
  ``dbl_add_select`` over ``weier``.
"""

import random

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.kernels.g1_pallas as ref_g1p
import mathlib_tpu.ops.kernels.g2_pallas as ref_g2p
from _torch_ref_bodies import Ref, numpy_kernel_bodies
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.convert import to_numpy
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.g2 import G2Ctx
from mathlib_tpu_torch.ops.kernels import g2_cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bls():
    spec = get_spec("BLS12_381")
    eng, g2 = get_engine(spec), G2Ctx(spec, "cpu")
    rng = random.Random(21)
    pts = [eng.g2.mul(eng.gen_g2, rng.randrange(1, spec.r)) for _ in range(5)] + [None]
    # relaxed limbs: each point plus the generator, by the plain add
    Q = g2_cuda.add_plain(g2.rows, g2.encode_points(pts), g2.encode_points([eng.gen_g2] * 6))
    return eng, g2, Q, [eng.g2.add(P, eng.gen_g2) for P in pts]


def _one_limbs(g2):
    p, L = g2.spec.p, g2.fp.L
    R = 1 << (16 * L)
    return tuple(((R % p) >> (16 * k)) & 0xFFFF for k in range(L))


def _q_rows(g2, Q):
    a = to_numpy(Q)
    return a.reshape(3, 2 * g2.fp.L, 1, a.shape[-1])


def test_smul_plain_is_bit_equal_to_the_reference_body(bls):
    eng, g2, Q, host = bls
    Q = torch.cat([Q, g2.inf], dim=-1)  # Q = infinity on the last lane
    host = host + [None]
    nbits = 7
    ks = [0, 1, (1 << nbits) - 1, 0b1011001, 0b0100101, 77, 100]
    S = g2.encode_scalars(ks)
    out = np.zeros_like(_q_rows(g2, Q))
    rows = ref_g2p.Row2Ctx(g2.spec.p, g2.fp.L, g2.rows.b3, ref_g1p._mm_stacked)
    with numpy_kernel_bodies(ref_g1p, ref_g2p):
        ref_g2p._g2_smul_kernel(rows, _one_limbs(g2), nbits, Ref(to_numpy(S)[:, None, :]),
                                Ref(_q_rows(g2, Q)), Ref(out))
    got = g2_cuda.smul_plain(g2.rows, Q, S, nbits)
    np.testing.assert_array_equal(to_numpy(got), out.reshape(got.shape))
    assert g2.decode_points(got) == [eng.g2.mul_any(P, k) for P, k in zip(host, ks)]


def test_smul_static_plain_is_bit_equal_to_the_reference_body(bls):
    eng, g2, Q, host = bls
    k = 0b1011011
    bits = np.array([int(b) for b in bin(k)[2:]], dtype=np.uint32)
    out = np.zeros_like(_q_rows(g2, Q))
    rows = ref_g2p.Row2Ctx(g2.spec.p, g2.fp.L, g2.rows.b3, ref_g1p._mm_stacked)
    with numpy_kernel_bodies(ref_g1p, ref_g2p):
        ref_g2p._g2_smul_static_kernel(rows, _one_limbs(g2), len(bits), Ref(bits),
                                       Ref(_q_rows(g2, Q)), Ref(out))
    got = g2_cuda.smul_static(g2.rows, Q, bits)
    np.testing.assert_array_equal(to_numpy(got), out.reshape(got.shape))
    assert g2.decode_points(got) == [eng.g2.mul_any(P, k) for P in host]


@pytest.mark.parametrize("name", ["BLS12_381", "BN254"])
def test_batch_engine_g2_scalar_mul_at_full_width(name):
    spec = get_spec(name)
    eng = get_engine(spec)
    be = BatchEngine(spec, "cpu")
    rng = random.Random(5)
    pts = [eng.g2.mul(eng.gen_g2, rng.randrange(1, spec.r)), eng.gen_g2, None]
    ks = [spec.r - 1, 0, rng.randrange(spec.r)]
    assert be.g2_scalar_mul(pts, ks) == [eng.g2.mul_any(P, k) for P, k in zip(pts, ks)]
