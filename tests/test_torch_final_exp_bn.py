"""BN254's final exponentiation on the CPU against the JAX package.

``TowerCtx.f12_final_exp`` is one ``final_exp`` call on BN curves (the
easy part, one cyclotomic chain a base-p digit of the hard exponent, their
Frobenius folds); on CPU tensors it runs the plain version,
``final_exp_bn_plain``.  On 2 lanes of Miller values it equals the
reference's host final exp (``mathlib_tpu/host/fields.py f12_final_exp``)
as values mod p, and the kernel's script with the full digits, emulated on
Python integers (``fexp_prog.emulate``), equals it limb for limb.  The
reference's final exp is not jitted.  The kernel itself runs on the card:
``tests/test_torch_cuda.py``.
"""

import numpy as np
import torch

import mathlib_tpu.curves.params as ref_params
import mathlib_tpu.host.fields as ref_fields
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import fexp_prog
from mathlib_tpu_torch.ops.kernels import pairing_cuda as pc
from mathlib_tpu_torch.ops.tower import TowerCtx
from test_torch_final_exp import _ref_spec

torch.set_num_threads(1)


def test_final_exp_bn_equals_the_reference_host_final_exp():
    """BN254: ``TowerCtx.f12_final_exp`` on 2 lanes of Miller values (the
    port's host engine's) is one ``final_exp`` call, whose plain version
    (``final_exp_bn_plain``) equals the reference's host final exp as values
    mod p; the kernel's script with the full digits, emulated at the block
    of a 1,024-lane call, equals it limb for limb on lane 0."""
    spec = get_spec("BN254")
    eng, tw = get_engine(spec), TowerCtx(spec, "cpu")
    vals = [eng.miller_loop([(eng.g1.mul(eng.gen_g1, a), eng.g2.mul(eng.gen_g2, b))])
            for a, b in ((5, 7), (11, 3))]
    f = torch.cat([tw.f12_encode(v) for v in vals], dim=-1)
    pc.reset_launches()
    got = tw.f12_final_exp(f)
    ref = ref_fields.Tower(_ref_spec(spec, ref_params.SerFormat.GNARK))
    assert tw.f12_decode(got) == [ref.f12_final_exp(v) for v in vals]
    assert set(pc.launches().values()) == {0}  # the CPU runs the plain version
    kcfg, p, L = tw.kcfg, spec.p, tw.fp.L
    G, _ = pc.fexp_shape(kcfg, "final_exp_bn", 1024)
    progs = dict(zip(fexp_prog.BN_PROGRAMS, pc.fexp_programs(kcfg, "final_exp_bn", G)[0]))
    weights = np.array([1 << (16 * k) for k in range(L)], dtype=object)

    def lane0(t):  # (2, 3, 2, L, B) limbs -> lane 0's 12 integers
        return list(t[..., 0].reshape(12, L).to(torch.int64).numpy().astype(object) @ weights)

    gammas = list(kcfg.gammas[..., 0].reshape(36, L).to(torch.int64).numpy().astype(object)
                  @ weights)
    emulated = fexp_prog.emulate(progs, fexp_prog.fexp_bn_steps(kcfg.digit_bits), [lane0(f)],
                                 fexp_prog.F, fexp_prog.F, p, L, kcfg.inv_bits, gammas)
    assert emulated == [lane0(got)]
