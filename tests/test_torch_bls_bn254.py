"""``BatchEngine``'s BLS sign and verify on BN254, outside the device hash's
gate: the port's host hasher, ``g1_scalar_mul``, two ``g1_msm`` and the
two-pair product check, on the CPU (the checks of ``tests/test_torch_bls.py``
on the other curve, in a file of its own to spread the suite's workers)."""

import torch

from test_torch_bls import check_sign_verify_tamper

torch.set_num_threads(1)


def test_sign_then_verify_and_tampering_bn254():
    check_sign_verify_tamper("BN254")
