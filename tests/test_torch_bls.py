"""``BatchEngine``'s BLS entry points on the CPU (min-signature layout:
signatures in G1, public keys in G2).

* ``bls_sign_batch`` on 4 messages equals [sk] H(m) by the reference's host
  hasher and host engine: on BLS12-381 through the device hash (the
  ``hash_g1`` plain version), the ``smul`` ladder and the affine exit; on
  BN254 (outside the device hash's gate) through the port's host hasher and
  ``g1_scalar_mul``.
* ``bls_verify_batch`` gives True on those signatures and False after
  tampering (one message changed on BLS12-381, one signature replaced on
  BN254): the two weighted MSMs and the two-pair product check.  The BN254
  case runs from ``tests/test_torch_bls_bn254.py``, so that each file stays
  near 25 s on one worker.
* ``hash_to_g1_batch`` and ``hash_to_g1_bbs_batch`` of the engine equal the
  reference's host hasher, and refuse curves outside the gate.
"""

import pytest
import torch

from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host.engine import HostEngine as RefHostEngine
from mathlib_tpu.host.hash_to_curve import get_hasher as ref_get_hasher
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine

torch.set_num_threads(1)

DST = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
MSGS = [b"msg-%d" % i for i in (0, 1, 22, 333)]  # mixed lengths: the host hash_to_field path
SK = 0x1D3F5A7C9B2E4D6F8A1C3E5B7D9F2A4C6E8B1D3F5A7C9B2E


def check_sign_verify_tamper(curve):
    """Sign 4 messages, verify them, and verify after tampering."""
    spec = get_spec(curve)
    be = BatchEngine(spec, "cpu")
    eng = get_engine(spec)
    ref_spec = ref_get_spec(curve)
    ref_eng, ref_hasher = RefHostEngine(ref_spec), ref_get_hasher(ref_spec)
    msgs = [bytes(32), b"\x01" * 32, b"signing root 2".ljust(32, b"."), b"\xfe" * 32] \
        if curve == "BLS12_381" else MSGS
    sigs = be.bls_sign_batch(SK, msgs, DST)
    assert sigs == [ref_eng.g1.mul(ref_hasher.hash_to_g1(m, DST), SK) for m in msgs]
    pk = eng.g2.mul(eng.gen_g2, SK)
    assert be.bls_verify_batch(pk, sigs, msgs, DST) is True
    if curve == "BLS12_381":
        assert be.bls_verify_batch(pk, sigs, msgs[:3] + [b"\xfd" * 32], DST) is False
    else:
        bad = sigs[:2] + [eng.g1.mul(sigs[2], 2)] + sigs[3:]
        assert be.bls_verify_batch(pk, bad, msgs, DST) is False


def test_sign_then_verify_and_tampering():
    check_sign_verify_tamper("BLS12_381")  # BN254: test_torch_bls_bn254.py


def test_engine_hash_entry_points_equal_the_reference_host_hasher():
    spec = get_spec("BLS12_381")
    be = BatchEngine(spec, "cpu")
    hasher = ref_get_hasher(ref_get_spec("BLS12_381"))
    msgs = [b"", b"bbs"]
    assert be.g1.decode_points(be.hash_to_g1_bbs_batch(msgs, b"DST")) == [
        hasher.hash_to_g1_bbs(m, b"DST") for m in msgs]
    msgs = MSGS[:2]
    assert be.g1.decode_points(be.hash_to_g1_batch(msgs, DST)) == [
        hasher.hash_to_g1(m, DST) for m in msgs]
    assert be._device_hash_ctx() is not None
    bn = BatchEngine(get_spec("BN254"), "cpu")
    assert bn._device_hash_ctx() is None
    with pytest.raises(ValueError):
        bn.hash_to_g1_batch(msgs, DST)
