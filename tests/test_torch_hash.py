"""The port's hash-to-G1 against the JAX package, on the CPU.

* ``hash_g1_plain`` and ``smul_static_plain`` against the reference's
  kernel bodies, limb for limb: ``tests/test_torch_hash_bodies.py`` (a file
  of its own, so that each stays near 25 s on one worker).
* The "be" sign and the ``sign="none"`` tensor pipeline with
  ``clear_cofactor`` (the ``smul_static`` plain path) against the
  reference's host hasher, canonically.
* ``sha256_device`` and the device ``expand_message_xmd`` against hashlib
  and the reference's host expansion; the numpy packers against the
  reference's, array for array.
* ``hash_to_g1_batch`` against RFC 9380 J.9.1 (the word and block paths,
  one message a call), the uniform 32-byte word path (which the reference's
  own tests leave out) and the mixed-length host path against the
  reference's host hasher, and
  ``hash_to_g1_bbs_batch`` so.

Nothing here jits the reference's XLA hash pipeline.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

import mathlib_tpu.ops.xmd as ref_xmd
from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.host import hash_to_curve as ref_h2c
from mathlib_tpu.host.curve import WeierstrassCurve
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.convert import to_numpy
from mathlib_tpu_torch.ops import hash as H
from mathlib_tpu_torch.ops import xmd
from mathlib_tpu_torch.ops.kernels import g1_cuda, hash_cuda
from test_hash_vectors import DST_G1, G1_VECTORS, MSGS

torch.set_num_threads(1)

SPEC = get_spec("BLS12_381")
P = SPEC.p
# a nonzero u with t2 = Z u^2 (Z u^2 + 1) = 0: u^2 = -1/Z (Z = 11)
U_T2_ZERO = pow(-pow(11, -1, P) % P, (P + 1) // 4, P)
EDGE0 = [0, 1, P - 1, U_T2_ZERO]
EDGE1 = [1, 0, 7, P - U_T2_ZERO]


@pytest.fixture(scope="module")
def ctx():
    return H.get_hash_g1_ctx(SPEC, "cpu")


@pytest.fixture(scope="module")
def ref_hasher():
    return ref_h2c.get_hasher(ref_get_spec("BLS12_381"))


def _lanes(n_rand, seed):
    rng = random.Random(seed)
    return (EDGE0 + [rng.randrange(P) for _ in range(n_rand)],
            EDGE1 + [rng.randrange(P) for _ in range(n_rand)])


def _host_map(hasher, u, sign):
    """The host SSWU map of u with the given sign fix, as the reference's
    hasher computes it (``_sswu_no_sign``, then sgn0 or the BE sign)."""
    m = hasher._g1_sswu[0]
    x, y = hasher._sswu_no_sign(m, u)
    if sign == "none":
        return x, y
    s = (lambda z: z & 1) if sign == "parity" else (lambda z: (P - z) % P >= z)
    return (x, (P - y) % P) if s(y) != s(u) else (x, y)


def _host_hash(hasher, u0, u1, sign):
    """iso(map(u0) + map(u1) on E'), cofactor-cleared, on the reference's host."""
    m, isod = hasher._g1_sswu
    F = hasher.e.fp_ops
    Ep = WeierstrassCurve(F, m.A, m.B)
    Q = Ep.add(_host_map(hasher, u0, sign), _host_map(hasher, u1, sign))
    return hasher._clear_cofactor_g1(ref_h2c.apply_isogeny(F, isod, Q))


def test_signs_and_the_tensor_pipeline_equal_the_reference_host_hasher(ctx, ref_hasher):
    """"be" through the kernel's plain version, and "none" through the
    tensor pipeline and clear_cofactor (h_eff on the ``smul_static`` plain
    path), canonically, on the edge lanes and two random ones."""
    us0, us1 = _lanes(2, 7)
    u0, u1 = ctx.fp.encode(us0), ctx.fp.encode(us1)
    got = ctx.g1.decode_points(hash_cuda.hash_g1(ctx, u0, u1, "be"))
    assert got == [_host_hash(ref_hasher, a, b, "be") for a, b in zip(us0, us1)]
    got = ctx.g1.decode_points(ctx.hash_to_g1(u0, u1, "none"))
    assert got == [_host_hash(ref_hasher, a, b, "none") for a, b in zip(us0, us1)]


def _sha_pad(msg: bytes) -> np.ndarray:
    n = xmd._pad_to_blocks(len(msg))
    buf = np.zeros((1, 64 * n), np.uint8)
    buf[0, : len(msg)] = np.frombuffer(msg, np.uint8)
    buf[0, len(msg)] = 0x80
    buf[0, -8:] = np.frombuffer((8 * len(msg)).to_bytes(8, "big"), np.uint8)
    return xmd._bytes_to_words(buf)


def test_sha256_xmd_and_packers_equal_hashlib_and_the_reference():
    for msg in (b"", b"abc", b"x" * 55, b"y" * 56, b"z" * 64, bytes(range(119))):
        st = xmd.sha256_device(xmd.to_device_words(_sha_pad(msg), "cpu"))
        got = b"".join(int(v).to_bytes(4, "big") for v in st[:, 0])
        assert got == hashlib.sha256(msg).digest(), msg
    dst = b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_"
    for msgs in ([b"m" * 32, bytes(range(32)), b"\xff" * 32], [b"", b""], [b"abc", b"xyz"]):
        mlen = len(msgs[0])
        blocks = xmd.pack_b0_blocks(msgs, dst, 128)
        np.testing.assert_array_equal(blocks, ref_xmd.pack_b0_blocks(msgs, dst, 128))
        np.testing.assert_array_equal(xmd.b0_template(mlen, dst, 128),
                                      ref_xmd.b0_template(mlen, dst, 128))
        if mlen and mlen % 4 == 0:
            words = xmd.pack_msg_words(msgs, mlen)
            np.testing.assert_array_equal(words, ref_xmd.pack_msg_words(msgs, mlen))
            dev = xmd.b0_blocks_device(xmd.to_device_words(words, "cpu"),
                                       xmd.b0_template(mlen, dst, 128), mlen)
            np.testing.assert_array_equal(to_numpy(dev), blocks)
        tmpls = [xmd._bi_template(dst, i) for i in range(1, 5)]
        for i, t in enumerate(tmpls, 1):
            np.testing.assert_array_equal(t, ref_xmd._bi_template(dst, i))
        uni = xmd.xmd_sha256_device(xmd.to_device_words(blocks, "cpu"), tmpls)
        for j, m in enumerate(msgs):
            got = b"".join(int(v).to_bytes(4, "big") for v in uni[:, j])
            assert got == ref_h2c.expand_message_xmd(m, dst, 128)
        fp = H.get_hash_g1_ctx(SPEC, "cpu").fp
        us = xmd.hash_to_field_device(fp, xmd.to_device_words(blocks, "cpu"), dst, 2, 64)
        want = [ref_h2c.hash_to_field_fp(m, dst, P, 2, 64) for m in msgs]
        assert [list(fp.decode(u)) for u in us] == [[w[i] for w in want] for i in range(2)]


@pytest.mark.parametrize("i", range(3))
def test_hash_to_g1_batch_meets_rfc9380_j91(i):
    """b"" and b"abc" take the block path, b"abcdef0123456789" the word path."""
    ctx = H.get_hash_g1_ctx(SPEC, "cpu")
    hash_cuda.reset_launches()
    out = H.hash_to_g1_batch(SPEC, [MSGS[i]], DST_G1, device="cpu")
    assert ctx.g1.decode_points(out) == [G1_VECTORS[i]]
    assert hash_cuda.launches() == {"hash_g1": 0}  # the plain version ran


def test_word_block_and_host_paths_equal_the_reference_host_hasher(ctx, ref_hasher):
    dst = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
    rng = np.random.default_rng(3)
    for msgs in ([rng.bytes(32) for _ in range(3)],  # uniform 32-byte word path
                 [b"msg-%d" % i for i in (1, 10, 100)]):  # mixed lengths: host hash_to_field
        got = ctx.g1.decode_points(H.hash_to_g1_batch(SPEC, msgs, dst, device="cpu"))
        assert got == [ref_hasher.hash_to_g1(m, dst) for m in msgs]


def test_bbs_batch_equals_the_reference_host_hasher(ctx, ref_hasher):
    msgs = [b"", b"bbs message", b"m" * 100]
    got = ctx.g1.decode_points(H.hash_to_g1_bbs_batch(SPEC, msgs, b"BBS-DST", device="cpu"))
    assert got == [ref_hasher.hash_to_g1_bbs(m, b"BBS-DST") for m in msgs]


def test_gate_and_refusals(ctx):
    for curve in ("BN254", "BLS12_377"):
        with pytest.raises(ValueError):
            H.HashG1Ctx(get_spec(curve), "cpu")
    u = ctx.fp.encode([1, 2])
    with pytest.raises(ValueError):
        hash_cuda.hash_g1(ctx, u, u, "none")
    with pytest.raises(ValueError):
        hash_cuda.hash_g1(ctx, u, u[:, :1])
    with pytest.raises(TypeError):
        hash_cuda.hash_g1(ctx, u.to(torch.int64), u.to(torch.int64))
    with pytest.raises(ValueError):
        hash_cuda.hash_g1(ctx, u.to("meta"), u.to("meta"))
    with pytest.raises(ValueError):
        g1_cuda.smul_static(ctx.g1.F, ctx.g1.gen.to("meta"), ctx.h_bits)
    with pytest.raises(ValueError):
        ctx.sswu(u, "sgn")
