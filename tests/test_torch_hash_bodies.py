"""The plain versions of the hash path's two kernels against the
reference's kernel bodies, on the CPU, limb for limb (tolerance: zero).

* ``hash_g1_plain`` against ``hash_pallas._hash_g1_kernel`` run on numpy
  rows (the stand-ins of ``tests/test_hash_pallas.py``): B = 8, sign
  "parity", the edge lanes u = 0, 1, p - 1 and a nonzero u with t2 = 0
  first, the constants from the reference's isogeny data.
* ``smul_static_plain`` against ``g1_pallas._smul_static_kernel``, and
  canonically against the host engine.

The rest of the hash path is held by ``tests/test_torch_hash.py``.
"""

import numpy as np
import torch

import mathlib_tpu.ops.kernels.g1_pallas as ref_g1p
import mathlib_tpu.ops.kernels.hash_pallas as ref_hp
from _torch_ref_bodies import Ref, numpy_kernel_bodies
from mathlib_tpu.curves import isogeny_data as ref_isogeny_data
from mathlib_tpu.curves.params import get_spec as ref_get_spec
from mathlib_tpu.ops.kernels.fp_rows import RowCtx
from mathlib_tpu_torch.convert import to_numpy
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.kernels import g1_cuda, hash_cuda
from test_torch_hash import P, SPEC, _lanes, ctx  # noqa: F401  (ctx: the fixture)

torch.set_num_threads(1)


def _mont_rows(vals, L):
    """Host ints -> (L, len) uint32 Montgomery limbs (R = 2^(16 L))."""
    R = 1 << (16 * L)
    return np.array([[((v % P) * R % P >> (16 * k)) & 0xFFFF for v in vals] for k in range(L)],
                    dtype=np.uint32)


def test_hash_g1_plain_is_bit_equal_to_the_reference_body(ctx):
    """One run of the body, B = 8, sign "parity", the edge lanes first; its
    constants from the reference's isogeny data."""
    L = ctx.fp.L
    iso = ref_isogeny_data.G1["BLS12_381"]
    A, B, Z = iso["A"], iso["B"], iso["Z"]

    def limbs(v):
        return tuple(int(w) for w in _mont_rows([v], L)[:, 0])

    C = {"sign": "parity", "one_limbs": limbs(1), "Z": limbs(Z), "A": limbs(A), "B": limbs(B),
         "negB_over_A": limbs(-B * pow(A, -1, P)), "B_over_ZA": limbs(B * pow(Z * A, -1, P)),
         "iso": tuple(tuple(limbs(c) for c in cs) for cs in iso["iso"])}
    x = ref_get_spec("BLS12_381").x
    h_bits = np.array([int(b) for b in bin(abs(1 - x))[2:]], dtype=np.uint32)
    inv_bits, sqrt_bits = (np.asarray(b, dtype=np.uint32) for b in hash_cuda.chain_bits(P))
    us0, us1 = _lanes(4, 0xA5)
    u0, u1 = _mont_rows(us0, L), _mont_rows(us1, L)
    nlanes = len(us0)
    out = np.zeros((3, L, 1, nlanes), np.uint32)
    with numpy_kernel_bodies(ref_g1p, ref_hp):  # the stacked products: the kernel's default
        ref_hp._hash_g1_kernel(
            RowCtx(P, L), 3 * SPEC.b % P, C, len(inv_bits), len(sqrt_bits), len(h_bits), 1 - x < 0,
            ref_g1p._mm_stacked, Ref(inv_bits), Ref(sqrt_bits), Ref(h_bits),
            Ref(u0[:, None, :]), Ref(u1[:, None, :]), Ref(out),
            Ref(np.zeros((L, 4, nlanes), np.uint32)))
    got = hash_cuda.hash_g1_plain(ctx, torch.from_numpy(u0.astype(np.int32)),
                                  torch.from_numpy(u1.astype(np.int32)), "parity")
    np.testing.assert_array_equal(to_numpy(got), out[:, :, 0, :])


def test_smul_static_plain_is_bit_equal_to_the_reference_body(ctx):
    """A 20-bit static scalar on 4 relaxed lanes, one of them infinity (h_eff
    itself runs in the "none" pipeline below)."""
    g1, eng = ctx.g1, get_engine(SPEC)
    pts = [eng.g1.mul(eng.gen_g1, k) for k in (5, 77, 2**200 + 3)] + [None]
    Q = g1.add(g1.encode_points(pts), g1.encode_points(pts[1:] + pts[:1]))  # relaxed
    L = g1.fp.L
    k = 0b10110001110000101101
    bits = np.array([int(b) for b in bin(k)[2:]], dtype=np.uint32)
    R = 1 << (16 * L)
    one = tuple(((R % P) >> (16 * i)) & 0xFFFF for i in range(L))
    q = to_numpy(Q)[:, :, None, :]
    out = np.zeros_like(q)
    with numpy_kernel_bodies(ref_g1p):
        ref_g1p._smul_static_kernel(RowCtx(P, L), g1.F.b3, one, len(bits), Ref(bits), Ref(q),
                                    Ref(out), mm=ref_g1p._mm_serial)
    got = g1_cuda.smul_static(g1.F, Q, bits)
    np.testing.assert_array_equal(to_numpy(got), out[:, :, 0, :])
    assert g1.decode_points(got) == [eng.g1.mul_any(Pt, k) for Pt in g1.decode_points(Q)]
