"""FP256BN at the card's limb count on the CPU: the port's contexts at L = 18
(R = 2^288, nine whole 32-bit words), the arithmetic the CUDA kernels run
there, as plain versions.

The kernels take whole 32-bit words, so a curve's base field on a CUDA
device rounds the reference's L up to an even count (``base_limbs``): only
FP256BN changes, from 17 to 18.  Its tensors then differ from the
reference's limb for limb, so everything here is held canonically: the
conversion between the reference's L = 17 and the card's L = 18 to the
reference's ``FpCtx.encode``, and each entry point (the API's MSM bridge,
``BatchEngine``'s MSMs, ladders, pairings and checks) to the port's host
engine on both FP256BN curve IDs.  The other curves keep their limb counts
on the card and on the CPU.  A few lanes each: the plain Miller loop, final
exp and G2 ladder at L = 18 take seconds a lane.
"""

import random

import numpy as np
import pytest
import torch

from mathlib_tpu.ops.field import FpCtx as RefFpCtx
from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.field import (FpCtx, base_limbs, ints_to_limbs, limb_tensor,
                                         narrow_limbs, widen_limbs)
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.g2 import G2Ctx
from mathlib_tpu_torch.ops.msm import bridge_msm

torch.set_num_threads(1)

CARD_L = 18
FP256 = ("FP256BN", "FP256BN_MIRACL")  # the API's FP256BN_AMCL and FP256BN_AMCL_MIRACL
CPU, CUDA = torch.device("cpu"), torch.device("cuda")  # CUDA only names a device type here


@pytest.fixture(scope="module", params=FP256)
def be(request):
    """A BatchEngine of one FP256BN curve ID on the CPU at the card's L."""
    return BatchEngine(get_spec(request.param), "cpu", L=CARD_L)


@pytest.mark.parametrize("name,card_L", [("BLS12_381", 24), ("BN254", 16), ("BLS12_377", 24),
                                         ("FP256BN", 18), ("FP256BN_MIRACL", 18)])
def test_base_field_limbs_on_the_card_and_on_the_cpu(name, card_L):
    """The card rounds L up to even (FP256BN 17 -> 18 only); the CPU keeps
    the reference's L, and so do the scalar fields everywhere."""
    spec = get_spec(name)
    ref_L = RefFpCtx(spec.p).L
    assert base_limbs(spec.p, CUDA) == card_L
    assert base_limbs(spec.p, CPU) == ref_L == (17 if "FP256BN" in name else card_L)
    assert base_limbs(spec.p, CPU, CARD_L) == CARD_L
    assert G1Ctx(spec, "cpu").fp.L == ref_L
    g2 = G2Ctx(spec, "cpu", L=card_L)
    assert (g2.fp.L, g2.tw.fp.L, g2.fr.L) == (card_L, card_L, RefFpCtx(spec.r).L)


@pytest.mark.parametrize("name", FP256)
def test_widen_and_narrow_between_the_reference_and_the_card(name):
    """The reference's encode at L = 17 (R = 2^272) widened to L = 18 is
    x R mod p at R = 2^288, and narrowed back its own value: for seeded
    elements, 0, 1, p - 1 and relaxed representatives in [p, 2p)."""
    spec = get_spec(name)
    p = spec.p
    rng = np.random.default_rng(22)
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "big") % p for _ in range(5)]
    ref = RefFpCtx(p)
    a17 = torch.from_numpy(np.asarray(ref.encode(xs)).astype(np.int32))
    # the same values relaxed: x R' + p, still below 2p
    R17 = 1 << (16 * ref.L)
    relaxed = limb_tensor(ints_to_limbs([x * R17 % p + p for x in xs], ref.L), (len(xs),), CPU)
    f17, f18 = FpCtx(p, "cpu"), FpCtx(p, "cpu", L=CARD_L)
    want18 = f18.encode(xs)  # canonical x R mod p at L = 18
    for a in (a17, relaxed):
        w = widen_limbs(f18, a)
        assert w.shape == (CARD_L, len(xs)) and w.dtype == torch.int32
        assert torch.equal(f18.canon(w), want18)
        back = narrow_limbs(f18, w, ref.L)
        assert back.shape == a17.shape
        assert torch.equal(f17.canon(back), a17)
        assert list(ref.decode(back.numpy().astype(np.uint32))) == xs
    assert widen_limbs(f18, want18) is want18 and narrow_limbs(f18, want18, CARD_L) is want18


def _points(eng, rng, n, distinct=8):
    """n G1 points drawn from ``distinct`` seeded ones, an infinity among them."""
    r = eng.spec.r
    base = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(distinct)]
    pts = [base[rng.randrange(distinct)] for _ in range(n)]
    pts[5] = None
    return pts


def _host_msm(eng, pts, ks):
    live = [(P, k) for P, k in zip(pts, ks) if P is not None]
    return eng.g1.msm([P for P, _ in live], [k for _, k in live])


def test_bridge_and_g1_msm_at_the_cards_limbs(be):
    """The API's 64-point bridge (affine points, the mixed-add scan) and
    ``g1_msm`` at L = 18, against the host engine; ``g1_msm_device`` on
    points at the reference's L = 17 returns a point at L = 17."""
    spec, eng = be.spec, get_engine(be.spec)
    rng = random.Random(0)
    pts = _points(eng, rng, 64)
    ks = [rng.randrange(spec.r) for _ in range(64)]
    ks[9] = 0
    assert bridge_msm(be.g1, pts, ks) == _host_msm(eng, pts, ks)
    assert be.g1_msm(pts[:8], ks[:8], c=4) == _host_msm(eng, pts[:8], ks[:8])
    g17 = G1Ctx(spec, "cpu")
    out = be.g1_msm_device(g17.encode_points(pts[8:16]), g17.encode_scalars(ks[8:16]), c=4)
    assert out.shape == (3, 17, 1)
    assert g17.decode_point(out) == _host_msm(eng, pts[8:16], ks[8:16])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_muls_at_the_cards_limbs(group):
    """``g1_scalar_mul`` (the ladder, then affine by ``batch_inv``) and
    ``g2_scalar_mul`` (FP256BN is inside the G2 kernels' gate: the G2
    ladder) on a few lanes with infinity and k = 0."""
    be = BatchEngine(get_spec("FP256BN"), "cpu", L=CARD_L)
    eng = get_engine(be.spec)
    rng = random.Random(1)
    ks = [rng.randrange(be.spec.r), 0, rng.randrange(be.spec.r)]
    if group == "g1":
        pts = [eng.g1.mul(eng.gen_g1, rng.randrange(1, be.spec.r)), eng.gen_g1, None]
        assert be.g1_scalar_mul(pts, ks) == [None if P is None else eng.g1.mul(P, k)
                                             for P, k in zip(pts, ks)]
    else:
        assert be.g2.rows is not None and be.g2.fp.L == CARD_L
        Q = eng.g2.mul(eng.gen_g2, rng.randrange(1, be.spec.r))
        assert be.g2_scalar_mul([Q, Q, None], ks) == [eng.g2.mul(Q, ks[0]), None, None]


def test_pairing_batch_at_the_cards_limbs():
    """``pairing_batch`` on two pairs (the split Miller kernels' and the BN
    final exp's plain versions at L = 18, ``f12_decode`` reading L from the
    array) against the host engine's pairing."""
    be = BatchEngine(get_spec("FP256BN"), "cpu", L=CARD_L)
    eng = get_engine(be.spec)
    rng = random.Random(2)
    r = be.spec.r
    g1s = [eng.g1.mul(eng.gen_g1, rng.randrange(1, r)) for _ in range(2)]
    g2s = [eng.g2.mul(eng.gen_g2, rng.randrange(1, r)) for _ in range(2)]
    assert be.pairing_batch(g1s, g2s) == [eng.pairing(P, Q) for P, Q in zip(g1s, g2s)]


@pytest.mark.parametrize("kind", ["product", "grouped"])
def test_product_checks_at_the_cards_limbs(kind):
    """A true and a false two-pair product check, and grouped checks of two
    pairs (the segmented product tree), at L = 18."""
    be = BatchEngine(get_spec("FP256BN_MIRACL"), "cpu", L=CARD_L)
    eng = get_engine(be.spec)
    rng = random.Random(3)
    a = rng.randrange(1, be.spec.r)
    P, Q = eng.g1.mul(eng.gen_g1, a), eng.gen_g2
    good = ([P, eng.g1.neg(P)], [Q, Q])
    bad = ([P, P], [Q, Q])
    if kind == "product":
        assert be.pairing_product_is_one(*good)
        assert not be.pairing_product_is_one(*bad)
    else:
        assert be.pairing_products_are_one(good[0] + bad[0], good[1] + bad[1], 2) == [True, False]
