"""The port's hash-to-G2 (``HashG2Ctx``) on the CPU, canonically against the
port's host hasher (held to the reference's by ``tests/test_torch_host.py``)
and to RFC 9380 J.10.1 (tolerance: zero).

* ``f2_sqrt_candidate`` on squares, (5, 0), (0, 7) and (1, 1) among them
  (as ``tests/test_device_hash.py`` holds the reference's); ``_sgn0_f2``
  with a0 = 0;
* ``sswu`` (u = 0, the exceptional t2 = 0 case, among the lanes),
  ``iso_project``, ``psi`` and ``clear_cofactor`` against the host map,
  isogeny, endomorphism and cofactor clearing;
* ``hash_to_g2_batch``'s host path (the five J.10.1 messages in one mixed
  call) against the vectors; the word and block paths are in
  ``tests/test_torch_hash_g2_paths.py`` (a file of its own, so that each
  stays near 25 s on one worker);
* the gate: BN254 and BLS12-377 are refused.

Nothing here jits the reference's XLA hash pipeline.
"""

import random

import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host.curve import WeierstrassCurve
from mathlib_tpu_torch.host.fields import get_tower
from mathlib_tpu_torch.host.hash_to_curve import apply_isogeny, get_hasher
from mathlib_tpu_torch.ops import hash as H
from test_hash_vectors import DST_G2, G2_VECTORS, MSGS

torch.set_num_threads(1)

SPEC = get_spec("BLS12_381")
P = SPEC.p


@pytest.fixture(scope="module")
def ctx():
    return H.get_hash_g2_ctx(SPEC, "cpu")


def _f2_host(ctx, a):
    """(2, L, B) Montgomery limbs -> B host Fp2 pairs."""
    d = ctx.fp.decode(a)
    return [(int(d[0, i]), int(d[1, i])) for i in range(d.shape[-1])]


def _f2_enc(ctx, vals):
    return torch.cat([ctx.tw.f2_encode(v) for v in vals], dim=-1)


def test_f2_sqrt_candidate_on_squares(ctx):
    ht = get_tower(SPEC)
    rng = random.Random(11)
    roots = [(rng.randrange(P), rng.randrange(P)) for _ in range(4)] + [(5, 0), (0, 7), (1, 1)]
    squares = [ht.f2_mul(r, r) for r in roots]
    got = _f2_host(ctx, ctx.f2_sqrt_candidate(_f2_enc(ctx, squares)))
    assert [ht.f2_mul(c, c) for c in got] == squares


def test_sgn0_f2_falls_back_to_a1_when_a0_is_zero(ctx):
    vals = [(0, 3), (0, P - 3), (0, 0), (4, 1), (P - 4, 0), (7, 2)]
    want = [a0 & 1 if a0 else a1 & 1 for a0, a1 in vals]
    assert ctx._sgn0_f2(_f2_enc(ctx, vals)).tolist() == want


def test_map_isogeny_psi_and_cofactor_against_the_host(ctx):
    hasher = get_hasher(SPEC)
    m, isod = hasher._g2_sswu
    F = hasher.e.f2_ops
    rng = random.Random(3)
    us = [(0, 0), (1, 0), (0, 1)] + [(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    x, y = ctx.sswu(_f2_enc(ctx, us))
    maps = [m.map(u) for u in us]
    assert list(zip(_f2_host(ctx, x), _f2_host(ctx, y))) == maps
    g2 = ctx.g2
    iso = ctx.iso_project(x, y)
    assert g2.decode_points(iso) == [apply_isogeny(F, isod, pt) for pt in maps]
    Ep = WeierstrassCurve(F, m.A, m.B)
    summed = [apply_isogeny(F, isod, Ep.add(a, b)) for a, b in zip(maps, maps[::-1])]
    S = g2.add(iso, iso.flip(-1))
    assert g2.decode_points(S) == summed
    assert g2.decode_points(ctx.psi(S)) == [hasher.psi(pt) for pt in summed]
    assert g2.decode_points(ctx.clear_cofactor(S)) == [hasher._clear_cofactor_g2(pt)
                                                       for pt in summed]


def test_hash_to_g2_batch_host_path_gives_the_rfc_vectors():
    """The five J.10.1 messages, mixed lengths: one call of the host path."""
    out = H.hash_to_g2_batch(SPEC, MSGS, DST_G2, device="cpu")
    assert out.shape == (3, 2, H.get_hash_g2_ctx(SPEC, "cpu").fp.L, len(MSGS))
    got = H.get_hash_g2_ctx(SPEC, "cpu").g2.decode_points(out)
    assert [(tuple(x), tuple(y)) for x, y in got] == G2_VECTORS


@pytest.mark.parametrize("name", ["BN254", "BLS12_377"])
def test_gate_refuses_other_curves(name):
    with pytest.raises(ValueError):
        H.get_hash_g2_ctx(get_spec(name), "cpu")
