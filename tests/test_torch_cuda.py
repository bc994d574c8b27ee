"""The CUDA kernels against their plain PyTorch versions, and the paths through
them, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
one (and nvcc), run this file on its own -- its imports need no jax, and the
repository's conftest (which imports jax) is left out:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (torch.equal on the limbs).
"""

import numpy as np
import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.batch import BatchEngine
from mathlib_tpu_torch.host import get_engine
from mathlib_tpu_torch.ops.g1 import G1Ctx
from mathlib_tpu_torch.ops.kernels import fp_cuda, g1_cuda, hash_cuda, pairing_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(params=["BLS12_381", "BN254", "FP256BN"])  # FP256BN: L = 18, nine words
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
    assert g1_cuda.launches() == {"add": 1, "double": 1, "addsel": 1, "smul": 1, "dbladd": 0,
                                  "addselneg": 0, "maddsel": 0, "maddselneg": 0,
                                  "smul_static": 0}


def _edge_points(eng, g1, n, seed):
    """P, Q on n lanes: random multiples of the generator, with P = Q on every
    7th lane (the complete add doubles), P = -Q on every 17th, P at infinity
    on every 11th, Q on every 13th and both on every 19th."""
    A, B = _edge_hosts(eng, n, seed)
    return g1.encode_points(A), g1.encode_points(B)


def _edge_hosts(eng, n, seed):
    """The host points of ``_edge_points``."""
    rng = np.random.default_rng(seed)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 31)]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(n):
        if i % 7 == 0:
            B[i] = A[i]
        elif i % 17 == 3:
            B[i] = eng.g1.neg(A[i])
        if i % 11 == 5 or i % 19 == 4:
            A[i] = None
        if i % 13 == 6 or i % 19 == 4:
            B[i] = None
    return A, B


@pytest.mark.parametrize("n", [1, 31, 32, 33, 191, 4097])
def test_six_warp_add_kernels_equal_plain_versions(ctx, n):
    """add and addsel (32 lanes a block: ragged last blocks) against their
    plain versions, on canonical and relaxed inputs, with sel all 0, all 1
    and random."""
    eng, g1 = ctx
    F = g1.F
    P, Q = _edge_points(eng, g1, n, n)
    S = g1_cuda.add_plain(F, P, Q)  # relaxed [0, 2p)
    rng = np.random.default_rng(n)
    sels = [torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool),
            torch.from_numpy(rng.random(n) < 0.5)]
    g1_cuda.reset_launches()
    for a, b in ((P, Q), (S, Q), (Q, S)):
        assert torch.equal(g1_cuda.add(F, a, b), g1_cuda.add_plain(F, a, b))
        for sel in sels:
            sel = sel.to(P.device)
            assert torch.equal(g1_cuda.addsel(F, a, b, sel), g1_cuda.addsel_plain(F, a, b, sel))
    assert {k: v for k, v in g1_cuda.launches().items() if v} == {"add": 3, "addsel": 9}


def _combiner_masks(n, seed):
    """sel all 0, all 1 and random (with a 32-lane block that adds nowhere
    and one that adds everywhere), and a random neg: every case mixes neg
    inside a block, so the blocks that add nowhere store Q' (or lift(Q'))."""
    rng = np.random.default_rng(seed)
    sel = torch.from_numpy(rng.random(n) < 0.5)
    sel[32:64], sel[64:96] = False, True
    neg = torch.from_numpy(rng.random(n) < 0.5)
    return [torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool), sel], neg


def _combiner_operands(eng, g1, n, seed):
    """Relaxed P (sums with P = Q and P = -Q lanes), projective Q and affine
    Qa of the same host points; Qa is (0, 0) where Q is infinity, as it is
    on no selected lane of an MSM, and the kernels compute there what the
    plain versions compute."""
    A, B = _edge_hosts(eng, n, seed)
    P = g1_cuda.add_plain(g1.F, g1.encode_points(A), g1.encode_points(B))
    return P, g1.encode_points(B), g1.encode_points_affine(B)


_COMBINERS = ("addselneg", "maddsel", "maddselneg")


def _combiner_call(F, name, P, Q, Qa, sel, neg, out=None, plain=False):
    fn = getattr(g1_cuda, name + ("_plain" if plain else ""))
    masks = (sel, neg) if name.endswith("neg") else (sel,)
    return fn(F, P, Qa if name.startswith("m") else Q, *masks, out=out)


@pytest.mark.parametrize("n", [1, 33, 4097])
def test_six_warp_combiners_equal_plain_versions(ctx, n):
    """addselneg, maddsel and maddselneg (32 lanes a block: ragged last
    blocks) against their plain versions, bit for bit, on relaxed P and on
    canonical P, with sel all 0, all 1 and random, neg mixed in every
    block."""
    eng, g1 = ctx
    F = g1.F
    P, Q, Qa = _combiner_operands(eng, g1, n, n + 5)
    sels, neg = _combiner_masks(n, n)
    neg = neg.to(P.device)
    g1_cuda.reset_launches()
    for a in (P, Q):
        for sel in sels:
            sel = sel.to(P.device)
            for name in _COMBINERS:
                assert torch.equal(_combiner_call(F, name, a, Q, Qa, sel, neg),
                                   _combiner_call(F, name, a, Q, Qa, sel, neg, plain=True)), name
    assert {k: v for k, v in g1_cuda.launches().items() if v} == {k: 6 for k in _COMBINERS}


def test_six_warp_combiners_write_into_a_capture_buffer(ctx):
    """out= a step ys[s] of a (K, 3, L, n) buffer: each combiner writes that
    step in place and leaves the others alone; G1Ctx passes out= through."""
    eng, g1 = ctx
    F = g1.F
    n = 191
    P, Q, Qa = _combiner_operands(eng, g1, n, 6)
    sels, neg = _combiner_masks(n, 6)
    sel, neg = sels[2].to(P.device), neg.to(P.device)
    for name, method in zip(_COMBINERS, ("add_select_neg", "madd_select", "madd_select_neg")):
        ys = torch.full((3,) + P.shape, -1, dtype=torch.int32, device=P.device)
        want = _combiner_call(F, name, P, Q, Qa, sel, neg, plain=True)
        got = _combiner_call(F, name, P, Q, Qa, sel, neg, out=ys[1])
        assert got.data_ptr() == ys[1].data_ptr()
        assert torch.equal(ys[1], want), name
        masks = (sel, neg) if name.endswith("neg") else (sel,)
        getattr(g1, method)(P, Qa if name.startswith("m") else Q, *masks, out=ys[2])
        assert torch.equal(ys[2], want), name
        assert bool((ys[0] == -1).all())


def test_six_warp_combiner_wrappers_refuse_a_bad_out(ctx):
    eng, g1 = ctx
    F = g1.F
    n = 64
    P0, Q0, Qa0 = _combiner_operands(eng, g1, n, 7)
    dev, size = P0.device, P0.numel()

    def in_storage(t):  # t at the start of a storage twice P's size, and a view beside it
        flat = torch.zeros(t.numel() + size, dtype=torch.int32, device=dev)
        head = t.numel() // 2
        return flat[: t.numel()].view(t.shape).copy_(t), flat[head : head + size].view(P0.shape)

    (P, over_P), (Q, over_Q), (Qa, over_Qa) = in_storage(P0), in_storage(Q0), in_storage(Qa0)
    sel = torch.ones(n, dtype=torch.bool, device=dev)
    neg = sel.clone()
    bad = [
        (torch.empty(P0.shape[:-1] + (2 * n,), dtype=torch.int32, device=dev)[..., ::2],
         ValueError),  # not contiguous
        (torch.empty(P0.shape[:-1] + (n + 1,), dtype=torch.int32, device=dev), ValueError),
        (torch.empty(P0.shape, dtype=torch.int64, device=dev), TypeError),
        (torch.empty(P0.shape, dtype=torch.int32), ValueError),  # on the CPU
    ]
    g1_cuda.reset_launches()
    for name in _COMBINERS:  # out overlapping P, or Q (affine for the mixed adds)
        for out, err in bad + [(over_P, ValueError),
                               (over_Qa if name.startswith("m") else over_Q, ValueError)]:
            with pytest.raises(err):
                _combiner_call(F, name, P, Q, Qa, sel, neg, out=out)
    assert not any(g1_cuda.launches()[k] for k in _COMBINERS)


@pytest.mark.parametrize("n", [1, 16, 33, 4097])
def test_four_warp_double_equals_the_plain_version(ctx, n):
    """double (32 lanes a block: ragged last blocks) on canonical points with
    infinity lanes, their negations, and relaxed sums with P = Q and P = -Q
    lanes (infinity with relaxed limbs), against its plain version."""
    eng, g1 = ctx
    F = g1.F
    P, Q = _edge_points(eng, g1, n, n + 1)
    g1_cuda.reset_launches()
    for a in (P, g1.neg(P), g1_cuda.add_plain(F, P, Q)):
        assert torch.equal(g1_cuda.double(F, a), g1_cuda.double_plain(F, a))
    assert {k: v for k, v in g1_cuda.launches().items() if v} == {"double": 3}


@pytest.mark.parametrize("curve", ["BLS12_381", "BLS12_377", "BN254", "FP256BN"])
def test_six_warp_ladder_equals_the_plain_version(curve):
    """smul (the ladder over six warps of 32-lane blocks) on 1, 31, 33 and
    4,097 lanes against smul_plain's 4,097: relaxed Q with infinity lanes,
    k = 0, 1, r - 1 and random, a block whose scalars are all 0 (it skips
    every add) beside blocks that add; at the full nbits and at 100 bits.
    One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(curve)
    eng, g1 = get_engine(spec), G1Ctx(spec, torch.device("cuda"))
    F, n = g1.F, 4097
    P, Q = _edge_points(eng, g1, n, 14)
    S = g1_cuda.add_plain(F, P, Q)  # relaxed, with infinity lanes
    rng = np.random.default_rng(14)
    ks = [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(n)]
    ks[:3] = [0, 1, spec.r - 1]
    ks[64:96] = [0] * 32  # a block that skips every add
    K = g1.encode_scalars(ks)
    for nbits in (g1.nbits, 100):
        want = g1_cuda.smul_plain(F, S, K, nbits)
        for m in (1, 31, 33, n):
            g1_cuda.reset_launches()
            got = g1_cuda.smul(F, S[..., :m], K[..., :m], nbits)
            assert torch.equal(got, want[..., :m]), (nbits, m)
            assert {k: v for k, v in g1_cuda.launches().items() if v} == {"smul": 1}
    assert g1.decode_points(want[..., 64:96]) == [None] * 32


@pytest.mark.parametrize("group", [1, 4])
def test_mont_mul_kernel_equals_the_plain_version(monkeypatch, group):
    """mont_mul with each body (one element a thread, or the group of four
    threads, forced through fp_cuda.mont_group) at (6, L, 4,096), (1, L, 1)
    and a ragged (2, L, 4,097), L = 24 and 16, elementwise and with one
    (L, 1) constant operand, on relaxed limbs with the edge values 0, 1,
    p - 1, p, 2p - 1.  One launch a call.  With one thread an element also
    FP256BN's L = 18 (nine words, which the wrapper never groups)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.field import FpCtx, base_limbs

    monkeypatch.setattr(fp_cuda, "mont_group", lambda elements: group)
    for curve in ("BLS12_381", "BN254") + (("FP256BN",) if group == 1 else ()):
        p = get_spec(curve).p
        fp = FpCtx(p, torch.device("cuda"), L=base_limbs(p, torch.device("cuda")))
        L = fp.L
        rng = np.random.default_rng(L)

        def rows(shape):
            vals = [int.from_bytes(rng.bytes(L * 2), "little") % (2 * p)
                    for _ in range(shape[0] * shape[2])]
            vals[:5] = [0, 1, p - 1, p, 2 * p - 1][: len(vals)]
            limbs = [[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in vals]
            arr = np.array(limbs, dtype=np.int32).reshape(shape[0], shape[2], L)
            return torch.from_numpy(arr.transpose(0, 2, 1).copy()).cuda()

        c = rows((1, L, 1))[0]
        for shape in ((6, L, 4096), (1, L, 1), (2, L, 4097)):
            a, b = rows(shape), rows(shape).flip(-1)
            for other in (b, c):
                fp_cuda.reset_launches()
                got = fp_cuda.mont_mul(fp, a, other)
                assert fp_cuda.launches()["mont_mul"] == 1
                assert torch.equal(got, fp_cuda.mont_mul_plain(fp, a, other)), (curve, shape)


def test_six_warp_add_kernels_write_into_a_capture_buffer(ctx):
    """out= a step ys[s] of a (K, 3, L, n) buffer: the kernels write that step
    in place and leave the others alone."""
    eng, g1 = ctx
    F = g1.F
    n = 191
    P, Q = _edge_points(eng, g1, n, 3)
    sel = torch.from_numpy(np.random.default_rng(3).random(n) < 0.8).to(P.device)
    ys = torch.full((3,) + P.shape, -1, dtype=torch.int32, device=P.device)
    got = g1_cuda.addsel(F, P, Q, sel, out=ys[1])
    assert got.data_ptr() == ys[1].data_ptr()
    assert torch.equal(ys[1], g1_cuda.addsel_plain(F, P, Q, sel))
    got = g1_cuda.add(F, ys[1], Q, out=ys[2])
    assert got.data_ptr() == ys[2].data_ptr()
    assert torch.equal(ys[2], g1_cuda.add_plain(F, ys[1], Q))
    assert bool((ys[0] == -1).all())
    g1.add_select(ys[1], Q, sel, out=ys[0])
    assert torch.equal(ys[0], g1_cuda.addsel_plain(F, ys[1], Q, sel))


def test_six_warp_add_wrappers_refuse_a_bad_out(ctx):
    eng, g1 = ctx
    F = g1.F
    n = 64
    P0, Q = _edge_points(eng, g1, n, 4)
    flat = torch.zeros(2 * P0.numel(), dtype=torch.int32, device=P0.device)
    P = flat[: P0.numel()].view(P0.shape).copy_(P0)
    sel = torch.ones(n, dtype=torch.bool, device=P.device)
    half = P0.numel() // 2
    bad = [
        (flat[half : half + P0.numel()].view(P0.shape), ValueError),  # overlaps P
        (Q, ValueError),
        (torch.empty(P0.shape[:-1] + (2 * n,), dtype=torch.int32, device=P.device)[..., ::2],
         ValueError),  # not contiguous
        (torch.empty(P0.shape[:-1] + (n + 1,), dtype=torch.int32, device=P.device), ValueError),
        (torch.empty(P0.shape, dtype=torch.int64, device=P.device), TypeError),
        (torch.empty(P0.shape, dtype=torch.int32), ValueError),  # on the CPU
    ]
    g1_cuda.reset_launches()
    for out, err in bad:
        with pytest.raises(err):
            g1_cuda.add(F, P, Q, out=out)
        with pytest.raises(err):
            g1_cuda.addsel(F, P, Q, sel, out=out)
    assert g1_cuda.launches()["add"] == g1_cuda.launches()["addsel"] == 0


def test_msm_option_kernels_equal_plain_versions(ctx):
    """dbladd, addselneg, maddsel and maddselneg against their plain versions
    on relaxed inputs with the edge lanes P = inf, P = lift(Q), P = -lift(Q)."""
    eng, g1 = ctx
    F = g1.F
    n = 1000
    rng = np.random.default_rng(7)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 31)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 7):
        A[i] = B[i]
    for i in range(3, n, 11):
        A[i] = eng.g1.neg(B[i])
    for i in range(5, n, 13):
        A[i] = None
    P = g1.add(g1.encode_points(A), g1.encode_points(B))  # relaxed [0, 2p)
    Q, Qa = g1.encode_points(B), g1.encode_points_affine(B)
    sel = torch.from_numpy(rng.random(n) < 0.8).to(P.device)
    neg = torch.from_numpy(rng.random(n) < 0.5).to(P.device)
    g1_cuda.reset_launches()
    pairs = [
        (g1_cuda.dbladd(F, P, Q, sel), g1_cuda.dbladd_plain(F, P, Q, sel)),
        (g1_cuda.addselneg(F, P, Q, sel, neg), g1_cuda.addselneg_plain(F, P, Q, sel, neg)),
        (g1_cuda.maddsel(F, P, Qa, sel), g1_cuda.maddsel_plain(F, P, Qa, sel)),
        (g1_cuda.maddselneg(F, P, Qa, sel, neg), g1_cuda.maddselneg_plain(F, P, Qa, sel, neg)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    counts = g1_cuda.launches()
    assert [counts[k] for k in ("dbladd", "addselneg", "maddsel", "maddselneg")] == [1, 1, 1, 1]


def test_dbladd_on_edge_lanes_blocks_and_batch_dims(ctx):
    """dbladd (one bit of the six-warp ladder) against dbladd_plain, bit for
    bit, on 4,097 relaxed lanes (a partial last block): P = infinity, Q =
    infinity, Q = 2P and Q = -2P lanes, a 32-lane block with no lane
    selected and one with every lane selected; then with leading batch dims
    (2, 3) and Q broadcast over them.  One launch a call."""
    eng, g1 = ctx
    F = g1.F
    n = 4097
    rng = np.random.default_rng(19)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 31)]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 11):
        A[i] = None
    for i in range(1, n, 13):
        B[i] = None
    inf = g1.encode_points([None] * n)
    P, Q = g1.add(g1.encode_points(A), inf), g1.add(g1.encode_points(B), inf)  # relaxed
    D = g1_cuda.double_plain(F, P)
    Q[..., 2::7] = D[..., 2::7]
    Q[..., 4::17] = g1.neg(D)[..., 4::17]
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(P.device)
    sel[32:64], sel[64:96] = False, True
    g1_cuda.reset_launches()
    assert torch.equal(g1_cuda.dbladd(F, P, Q, sel), g1_cuda.dbladd_plain(F, P, Q, sel))
    Pb = torch.stack([P[..., 100 * j:100 * (j + 1)] for j in range(6)]).reshape(
        (2, 3) + P.shape[:-1] + (100,))
    Qb, selb = Q[..., :100], sel[:600].reshape(2, 3, 100)
    got = g1_cuda.dbladd(F, Pb, Qb, selb)
    assert got.shape == Pb.shape
    assert torch.equal(got, g1_cuda.dbladd_plain(F, Pb, Qb, selb))
    assert {k: v for k, v in g1_cuda.launches().items() if v} == {"dbladd": 2}


def test_field_product_and_affine_run_on_the_kernels(ctx):
    """FpCtx.mont_mul on a CUDA tensor launches the mont_mul kernel, and
    G1Ctx.to_affine reaches it (and fp_pow) on the card."""
    eng, g1 = ctx
    pts = [eng.g1.mul(eng.gen_g1, k) for k in (3, 5, 7)] + [None]
    P = g1.add(g1.encode_points(pts), g1.encode_points([eng.gen_g1] * 4))
    fp_cuda.reset_launches()
    x = g1.fp.mont_mul(P[0], P[1])
    assert fp_cuda.launches()["mont_mul"] == 1
    assert torch.equal(x, g1.fp.mont_mul_plain(P[0], P[1]))
    xy = g1.to_affine_rows(P)
    assert fp_cuda.launches()["mont_mul"] > 1 and fp_cuda.launches()["fp_pow"] == 1
    assert g1.decode_points_affine(xy) == [eng.g1.add(a, eng.gen_g1) for a in pts]


def test_msm_options_on_the_card_equal_the_host(ctx):
    from mathlib_tpu_torch.ops import msm

    eng, g1 = ctx
    spec = eng.spec
    rng = np.random.default_rng(8)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 16)]
    pts = [pool[i] for i in rng.integers(0, 16, 300)]
    pts[7] = None
    ks = [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(300)]
    want = eng.g1.msm([P for P in pts if P], [k for P, k in zip(pts, ks) if P])
    zk = [0 if P is None else k for P, k in zip(pts, ks)]
    P, Pa = g1.encode_points(pts), g1.encode_points_affine(pts)
    glv = spec.family.name == "BLS12"
    for points, scal, kw in ((P, ks, {"signed": True}), (Pa, zk, {}), (Pa, zk, {"signed": True}),
                             (P, ks, {"glv": glv}), (Pa, zk, {"glv": glv, "signed": True})):
        tot = msm.msm_totals(g1, points, g1.encode_scalars(scal), c=8, K=16, **kw)
        assert msm.horner_host(g1, tot, 8) == want, kw
    assert msm.msm_host_bridge(spec, pts, ks) == want
    be = BatchEngine(spec)
    assert be.g1_msm(pts, ks) == want
    assert be.g1_scalar_mul(pts[:4], ks[:4]) == [eng.g1.mul(Q, k) if Q else None
                                                for Q, k in zip(pts[:4], ks[:4])]


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
    from mathlib_tpu_torch.ops import msm

    spec = get_spec("FP256BN")
    fp256 = G1Ctx(spec, P.device)  # on the card its p takes L = 18 (nine words)
    assert fp256.fp.L == 18
    assert torch.equal(fp256.add(fp256.gen, fp256.gen),
                       g1_cuda.add_plain(fp256.F, fp256.gen, fp256.gen))
    assert msm.msm_host_bridge(spec, [spec.g1_gen] * 3, [1, 2, 3]) == get_engine(spec).g1.mul(
        spec.g1_gen, 6)
    with pytest.raises(RuntimeError):  # the static ladder is not built at nine words
        g1_cuda.smul_static(fp256.F, fp256.gen, [1, 0, 1])
    odd = G1Ctx(spec, P.device, L=17)  # the reference's L = 17: no kernel takes it
    with pytest.raises(ValueError):
        odd.add(odd.gen, odd.gen)
    with pytest.raises(ValueError):  # no plain version on the card
        odd.fp.mont_mul(odd.gen[0], odd.gen[1])
    with pytest.raises(ValueError):
        msm.bridge_msm(odd, [spec.g1_gen] * 3, [1, 2, 3])
    with pytest.raises(ValueError):
        BatchEngine(spec, L=17).g1_msm([spec.g1_gen] * 3, [1, 2, 3])


@pytest.fixture(params=["BLS12_381", "BN254", "BLS12_377", "FP256BN"])
def pair_ctx(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(request.param)
    return get_engine(spec), BatchEngine(spec)


def _pairs(eng, n, seed):
    rng = np.random.default_rng(seed)
    g1s = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, n)]
    g2s = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, n)]
    return g1s, g2s


def test_pairing_kernels_equal_plain_versions(pair_ctx):
    eng, be = pair_ctx
    cfg = be.pair.cfg
    g1s, g2s = _pairs(eng, 40, 7)
    packed = be._encode_pairs(g1s, g2s)
    fp_cuda.reset_launches()
    pairing_cuda.reset_launches()
    xP, yP, Qx, Qy = be._pair_split_mont(packed)
    t = torch.from_numpy(packed.astype(np.int32)).cuda()
    assert torch.equal(torch.cat([xP[None], yP[None], Qx, Qy]),
                       fp_cuda.mont_mul_plain(be.fp, t, be.fp.r2_limbs.to(torch.int32).cuda()))
    f = pairing_cuda.miller_lanes(cfg, xP, yP, Qx, Qy, 37)  # 3 pad lanes
    assert torch.equal(f, pairing_cuda.miller_lanes_plain(cfg, xP, yP, Qx, Qy, 37))
    f = torch.cat([f, f[..., :24]], -1)  # 64 lanes
    for seg in (2, 64):
        assert torch.equal(pairing_cuda.f12_seg_product(cfg, f, seg),
                           pairing_cuda.f12_seg_product_plain(cfg, f, seg))
    assert fp_cuda.launches() == {"mont_mul": 1, "fp_pow": 0}
    assert pairing_cuda.launches() == {"miller_lanes": 1, "f12_seg_product": 1 + 2, "miller_ft": 0,
                                       "add_step": 0, "f12_pow": 0, "final_exp": 0,
                                       "pairing_check": 0}


def test_split_miller_kernels_equal_plain_versions(pair_ctx, monkeypatch):
    """miller_lanes and miller_ft at every block the launcher picks for the
    curve (forced through ``miller_shape``), on 1, 31, 32, 33, 2,047 and
    4,097 lanes, with no real lane, a whole group of pad lanes and a ragged
    pad, against one plain run on 4,097 lanes (lanes are independent; a pad
    lane is the f12 one)."""
    eng, be = pair_ctx
    cfg = be.pair.cfg
    shapes = sorted({pairing_cuda.miller_shape(cfg, n) for n in (4096, 2048, 1024)})
    rng = np.random.default_rng(12)
    g1s, g2s = _pairs(eng, 16, 13)
    pick = rng.integers(0, 16, 4097)
    xP, yP, Qx, Qy = be._pair_split_mont(
        be._encode_pairs([g1s[i] for i in pick], [g2s[i] for i in pick]))
    want = pairing_cuda.miller_lanes_plain(cfg, xP, yP, Qx, Qy, 4097)
    want_f, want_T = pairing_cuda.miller_ft_plain(cfg, xP, yP, Qx, Qy)
    one = cfg.tower.f12_one_like(1, xP.device).to(torch.int32)
    pairing_cuda.reset_launches()
    launches = 0
    for n in (1, 31, 32, 33, 2047, 4097):
        args = [t[..., :n].contiguous() for t in (xP, yP, Qx, Qy)]
        for G, K in shapes:
            monkeypatch.setattr(pairing_cuda, "miller_shape", lambda cfg, lanes: (G, K))
            f, T = pairing_cuda.miller_ft(cfg, *args)
            assert torch.equal(f, want_f[..., :n]) and torch.equal(T, want_T[..., :n])
            for nvalid in sorted({0, max(0, n - G), max(0, n - 3), n}):
                got = pairing_cuda.miller_lanes(cfg, *args, nvalid)
                pad = torch.arange(n, device=xP.device) >= nvalid
                assert torch.equal(got, torch.where(pad, one, want[..., :n]))
                launches += 1
            launches += 1
    assert sum(pairing_cuda.launches().values()) == launches


def test_split_fexp_kernels_equal_plain_versions(pair_ctx, monkeypatch):
    """final_exp and f12_pow (both squarings) at every block the launcher can
    pick (32, 16 and 8 lanes, forced through ``fexp_shape``, where the
    curve's programs fit), on 1, 33 and 40 lanes, against one plain run on
    40 lanes (lanes are independent)."""
    eng, be = pair_ctx
    cfg, kcfg, spec = be.pair.cfg, be.tw.kcfg, eng.spec
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(*_pairs(eng, 40, 14)))
    f = pairing_cuda.miller_ft(cfg, xP, yP, Qx, Qy)[0]
    inv, xb, neg = kcfg.inv_bits, pairing_cuda.msb_bits(abs(spec.x)), spec.x < 0
    want = {"final_exp": pairing_cuda.final_exp_plain(kcfg, f, inv, xb, neg),
            True: pairing_cuda.f12_pow_plain(kcfg, f, xb, True),
            False: pairing_cuda.f12_pow_plain(kcfg, f, xb, False)}
    pairing_cuda.reset_launches()
    launches = {"final_exp": 0, "f12_pow": 0}
    for kind in launches:
        for G, K in pairing_cuda.MILLER_WORKERS.items():
            _, slots, words = pairing_cuda.fexp_programs(kcfg, kind, G)
            if slots * words * 4 > pairing_cuda.MILLER_SMEM:
                continue
            monkeypatch.setattr(pairing_cuda, "fexp_shape", lambda cfg, kind, lanes: (G, K))
            for n in (1, 33, 40):
                a = f[..., :n].contiguous()
                if kind == "final_exp":
                    got = pairing_cuda.final_exp(kcfg, a, inv, xb, neg)
                    assert torch.equal(got, want[kind][..., :n]), (G, n)
                    launches[kind] += 1
                else:
                    for cyclo in (True, False):
                        got = pairing_cuda.f12_pow(kcfg, a, xb, cyclo)
                        assert torch.equal(got, want[cyclo][..., :n]), (G, n, cyclo)
                        launches[kind] += 1
    assert {k: v for k, v in pairing_cuda.launches().items() if k in launches} == launches


def _f12_lanes(be, n, seed):
    """n lanes of random relaxed [0, 2p) f12 values on the card."""
    p, L = be.fp.p, be.fp.L
    rng = np.random.default_rng(seed)
    vals = np.array([[int.from_bytes(rng.bytes(64), "big") % (2 * p) for _ in range(n)]
                     for _ in range(12)], dtype=object)
    limbs = np.stack([(vals >> (16 * k)) & 0xFFFF for k in range(L)], axis=1).astype(np.int32)
    return torch.from_numpy(limbs.reshape(2, 3, 2, L, n)).cuda()


def test_split_tree_equals_the_plain_version(pair_ctx):
    """f12_seg_product with seg 2, 64 and the whole batch on 1, 2, 64 and
    4,096 lanes, and on 61 lanes padded with ones by ``tree_width``, against
    the plain version; the launches a call are ``tree_plan``'s."""
    eng, be = pair_ctx
    cfg = be.pair.cfg
    f = _f12_lanes(be, 4096, 15)
    one = cfg.tower.f12_one_like(3, f.device).to(torch.int32)
    padded = torch.cat([f[..., :61], one], dim=-1)
    assert padded.shape[-1] == pairing_cuda.tree_width(61)
    for a in [f[..., :n].contiguous() for n in (1, 2, 64, 4096)] + [padded]:
        B = a.shape[-1]
        for seg in sorted({s for s in (2, 64, B) if s <= B}):
            pairing_cuda.reset_launches()
            got = pairing_cuda.f12_seg_product(cfg, a, seg)
            assert torch.equal(got, pairing_cuda.f12_seg_product_plain(cfg, a, seg)), (B, seg)
            want = len(pairing_cuda.tree_plan(cfg, seg)[2])
            assert pairing_cuda.launches()["f12_seg_product"] == want, (B, seg)


def test_product_check_on_the_card(pair_ctx):
    eng, be = pair_ctx
    g1s, g2s = _pairs(eng, 3, 8)
    P = eng.g1.mul(eng.gen_g1, 12345)
    nP = eng.g1.neg(P)
    G = eng.gen_g2
    assert be.pairing_product_is_one([P, nP], [G, G]) is True
    assert be.pairing_product_is_one(g1s + [P, nP], g2s + [G, G]) is False
    grp = [P, nP, P, nP] + [g1s[0], g1s[1], P, nP] + [P, nP, P, nP]
    g2g = [G] * 4 + [g2s[0], g2s[1], G, G] + [G] * 4
    assert be.pairing_products_are_one(grp, g2g, 4) == [True, False, True]


def test_pairing_batch_kernels_equal_plain_versions(pair_ctx):
    """miller_ft, add_step, f12_pow, final_exp and fp_pow against their plain
    versions on 40 lanes, full chains; and pairing_batch against the host
    engine on 4 of them, with its launches: one final_exp (BN254: its whole
    final exp too, no fp_pow or f12_pow), two add_step on BN254 (BLS12-377
    has no ported pairing_batch path: its kernels are checked all the
    same)."""
    eng, be = pair_ctx
    cfg, kcfg = be.pair.cfg, be.tw.kcfg
    spec = eng.spec
    g1s, g2s = _pairs(eng, 40, 9)
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    fp_cuda.reset_launches()
    pairing_cuda.reset_launches()
    f, T = pairing_cuda.miller_ft(cfg, xP, yP, Qx, Qy)
    for got, want in zip((f, T), pairing_cuda.miller_ft_plain(cfg, xP, yP, Qx, Qy)):
        assert torch.equal(got, want)
    for got, want in zip(pairing_cuda.add_step(cfg, f, T, Qx, Qy, xP, yP),
                         pairing_cuda.add_step_plain(cfg, f, T, Qx, Qy, xP, yP)):
        assert torch.equal(got, want)
    inv_bits = kcfg.inv_bits
    assert torch.equal(fp_cuda.fp_pow(be.fp, xP, inv_bits), fp_cuda.fp_pow_plain(be.fp, xP, inv_bits))
    x_bits = pairing_cuda.msb_bits(abs(spec.x))
    for cyclo in (False, True):
        assert torch.equal(pairing_cuda.f12_pow(kcfg, f, x_bits, cyclo),
                           pairing_cuda.f12_pow_plain(kcfg, f, x_bits, cyclo))
    assert torch.equal(pairing_cuda.final_exp(kcfg, f, inv_bits, x_bits, spec.x < 0),
                       pairing_cuda.final_exp_plain(kcfg, f, inv_bits, x_bits, spec.x < 0))
    assert fp_cuda.launches()["fp_pow"] == 1
    assert {k: v for k, v in pairing_cuda.launches().items()
            if k in ("miller_ft", "add_step", "f12_pow", "final_exp")} == {
        "miller_ft": 1, "add_step": 1, "f12_pow": 2, "final_exp": 1}
    if spec.name != "BLS12_377":
        fp_cuda.reset_launches()
        pairing_cuda.reset_launches()
        assert be.pairing_batch(g1s[:4], g2s[:4]) == [eng.pairing(P, Q) for P, Q in zip(g1s, g2s[:4])]
        bn = spec.family.name == "BN"
        assert {k: v for k, v in pairing_cuda.launches().items() if v} == {
            "miller_ft": 1, "final_exp": 1, **({"add_step": 2} if bn else {})}
        assert fp_cuda.launches()["fp_pow"] == 0


def test_split_add_step_equals_the_plain_version(pair_ctx, monkeypatch):
    """add_step at every block the launcher can pick (forced through
    ``add_shape``) on 1, 33 and 1,024 lanes of Miller (f, T), against one
    plain run on 1,024 lanes (lanes are independent)."""
    eng, be = pair_ctx
    cfg = be.pair.cfg
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(*_pairs(eng, 1024, 18)))
    f, T = pairing_cuda.miller_ft(cfg, xP, yP, Qx, Qy)
    want = pairing_cuda.add_step_plain(cfg, f, T, Qx, Qy, xP, yP)
    pairing_cuda.reset_launches()
    launches = 0
    for G, K in pairing_cuda.MILLER_WORKERS.items():
        monkeypatch.setattr(pairing_cuda, "add_shape", lambda cfg, lanes: (G, K))
        for n in (1, 33, 1024):
            args = [t[..., :n].contiguous() for t in (f, T, Qx, Qy, xP, yP)]
            got = pairing_cuda.add_step(cfg, *args)
            assert all(torch.equal(a, b[..., :n]) for a, b in zip(got, want)), (G, n)
            launches += 1
    assert pairing_cuda.launches()["add_step"] == launches


@pytest.mark.parametrize("curve", ["BN254", "FP256BN"])
def test_split_final_exp_bn_equals_the_plain_version(monkeypatch, curve):
    """A BN curve's one-launch final exp (its whole script: easy part, the
    four digit chains, the Frobenius products) on 64 lanes at every block
    the launcher can pick (forced through ``fexp_shape``) and on 1,024
    lanes at the block it picks there, against the plain version on Miller
    values (FP256BN at L = 18)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(curve)
    eng, be = get_engine(spec), BatchEngine(spec)
    cfg, kcfg = be.pair.cfg, be.tw.kcfg
    f = pairing_cuda.miller_ft(cfg, *be._pair_split_mont(be._encode_pairs(*_pairs(eng, 1024, 19))))[0]
    want = pairing_cuda.final_exp_bn_plain(kcfg, f, kcfg.inv_bits, kcfg.digit_bits)
    pairing_cuda.reset_launches()
    assert torch.equal(pairing_cuda.final_exp(kcfg, f), want)
    a = f[..., :64].contiguous()
    for G, K in pairing_cuda.MILLER_WORKERS.items():
        monkeypatch.setattr(pairing_cuda, "fexp_shape", lambda cfg, kind, lanes: (G, K))
        assert torch.equal(pairing_cuda.final_exp(kcfg, a), want[..., :64]), G
    assert pairing_cuda.launches()["final_exp"] == 4


def test_device_strategies_give_the_default_verdicts(pair_ctx, monkeypatch):
    eng, be = pair_ctx
    if not be.pair.supports_fused_check:
        pytest.skip("the device final exp takes BLS12 curves")
    P = eng.g1.mul(eng.gen_g1, 12345)
    nP, G = eng.g1.neg(P), eng.gen_g2
    g1s, g2s = _pairs(eng, 2, 10)
    grp, g2g = [P, nP] + g1s + [P, nP], [G, G] + g2s + [G, G]
    want = [be.pairing_product_is_one([P, nP], [G, G]), be.pairing_product_is_one(g1s, g2s),
            be.pairing_products_are_one(grp, g2g, 2)]
    assert want == [True, False, [True, False, True]]
    monkeypatch.setenv("MATHLIB_PAIR_FUSED", "split")
    monkeypatch.setenv("MATHLIB_GROUP_FEXP", "device")
    pairing_cuda.reset_launches()
    assert [be.pairing_product_is_one([P, nP], [G, G]), be.pairing_product_is_one(g1s, g2s),
            be.pairing_products_are_one(grp, g2g, 2)] == want
    assert pairing_cuda.launches()["final_exp"] == 3
    monkeypatch.setenv("MATHLIB_PAIR_FUSED", "check")
    pairing_cuda.reset_launches()
    assert [be.pairing_product_is_one([P, nP], [G, G]),
            be.pairing_product_is_one(g1s, g2s)] == want[:2]
    assert {k: v for k, v in pairing_cuda.launches().items() if v} == {"pairing_check": 2}


def _check_pairs(eng, n, seed):
    """n pairs whose product of pairings is one (n >= 2): (P_i, Q_i) beside
    (-P_i, Q_i), and for odd n a triple (A, G), (B, G), (-(A + B), G); one
    random pair for n = 1."""
    rng = np.random.default_rng(seed)

    def k():
        return int(rng.integers(1, 1 << 62))

    if n == 1:
        return [eng.g1.mul(eng.gen_g1, k())], [eng.g2.mul(eng.gen_g2, k())]
    g1s, g2s = [], []
    for _ in range((n - 3) // 2 if n % 2 else n // 2):
        P, Q = eng.g1.mul(eng.gen_g1, k()), eng.g2.mul(eng.gen_g2, k())
        g1s += [P, eng.g1.neg(P)]
        g2s += [Q, Q]
    if n % 2:
        A, B, G = eng.g1.mul(eng.gen_g1, k()), eng.g1.mul(eng.gen_g1, k()), eng.g2.mul(
            eng.gen_g2, k())
        g1s += [A, B, eng.g1.neg(eng.g1.add(A, B))]
        g2s += [G, G, G]
    return g1s, g2s


@pytest.mark.parametrize("curve", ["BLS12_381", "BLS12_377"])
def test_one_launch_check_on_the_split_programs(curve):
    """pairing_check (the split kernels' programs in one launch) against its
    plain version at 1, 2, 33, 64 (nvalid 61, 3 pad lanes holding points)
    and 257 lanes: the verdict and the unreduced product bit for bit, True
    on a product of pairings that is one (False on the single random pair),
    False on the twin of 2 and 64 lanes with one scalar changed; one launch
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(curve)
    eng, be = get_engine(spec), BatchEngine(spec)
    cfg = be.pair.cfg
    for lanes, n in ((1, 1), (2, 2), (33, 33), (64, 61), (257, 257)):
        g1s, g2s = _check_pairs(eng, n, lanes)
        pad = _pairs(eng, lanes - n, lanes)
        sets = [(g1s, n > 1)]
        if lanes in (2, 64):
            sets.append(([eng.g1.mul(g1s[0], 2)] + g1s[1:], False))
        for g1l, want in sets:
            xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1l + pad[0], g2s + pad[1]))
            pairing_cuda.reset_launches()
            ok, prod = pairing_cuda.pairing_check(cfg, xP, yP, Qx, Qy, n)
            assert {k: v for k, v in pairing_cuda.launches().items() if v} == {"pairing_check": 1}
            ok_p, prod_p = pairing_cuda.pairing_check_plain(cfg, xP, yP, Qx, Qy, n)
            assert bool(ok) == bool(ok_p) == want and torch.equal(prod, prod_p), (lanes, want)


@pytest.mark.parametrize("curve", ["BLS12_381", "BLS12_377", "BN254"])
def test_static_ladder_equals_the_plain_version(curve):
    """smul_static (the six-warp ladder with one bit string) on 1, 31, 33
    and 4,097 lanes against smul_static_plain's 4,097: relaxed Q with
    infinity lanes, h_eff's 64 bits (the cofactor clearing) and a 255-bit
    scalar.  One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec(curve)
    eng, g1 = get_engine(spec), G1Ctx(spec, torch.device("cuda"))
    F, n = g1.F, 4097
    P, Q = _edge_points(eng, g1, n, 15)
    S = g1_cuda.add_plain(F, P, Q)  # relaxed, with infinity lanes
    k255 = int.from_bytes(np.random.default_rng(15).bytes(32), "big") % (1 << 255) | (1 << 254)
    for bits in ([int(b) for b in bin(0xD201000000010001)[2:]], [int(b) for b in bin(k255)[2:]]):
        want = g1_cuda.smul_static_plain(F, S, bits)
        for m in (1, 31, 33, n):
            g1_cuda.reset_launches()
            got = g1_cuda.smul_static(F, S[..., :m], bits)
            assert {k: v for k, v in g1_cuda.launches().items() if v} == {"smul_static": 1}
            assert torch.equal(got, want[..., :m]), (len(bits), m)


def test_redesigned_kernels_compile_without_stack_or_spill():
    """ptxas' report for pairing_check_kernel, the static ladder
    (g1_smul_ladder_kernel with STATIC) and dbladd (g1_dbladd_kernel): no
    stack, no spill; dbladd at most 128 registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import check_ptxas, no_stack_or_spill, ptxas_entries, static_ptxas
    from mathlib_tpu_torch.ops.kernels import build

    build.load()
    dbladd = [e for e in ptxas_entries(build.BUILD_LOG) if e.startswith("g1_dbladd_kernel")]
    entries = check_ptxas(build.BUILD_LOG) + static_ptxas(build.BUILD_LOG) + dbladd
    # (NW, G) of the check; NW of the static ladder; NW of dbladd (also 9)
    assert len(entries) == 2 * 3 + 2 + 3, entries
    for entry in entries:
        assert no_stack_or_spill(entry), entry
    for entry in dbladd:
        assert int(entry.split(": ")[1].split()[0]) <= 128, entry


def test_pairing_check_equals_its_plain_version(pair_ctx):
    """The one-launch check on 40 lanes with n = 37 (3 pad lanes holding
    points): the verdict and the unreduced product equal the
    plain version's (the kernel multiplies the lanes by the plain tree)."""
    eng, be = pair_ctx
    if not be.pair.supports_fused_check:
        pytest.skip("the one-launch check takes BLS12 curves")
    cfg = be.pair.cfg
    P = eng.g1.mul(eng.gen_g1, 12345)
    g1s, g2s = _pairs(eng, 38, 9)
    g1s, g2s = [P, eng.g1.neg(P)] + g1s, [eng.gen_g2, eng.gen_g2] + g2s
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
    pairing_cuda.reset_launches()
    for n in (2, 37):
        ok, prod = pairing_cuda.pairing_check(cfg, xP, yP, Qx, Qy, n)
        ok_p, prod_p = pairing_cuda.pairing_check_plain(cfg, xP, yP, Qx, Qy, n)
        assert bool(ok) == bool(ok_p) == (n == 2) and torch.equal(prod, prod_p), n
    assert pairing_cuda.launches()["pairing_check"] == 2


@pytest.mark.parametrize("wr", [72, 48, 128])
def test_gathers_equal_plain_versions(wr):
    """Both gathers on a (5,000, wr) table, 4,097 indices (a ragged tile),
    int64 and int32, against table[idx] and table[idx].T.contiguous()."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.kernels import gather_cuda

    rng = np.random.default_rng(wr)
    table = torch.from_numpy(rng.integers(-2**31, 2**31, (5000, wr), dtype=np.int64)
                             .astype(np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 5000, 4097)).cuda()
    gather_cuda.reset_launches()
    for i in (idx, idx.to(torch.int32)):
        assert torch.equal(gather_cuda.gather_rows(table, i), gather_cuda.gather_rows_plain(table, i))
        got = gather_cuda.gather_rows_t(table, i)
        assert got.is_contiguous() and torch.equal(got, gather_cuda.gather_rows_t_plain(table, i))
    assert gather_cuda.launches() == {"gather_rows": 2, "gather_rows_t": 2}


@pytest.fixture
def hash_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.hash import get_hash_g1_ctx

    return get_hash_g1_ctx(get_spec("BLS12_381"))


def test_hash_kernels_equal_plain_versions(hash_ctx):
    """hash_g1 under both signs and smul_static on 1,000 lanes, the edge
    lanes u = 0, 1, p - 1 and a nonzero u with t2 = 0 first; P = inf among
    the ladder's lanes."""
    ctx = hash_ctx
    p, n = ctx.spec.p, 1000
    rng = np.random.default_rng(11)
    t2_zero = pow(-pow(11, -1, p) % p, (p + 1) // 4, p)
    us = [[0, 1, p - 1, t2_zero] + [int.from_bytes(rng.bytes(48), "big") % p
                                    for _ in range(n - 4)] for _ in range(2)]
    u0, u1 = ctx.fp.encode(us[0]), ctx.fp.encode(us[1][::-1])
    hash_cuda.reset_launches()
    g1_cuda.reset_launches()
    for sign in ("parity", "be"):
        got = hash_cuda.hash_g1(ctx, u0, u1, sign)
        assert torch.equal(got, hash_cuda.hash_g1_plain(ctx, u0, u1, sign)), sign
    P = got.clone()
    P[..., 5] = ctx.g1.inf[..., 0]
    assert torch.equal(g1_cuda.smul_static(ctx.g1.F, P, ctx.h_bits),
                       g1_cuda.smul_static_plain(ctx.g1.F, P, ctx.h_bits))
    assert hash_cuda.launches() == {"hash_g1": 2}
    assert g1_cuda.launches()["smul_static"] == 1
    with pytest.raises(ValueError):
        hash_cuda.hash_g1(ctx, u0[:-2], u1[:-2])


def _hash_edge_lanes(ctx, n, seed):
    """(u0, u1) Montgomery batches of n lanes: chip_smoke.py phase 12's edge
    lanes first (u0 = 0, 1, p - 1 and a nonzero u with t2 = 0, beside u1 =
    1, 0, 7 and its negation), then random field elements."""
    p = ctx.spec.p
    rng = np.random.default_rng(seed)
    t2_zero = pow(-pow(11, -1, p) % p, (p + 1) // 4, p)
    rand = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(2 * n)]
    us0 = ([0, 1, p - 1, t2_zero] + rand[:n])[:n]
    us1 = ([1, 0, 7, p - t2_zero] + rand[n:])[:n]
    return ctx.fp.encode(us0), ctx.fp.encode(us1)


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_hash_g1_kernel_on_ragged_lanes(hash_ctx, n):
    """hash_g1 (a lane over four groups of two threads, 16 lanes a block)
    against its plain version under both signs on 1, 7, 1,000 and 4,097
    lanes: a partial block, a half-filled warp, the edge lanes first.  One
    launch a call."""
    ctx = hash_ctx
    u0, u1 = _hash_edge_lanes(ctx, n, n)
    for sign in ("parity", "be"):
        hash_cuda.reset_launches()
        got = hash_cuda.hash_g1(ctx, u0, u1, sign)
        assert hash_cuda.launches() == {"hash_g1": 1}
        assert torch.equal(got, hash_cuda.hash_g1_plain(ctx, u0, u1, sign)), (n, sign)


def test_hash_g1_compiles_without_stack_or_spill():
    """ptxas' report for hash_g1_kernel: no stack, no spill, at most 128
    registers (the kernel's launch bounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import ptxas_entries
    from mathlib_tpu_torch.ops.kernels import build

    build.load()
    entries = [e for e in ptxas_entries(build.BUILD_LOG) if e.startswith("hash_g1_kernel")]
    assert entries, "no ptxas line for hash_g1_kernel in the build log"
    for entry in entries:
        assert int(entry.split(": ")[1].split()[0]) <= 128, entry
        assert entry.endswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"), entry


def _pow_rows(fp, shape, rng):
    """Relaxed limbs of ``shape`` (rows, L, n), the edge values 0, 1, p - 1,
    p, 2p - 1 first."""
    p, L = fp.p, fp.L
    vals = [int.from_bytes(rng.bytes(L * 2), "little") % (2 * p)
            for _ in range(shape[0] * shape[2])]
    vals[:5] = [0, 1, p - 1, p, 2 * p - 1][: len(vals)]
    limbs = [[(v >> (16 * k)) & 0xFFFF for k in range(L)] for v in vals]
    arr = np.array(limbs, dtype=np.int32).reshape(shape[0], shape[2], L)
    return torch.from_numpy(arr.transpose(0, 2, 1).copy()).cuda()


@pytest.mark.parametrize("group", [1, 4])
def test_fp_pow_kernel_bodies_equal_the_plain_version(monkeypatch, group):
    """fp_pow with each body (one element a thread, or a group of four
    threads an element, forced through fp_cuda.pow_group) at (L, 2,048),
    (1, L, 1), a ragged (2, L, 4,097) and zeros, L = 24 and 16, for p - 2
    and (p + 1)/4, on relaxed limbs with the edge values.  One launch a
    call.  With one thread an element also FP256BN's L = 18."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.field import FpCtx, base_limbs

    monkeypatch.setattr(fp_cuda, "pow_group", lambda elements: group)
    for curve in ("BLS12_381", "BN254") + (("FP256BN",) if group == 1 else ()):
        p = get_spec(curve).p
        fp = FpCtx(p, torch.device("cuda"), L=base_limbs(p, torch.device("cuda")))
        rng = np.random.default_rng(fp.L + group)
        tensors = [_pow_rows(fp, (1, fp.L, 2048), rng)[0], _pow_rows(fp, (1, fp.L, 1), rng),
                   _pow_rows(fp, (2, fp.L, 4097), rng),
                   torch.zeros((3, fp.L, 33), dtype=torch.int32, device="cuda")]
        for e in (p - 2, (p + 1) // 4):
            bits = [int(b) for b in bin(e)[2:]]
            for a in tensors:
                fp_cuda.reset_launches()
                got = fp_cuda.fp_pow(fp, a, bits)
                assert fp_cuda.launches()["fp_pow"] == 1
                assert torch.equal(got, fp_cuda.fp_pow_plain(fp, a, bits)), (curve, a.shape)


def test_fp_pow_on_both_sides_of_its_switch():
    """fp_pow as the wrapper picks its body, one element below
    fp_cuda.POW_GROUP_BELOW (the group body) and at it (one element a
    thread), on BLS12-381's p - 2 with the edge values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.field import FpCtx

    p = get_spec("BLS12_381").p
    fp = FpCtx(p, torch.device("cuda"))
    bits = [int(b) for b in bin(p - 2)[2:]]
    rng = np.random.default_rng(16)
    edge = fp_cuda.POW_GROUP_BELOW
    assert fp_cuda.pow_group(edge - 1) == 4 and fp_cuda.pow_group(edge) == 1
    for n in (edge - 1, edge):
        a = _pow_rows(fp, (1, fp.L, n), rng)
        assert torch.equal(fp_cuda.fp_pow(fp, a, bits), fp_cuda.fp_pow_plain(fp, a, bits)), n


def test_bls_sign_and_verify_on_the_card(hash_ctx):
    """bls_sign_batch and bls_verify_batch on 8 messages through the card's
    kernels, against the host hasher."""
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher

    spec = hash_ctx.spec
    eng, be = get_engine(spec), BatchEngine(spec)
    msgs = [bytes([i]) * 32 for i in range(8)]
    dst = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
    sk = 0xC0FFEE
    hash_cuda.reset_launches()
    sigs = be.bls_sign_batch(sk, msgs, dst)
    assert hash_cuda.launches() == {"hash_g1": 1}
    hasher = get_hasher(spec)
    assert sigs == [eng.g1.mul(hasher.hash_to_g1(m, dst), sk) for m in msgs]
    pk = eng.g2.mul(eng.gen_g2, sk)
    assert be.bls_verify_batch(pk, sigs, msgs, dst) is True
    assert be.bls_verify_batch(pk, sigs[:7] + [sigs[0]], msgs, dst) is False



@pytest.fixture
def g2_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.g2 import G2Ctx

    spec = get_spec("BLS12_381")
    return get_engine(spec), G2Ctx(spec, torch.device("cuda"))


def test_g2_kernels_equal_plain_versions(g2_ctx):
    """The six G2 kernels against their plain versions on 1,000 relaxed lanes
    (P = Q, P = -Q, infinity on either side), the ladders on 64 lanes with
    k = 0, 1 and r - 1; one launch each."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    eng, g2 = g2_ctx
    F = g2.rows
    n = 1000
    rng = np.random.default_rng(12)
    pool = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, 15)] + [None]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 7):
        A[i] = B[i]
    for i in range(3, n, 11):
        A[i] = eng.g2.neg(B[i]) if B[i] else None
    Q = g2.encode_points(B)
    P = g2_cuda.add_plain(F, g2.encode_points(A), Q)  # relaxed [0, 2p)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(P.device)
    g2_cuda.reset_launches()
    pairs = [
        (g2_cuda.add(F, P, Q), g2_cuda.add_plain(F, P, Q)),
        (g2_cuda.double(F, P), g2_cuda.double_plain(F, P)),
        (g2_cuda.addsel(F, P, Q, sel), g2_cuda.addsel_plain(F, P, Q, sel)),
        (g2_cuda.dblsel(F, P, Q, sel), g2_cuda.dblsel_plain(F, P, Q, sel)),
    ]
    ks = g2.encode_scalars([0, 1, eng.spec.r - 1] + [int(k) for k in rng.integers(1, 1 << 62, 61)])
    pairs.append((g2_cuda.smul(F, P[..., :64], ks, g2.nbits),
                  g2_cuda.smul_plain(F, P[..., :64], ks, g2.nbits)))
    bits = [1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1]
    pairs.append((g2_cuda.smul_static(F, P[..., :64], bits),
                  g2_cuda.smul_static_plain(F, P[..., :64], bits)))
    for got, want in pairs:
        assert torch.equal(got, want)
    assert g2_cuda.launches() == {k: 1 for k in ("g2_add", "g2_double", "g2_addsel", "g2_dblsel",
                                                 "g2_smul", "g2_smul_static")}
    fp256 = type(g2)(get_spec("FP256BN"), P.device)  # in the gate, at L = 18 on the card
    assert fp256.fp.L == 18
    assert torch.equal(fp256.add(fp256.gen, fp256.gen),
                       g2_cuda.add_plain(fp256.rows, fp256.gen, fp256.gen))
    odd = type(g2)(get_spec("FP256BN"), P.device, L=17)  # the reference's L: refused
    with pytest.raises(ValueError):
        odd.add(odd.gen, odd.gen)
    with pytest.raises(TypeError):
        g2_cuda.double(F, P.to(torch.int64))


@pytest.mark.parametrize("blocks", [16, 32])
def test_g2_ladders_on_a_ragged_batch_and_a_block_that_never_adds(g2_ctx, blocks):
    """The two ladders against their plain versions on a ragged count of
    relaxed lanes (a partial last block), lanes 32-63 with k = 0 (a 32-lane
    block, or two 16-lane ones, that skips the add at every bit) and k = 0, 1
    and 2^64 - 1 (every bit set) among the rest, over 64 bits.  The launcher takes 16-lane blocks up to 16
    lanes an SM and 32-lane ones above, so 100 lanes reach the first and 88
    lanes past that count the second."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    eng, g2 = g2_ctx
    F = g2.rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, nbits = (100 if blocks == 16 else 16 * sms + 88), 64
    rng = np.random.default_rng(14)
    pool = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, 15)] + [None]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    Q = g2_cuda.add_plain(F, g2.encode_points(A), g2.encode_points(A[::-1]))
    ks = [int(k) for k in rng.integers(1, 1 << 62, n)]
    ks[:3] = [0, 1, (1 << nbits) - 1]
    ks[32:64] = [0] * 32
    K = g2.encode_scalars(ks)
    bits = [int(b) for b in bin(0xD201000000010000)[2:]]
    assert torch.equal(g2_cuda.smul(F, Q, K, nbits), g2_cuda.smul_plain(F, Q, K, nbits))
    assert torch.equal(g2_cuda.smul_static(F, Q, bits), g2_cuda.smul_static_plain(F, Q, bits))


@pytest.fixture(scope="module")
def g2_edge_lanes():
    """4,097 relaxed BLS12-381 lanes P, Q: P = Q on every 7th lane, P = -Q on
    every 17th, P at infinity on every 11th, Q on every 13th."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.ops.g2 import G2Ctx
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    spec = get_spec("BLS12_381")
    eng, g2 = get_engine(spec), G2Ctx(spec, torch.device("cuda"))
    n = 4097
    rng = np.random.default_rng(18)
    pool = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, 15)] + [None]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 7):
        B[i] = A[i]
    for i in range(3, n, 17):
        B[i] = eng.g2.neg(A[i]) if A[i] else None
    for i in range(5, n, 11):
        A[i] = None
    for i in range(6, n, 13):
        B[i] = None
    Q = g2.encode_points(B)
    # A + infinity: the same points, in relaxed projective limbs
    P = g2_cuda.add_plain(g2.rows, g2.encode_points(A), g2.encode_points([None] * n))
    P[..., 0::7] = Q[..., 0::7]  # P = Q limb for limb
    return g2, P, Q


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 2113, 4097])
def test_g2_add_and_double_equal_plain_versions_on_edge_lanes(g2_edge_lanes, n):
    """The block add and doubling kernels against their plain versions, bit
    for bit, at lane counts around their 16- and 32-lane blocks (2,113: past
    16 lanes an SM on an H100), one launch each."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    g2, P, Q = g2_edge_lanes
    F = g2.rows
    p, q = P[..., :n].contiguous(), Q[..., :n].contiguous()
    g2_cuda.reset_launches()
    assert torch.equal(g2_cuda.add(F, p, q), g2_cuda.add_plain(F, p, q))
    assert torch.equal(g2_cuda.double(F, p), g2_cuda.double_plain(F, p))
    assert torch.equal(g2_cuda.double(F, q), g2_cuda.double_plain(F, q))
    assert {k: v for k, v in g2_cuda.launches().items() if v} == {"g2_add": 1, "g2_double": 2}


@pytest.mark.parametrize("n", [100, 4097])
def test_g2_dblsel_on_edge_lanes_blocks_and_batch_dims(g2_edge_lanes, n):
    """dblsel (one bit of the G2 ladder with acc read from P) against
    dblsel_plain, bit for bit, on the edge lanes (P = Q, P = -Q, infinity
    on either side) with Q = 2P and Q = -2P lanes added, in the launcher's
    16-lane blocks (100 lanes) and 32-lane blocks (4,097: past 16 lanes an
    SM on an H100), lanes 32-63 unselected (a 32-lane block, or two 16-lane
    ones, that never adds) and 64-95 all selected; then with leading batch
    dims (2, 3) and Q broadcast over them.  One launch a call."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    g2, P, Q = g2_edge_lanes
    F = g2.rows
    p, q = P[..., :n].contiguous(), Q[..., :n].clone()
    D = g2_cuda.double_plain(F, p)
    q[..., 2::7] = D[..., 2::7]
    q[..., 4::17] = g2.neg(D)[..., 4::17]
    rng = np.random.default_rng(n)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(p.device)
    sel[32:64], sel[64:96] = False, True
    g2_cuda.reset_launches()
    assert torch.equal(g2_cuda.dblsel(F, p, q, sel), g2_cuda.dblsel_plain(F, p, q, sel))
    pb = torch.stack([p[..., 16 * j:16 * (j + 1)] for j in range(6)]).reshape(
        (2, 3) + p.shape[:-1] + (16,))
    qb, selb = q[..., :16], sel[:96].reshape(2, 3, 16)
    got = g2_cuda.dblsel(F, pb, qb, selb)
    assert got.shape == pb.shape
    assert torch.equal(got, g2_cuda.dblsel_plain(F, pb, qb, selb))
    assert {k: v for k, v in g2_cuda.launches().items() if v} == {"g2_dblsel": 2}


@pytest.mark.parametrize("n", [100, 4097])
def test_g2_addsel_on_edge_lanes_and_blocks(g2_edge_lanes, n):
    """addsel (the G2 add's half with a lane-by-lane select) against
    addsel_plain, bit for bit, on the edge lanes (P = Q, P = -Q, infinity on
    either side) and on their relaxed sums, in the launcher's 16-lane blocks
    (100 lanes) and 32-lane blocks (4,097: past 16 lanes an SM on an H100),
    15/16 of the lanes selected, lanes 32-63 unselected (a 32-lane block, or
    two 16-lane ones, that stores Q and adds nowhere) and 64-95 all
    selected.  One launch a call."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    g2, P, Q = g2_edge_lanes
    F = g2.rows
    p, q = P[..., :n].contiguous(), Q[..., :n].contiguous()
    rng = np.random.default_rng(n + 1)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(p.device)
    sel[32:64], sel[64:96] = False, True
    g2_cuda.reset_launches()
    for a in (p, g2_cuda.add_plain(F, p, q)):
        assert torch.equal(g2_cuda.addsel(F, a, q, sel), g2_cuda.addsel_plain(F, a, q, sel))
    assert {k: v for k, v in g2_cuda.launches().items() if v} == {"g2_addsel": 2}


def test_g2_block_kernels_compile_without_stack_or_spill():
    """ptxas' report for the G2 ladders and the add, doubling, addsel and
    dblsel kernels on their steps, at 16- and 32-lane blocks, at 12 words
    and (but the static ladder) 9: at most 96 registers, no stack, no
    spill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import g2_ladder_ptxas, no_stack_or_spill
    from mathlib_tpu_torch.ops.kernels import build

    build.load()
    entries = g2_ladder_ptxas(build.BUILD_LOG)
    assert len(entries) == 12 + 10, entries
    for nw in (12, 9):
        for kern in ("g2_add_kernel", "g2_double_kernel", "g2_dblsel_kernel", "g2_addsel_kernel"):
            for lb in (16, 32):
                name = f"{kern}<{nw},{lb}>"
                assert any(e.startswith(name + ":") for e in entries), (name, entries)
    for entry in entries:
        assert int(entry.split(": ")[1].split()[0]) <= 96, entry
        assert no_stack_or_spill(entry), entry


def test_g2_entry_points_on_the_card(g2_ctx):
    """hash_to_g2_batch (word path) and g2_scalar_mul against the host, on the
    kernels; BN254's g2_scalar_mul on the weier fallback over mont_mul."""
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher
    from mathlib_tpu_torch.ops.hash import hash_to_g2_batch
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    eng, g2 = g2_ctx
    spec = eng.spec
    dst = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
    msgs = [bytes([i]) * 32 for i in range(6)]
    g2_cuda.reset_launches()
    out = hash_to_g2_batch(spec, msgs, dst)
    assert g2_cuda.launches() == {"g2_add": 3, "g2_double": 1, "g2_addsel": 0, "g2_dblsel": 0,
                                  "g2_smul": 0, "g2_smul_static": 2}
    hasher = get_hasher(spec)
    assert g2.decode_points(out) == [hasher.hash_to_g2(m, dst) for m in msgs]
    rng = np.random.default_rng(13)
    pts = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, 4)] + [None]
    ks = [0, spec.r - 1, 5, int(rng.integers(1, 1 << 62)), 9]
    be = BatchEngine(spec)
    assert be.g2_scalar_mul(pts, ks) == [eng.g2.mul_any(P, k) for P, k in zip(pts, ks)]
    assert g2_cuda.launches()["g2_smul"] == 1
    bn = get_spec("BN254")
    eng_bn = get_engine(bn)
    pts = [eng_bn.g2.mul(eng_bn.gen_g2, 7), None]
    fp_cuda.reset_launches()
    assert BatchEngine(bn).g2_scalar_mul(pts, [11, 3]) == [eng_bn.g2.mul(pts[0], 11), None]
    assert fp_cuda.launches()["mont_mul"] > 0


def test_gt_pow_and_the_api_msm_on_the_card():
    """``TowerCtx.f12_pow_bits`` is one ``f12_pow`` launch equal to its plain
    version at a ragged lane count; ``Curves[...].MultiScalarMul`` at 64 and
    65 points runs the bridge's kernels and equals the host fold, and so
    does FP256BN's on both of its IDs (the kernels at nine words)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mathlib_tpu_torch.api import CurveID, Curves
    from mathlib_tpu_torch.ops.kernels import gather_cuda
    from mathlib_tpu_torch.ops.tower import TowerCtx

    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    tw = TowerCtx(spec)
    rng = np.random.default_rng(21)
    vals = [eng.gt_exp(eng.gen_gt(), int(k)) for k in rng.integers(1, 1 << 62, 37)]
    a = torch.cat([tw.f12_encode(v) for v in vals], dim=-1)
    e = int.from_bytes(rng.bytes(32), "big") % spec.r
    bits = np.array([(e >> i) & 1 for i in range(e.bit_length())], dtype=np.uint8)
    pairing_cuda.reset_launches()
    got = tw.f12_pow_bits(a, bits)
    assert pairing_cuda.launches()["f12_pow"] == 1
    want = pairing_cuda.f12_pow_plain(tw.kcfg, a, bits[::-1].copy(), False)
    assert torch.equal(got, want)
    assert tw.f12_decode(got[..., :3]) == [tw.host.f12_pow(v, e) for v in vals[:3]]

    c = Curves[CurveID.BLS12_381]
    for n in (64, 65):
        g1s = [c.GenG1.Mul(c.NewZrFromInt(i % 19 + 1)) for i in range(n)]
        zrs = [c.NewZrFromInt(int(k)) for k in rng.integers(0, 1 << 62, n)]
        zrs[3] = c.NewZrFromInt(0)
        g1s[7] = c.NewG1()
        acc = c.NewG1()
        for g, z in zip(g1s, zrs):
            acc.Add(g.Mul(z))
        g1_cuda.reset_launches()
        gather_cuda.reset_launches()
        assert c.MultiScalarMul(g1s, zrs).Equals(acc)
        assert g1_cuda.launches()["maddsel"] > 0 and gather_cuda.launches()["gather_rows_t"] > 0
    for cid in (CurveID.FP256BN_AMCL, CurveID.FP256BN_AMCL_MIRACL):
        f = Curves[cid]
        g1s = [f.GenG1.Mul(f.NewZrFromInt(i % 7 + 1)) for i in range(64)]
        zrs = [f.NewZrFromInt(int(k)) for k in rng.integers(0, 1 << 62, 64)]
        g1s[5] = f.NewG1()
        acc = f.NewG1()
        for g, z in zip(g1s, zrs):
            acc.Add(g.Mul(z))
        g1_cuda.reset_launches()
        assert f.MultiScalarMul(g1s, zrs).Equals(acc)
        assert g1_cuda.launches()["maddsel"] > 0


# ---- FP256BN on the card: its contexts hold L = 18 (nine 32-bit words), and
# every entry point of the slice runs on the NW = 9 kernels


@pytest.fixture(scope="module")
def fp256():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_spec("FP256BN")
    return get_engine(spec), BatchEngine(spec)


def test_fp256bn_contexts_and_the_edge_on_the_card(fp256):
    """Every base-field context of FP256BN's engine holds L = 18 on the card
    (the scalar field 17); ``widen_limbs`` and ``narrow_limbs`` on the card
    (mont_mul at nine words) equal their plain versions on the CPU."""
    from mathlib_tpu_torch.ops.field import FpCtx, narrow_limbs, widen_limbs

    eng, be = fp256
    assert {be.fp.L, be.g1.fp.L, be.g2.fp.L, be.pair.cfg.fp.L} == {18}
    assert be.g1.fr.L == 17
    p = eng.spec.p
    f17 = FpCtx(p, "cpu")
    xs = [0, 1, p - 1] + [int(k) for k in np.random.default_rng(30).integers(2, 1 << 62, 61)]
    a17 = f17.encode(xs)
    fp_cuda.reset_launches()
    w = widen_limbs(be.fp, a17.cuda())
    n = narrow_limbs(be.fp, w, 17)
    assert fp_cuda.launches()["mont_mul"] == 2
    cpu18 = FpCtx(p, "cpu", L=18)
    assert torch.equal(w.cpu(), widen_limbs(cpu18, a17))
    assert torch.equal(n.cpu(), narrow_limbs(cpu18, w.cpu(), 17))
    assert list(f17.decode(n)) == xs


def test_fp256bn_g1_entry_points_on_the_card(fp256):
    """``g1_msm`` (the projective scan: addsel), ``g1_msm_device`` on points
    at the reference's L = 17, and ``g1_scalar_mul`` (the ladder, then
    ``batch_inv`` on fp_pow) against the host engine."""
    from mathlib_tpu_torch.ops.kernels import gather_cuda

    eng, be = fp256
    spec = eng.spec
    rng = np.random.default_rng(31)
    pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 16)]
    pts = [pool[i] for i in rng.integers(0, 16, 300)]
    pts[7] = None
    ks = [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(300)]
    ks[9] = 0
    want = eng.g1.msm([P for P in pts if P], [k for P, k in zip(pts, ks) if P])
    g1_cuda.reset_launches()
    gather_cuda.reset_launches()
    assert be.g1_msm(pts, ks) == want
    assert g1_cuda.launches()["addsel"] > 0 and gather_cuda.launches()["gather_rows_t"] > 0
    g17 = G1Ctx(spec, "cpu")
    out = be.g1_msm_device(g17.encode_points(pts).cuda(), g17.encode_scalars(ks).cuda())
    assert out.shape == (3, 17, 1) and g17.decode_point(out) == want
    g1_cuda.reset_launches()
    fp_cuda.reset_launches()
    assert be.g1_scalar_mul(pts[:9], ks[:9]) == [None if P is None else eng.g1.mul(P, k)
                                                for P, k in zip(pts[:9], ks[:9])]
    assert g1_cuda.launches()["smul"] == 1 and fp_cuda.launches()["fp_pow"] == 1


def test_fp256bn_pairing_batch_on_the_card(fp256):
    """``pairing_batch`` on miller_ft, the BN tail's two add_step and one
    final_exp (the BN script, 4 base-p digits) against the host engine."""
    eng, be = fp256
    g1s, g2s = _pairs(eng, 6, 32)
    pairing_cuda.reset_launches()
    assert be.pairing_batch(g1s, g2s) == [eng.pairing(P, Q) for P, Q in zip(g1s, g2s)]
    assert {k: v for k, v in pairing_cuda.launches().items() if v} == {
        "miller_ft": 1, "add_step": 2, "final_exp": 1}


@pytest.mark.parametrize("strategy", [None, "split"])
def test_fp256bn_product_checks_on_the_card(fp256, monkeypatch, strategy):
    """A true and a false product check and grouped checks of two pairs
    under the default (miller_lanes, the product tree, the host final exp)
    and ``MATHLIB_PAIR_FUSED=split`` (BN curves keep the default there)."""
    eng, be = fp256
    if strategy:
        monkeypatch.setenv("MATHLIB_PAIR_FUSED", strategy)
    P = eng.g1.mul(eng.gen_g1, 12345)
    nP, G = eng.g1.neg(P), eng.gen_g2
    g1s, g2s = _pairs(eng, 2, 33)
    pairing_cuda.reset_launches()
    assert be.pairing_product_is_one([P, nP], [G, G]) is True
    assert be.pairing_product_is_one(g1s, g2s) is False
    assert be.pairing_products_are_one([P, nP] + g1s + [P, nP], [G, G] + g2s + [G, G], 2) == [
        True, False, True]
    got = pairing_cuda.launches()
    assert got["miller_lanes"] == 3 and got["f12_seg_product"] >= 3


def test_fp256bn_bls_sign_and_verify_on_the_card(fp256):
    """``bls_sign_batch`` (the host hasher, the ladder, affine on the card)
    and ``bls_verify_batch`` (two MSMs and a two-pair check), True and
    False with one signature replaced."""
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher

    eng, be = fp256
    dst = b"FP256BN-SIG-TEST"
    msgs = [b"m-%d" % i for i in range(5)]
    sk = 0x1234567890ABCDEF
    pk = eng.g2.mul(eng.gen_g2, sk)
    sigs = be.bls_sign_batch(sk, msgs, dst)
    assert sigs == [eng.g1.mul(get_hasher(eng.spec).hash_to_g1(m, dst), sk) for m in msgs]
    assert be.bls_verify_batch(pk, sigs, msgs, dst)
    assert not be.bls_verify_batch(pk, sigs[:4] + [sigs[0]], msgs, dst)


def test_fp256bn_g2_kernels_and_scalar_mul_on_the_card(fp256):
    """The G2 kernels at nine words (g2_add, g2_double, g2_addsel, g2_dblsel,
    the ladder) against their plain versions on 100 lanes with P = Q, P =
    -Q and infinity, and ``g2_scalar_mul`` (one ladder launch) against the
    host engine."""
    from mathlib_tpu_torch.ops.kernels import g2_cuda

    eng, be = fp256
    g2, F = be.g2, be.g2.rows
    n = 100
    rng = np.random.default_rng(34)
    pool = [eng.g2.mul(eng.gen_g2, int(k)) for k in rng.integers(1, 1 << 62, 9)] + [None]
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 7):
        A[i] = B[i]
    for i in range(3, n, 11):
        A[i] = eng.g2.neg(B[i]) if B[i] else None
    Q = g2.encode_points(B)
    P = g2_cuda.add_plain(F, g2.encode_points(A), Q)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(P.device)
    ks = g2.encode_scalars([0, 1, eng.spec.r - 1] + [int(k) for k in rng.integers(1, 1 << 62, 61)])
    g2_cuda.reset_launches()
    for got, want in [(g2_cuda.add(F, P, Q), g2_cuda.add_plain(F, P, Q)),
                      (g2_cuda.double(F, P), g2_cuda.double_plain(F, P)),
                      (g2_cuda.addsel(F, P, Q, sel), g2_cuda.addsel_plain(F, P, Q, sel)),
                      (g2_cuda.dblsel(F, P, Q, sel), g2_cuda.dblsel_plain(F, P, Q, sel)),
                      (g2_cuda.smul(F, P[..., :64], ks, g2.nbits),
                       g2_cuda.smul_plain(F, P[..., :64], ks, g2.nbits))]:
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError):  # the static ladders are not built at nine words
        g2_cuda.smul_static(F, P, [1, 0, 1])
    pts = [pool[0], pool[1], None, pool[2]]
    kk = [5, eng.spec.r - 1, 9, 0]
    g2_cuda.reset_launches()
    assert be.g2_scalar_mul(pts, kk) == [eng.g2.mul_any(P, k) if P else None
                                         for P, k in zip(pts, kk)]
    assert {k: v for k, v in g2_cuda.launches().items() if v} == {"g2_smul": 1}
