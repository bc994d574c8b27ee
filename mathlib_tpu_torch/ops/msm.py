"""Multi-scalar multiplication (Pippenger), port of ``mathlib_tpu/ops/msm.py``.

The staging is the reference's:

  1. windowed digits of all scalars (``_digits``),
  2. per window: a stable sort of the point indices by digit,
  3. a streaming scan over K chunk steps: each step gathers one sorted slice
     of point rows for ALL windows (the ``gather_rows_t`` kernel: the row
     gather and the relayout to lanes in one pass) and advances the
     segmented running sums with the ``add_select`` kernel, which writes
     every step's running sums straight into the capture buffer
     (``capture="dense"``),
  4. one row gather of segment ends from the capture buffer into the bucket
     table, then cross-chunk carries from a recursive segmented scan over the
     chunk summaries (``_seg_scan_inclusive``),
  5. weighted bucket sums by bit/byte decomposition of the bucket index
     (masked tree reductions, then a short Horner over bits),
  6. Horner over windows -- on the host C++ engine (``horner_host``) on the
     main path, or on the device (``horner_windows``).

Layout: points are (3, L, N) int32 with the batch N last.  Indices, keys and
positions are int64 (the reference's uint32 sentinel ``0xFFFFFFFF`` is a
plain int64 value here).  Sorts are stable, as ``jnp.argsort`` is, so ties
add in the reference's order and every window total comes out as the same
projective representative, limb for limb.

The options of the reference are ported with it: signed (balanced) digits
(``signed=True``, the ``add_select_neg`` combiner, half the buckets), affine
``(2, L, N)`` points (the mixed-add combiners ``madd_select(_neg)``), the
GLV split on BLS12 curves (``glv=True``: 2N points with 128-bit
sub-scalars, ``GlvCtx``), and the host bridge behind the API's
``MultiScalarMul`` (``msm_host_bridge``).  Only ``capture="scatter"`` (the
in-scan scatter) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .field import LIMB_BITS, _conv, _normalize, _pad_top
from .g1 import G1Ctx, get_g1_ctx
from .kernels.gather_cuda import gather_rows_t

Tensor = torch.Tensor

_SENTINEL = 0xFFFFFFFF

# dense-capture buffer budget: above this the bucket table is computed in
# halves (pointwise-added); the reference's in-scan scatter is not ported
_DENSE_CAPTURE_LIMIT = 6 << 30


def _digits(scalars: Tensor, c: int, nwin: int) -> Tensor:
    """(S, N) 16-bit scalar limbs -> (nwin, N) int64 window digits (c | 16)."""
    per = LIMB_BITS // c
    wins = [
        (scalars[(w * c) // LIMB_BITS] >> ((w % per) * c)) & ((1 << c) - 1)
        for w in range(nwin)
    ]
    return torch.stack(wins).to(torch.int64)


def _signed_digits(scalars: Tensor, c: int, nwin: int, nbits: Optional[int] = None):
    """Balanced (signed) window digits: k = sum_w d_w 2^(cw) with d_w in
    [-(2^(c-1)-1), 2^(c-1)].

    Returns (abs, neg): int64 magnitudes in [0, 2^(c-1)] and bool sign flags,
    (nwin, N) -- or (nwin + 1, N) when scalars may reach 2^(c*nwin - 1)
    (``nbits`` None or >= c*nwin), where the extra top window holds the
    outgoing carry."""
    raw = _digits(scalars, c, nwin)  # (nwin, N) in [0, 2^c)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(raw[0])
    absd, neg = [], []
    for d in raw:
        t = d + carry
        ng = t > half
        absd.append(torch.where(ng, full - t, t))
        neg.append(ng)
        carry = ng.to(raw.dtype)
    if nbits is None or nbits >= c * nwin:
        absd.append(carry)
        neg.append(torch.zeros_like(neg[0]))
    return torch.stack(absd), torch.stack(neg)


def _seg_scan_inclusive(g1: G1Ctx, keys: Tensor, pts: Tensor, K: int = 64) -> Tensor:
    """Inclusive segmented point-sum scan along the last (lane) axis.

    keys: (..., N) sorted; pts: (..., 3, L, N).  Returns (..., 3, L, N).
    Used for the (small) chunk-summary levels of the bucket accumulation.
    """
    batch = keys.shape[:-1]
    N = keys.shape[-1]
    L = pts.shape[-2]
    dev = keys.device
    pad = 0
    if N > K:
        pad = (-N) % K
        if pad:
            keys = torch.cat(
                [keys, torch.full(batch + (pad,), _SENTINEL, dtype=keys.dtype, device=dev)],
                dim=-1,
            )
            pts = torch.cat([pts, g1.inf.expand(batch + (3, L, pad))], dim=-1)
        C = keys.shape[-1] // K
    else:
        C, K = 1, N

    k2 = keys.reshape(batch + (C, K)).movedim(-1, 0)  # (K, ..., C)
    p2 = pts.reshape(batch + (3, L, C, K)).movedim(-1, 0)  # (K, ..., 3, L, C)
    ck = torch.full(batch + (C,), _SENTINEL, dtype=keys.dtype, device=dev)
    run = g1.inf.expand(batch + (3, L, C))
    steps = []
    for s in range(K):
        run = g1.add_select(run, p2[s], k2[s] == ck)
        ck = k2[s]
        steps.append(run)
    local = torch.stack(steps, dim=-1).reshape(batch + (3, L, C * K))
    keys_c = keys.reshape(batch + (C, K))

    if C > 1:
        sum_keys = keys_c[..., -1]
        sum_pts = steps[-1]  # (..., 3, L, C): each chunk's last running sum
        inc = _seg_scan_inclusive(g1, sum_keys, sum_pts, K)
        carry_pt = torch.roll(inc, 1, dims=-1)
        carry_key = torch.roll(sum_keys, 1, dims=-1)
        valid = carry_key == keys_c[..., 0]
        valid[..., 0] = False
        first_seg = keys_c == keys_c[..., :1]
        mask = (first_seg & valid[..., None]).reshape(batch + (C * K,))
        carry_full = carry_pt.repeat_interleave(K, dim=-1)
        local = g1.add_select(carry_full, local, mask)

    return local[..., :N] if pad else local


def _bucket_table(
    g1: G1Ctx, points: Tensor, digits: Tensor, c: int, K: int = 64, neg: Optional[Tensor] = None
) -> Tensor:
    """Bucket sums for all windows: (3, L, W, B).

    points: (3, L, N) projective, or (2, L, N) affine (the mixed-add
    combiners; infinity inputs must carry zero digits); digits: (W, N).
    Unsigned (neg None): digits in [0, 2^c), B = 2^c buckets indexed by
    digit (bucket 0 is computed but unused downstream).  Signed: digits are
    |d| in [0, 2^(c-1)] with ``neg`` (W, N) sign flags, B = 2^(c-1) buckets
    indexed by |d| - 1 (|d| = 0 contributes nothing), and the gathered
    point's Y is negated inside the combiner.

    Dense capture: the scan emits every step's running sums into a capture
    buffer; segment-end positions come from the sorted keys alone, so the
    bucket table is ONE row gather from that buffer after the scan.
    """
    W, N = digits.shape
    L = points.shape[-2]
    signed = neg is not None
    B = 1 << (c - 1) if signed else 1 << c
    lo = 1 if signed else 0  # smallest digit that owns a bucket
    RP = points.shape[-3] * L  # words per GATHERED point row (2L affine)
    R = 3 * L  # words per accumulator/bucket row (projective)
    mixed = points.shape[-3] == 2
    dev = points.device

    # signed: the sign rides in bit 0 of the sort key, so one stable sort
    # gives consistent (|d|, neg) pairs
    key = (digits << 1) | neg.to(digits.dtype) if signed else digits
    order = torch.argsort(key, dim=1, stable=True)  # (W, N)
    keys = torch.gather(key, 1, order)
    negs = None
    if signed:
        negs = (keys & 1) != 0
        keys = keys >> 1

    pad = (-N) % K
    NP = N + pad
    if pad:
        keys = torch.cat(
            [keys, torch.full((W, pad), _SENTINEL, dtype=keys.dtype, device=dev)], dim=1
        )
        # gathered points for sentinel keys are never used
        order = torch.cat([order, torch.zeros((W, pad), dtype=order.dtype, device=dev)], dim=1)
        if signed:
            negs = torch.cat([negs, torch.zeros((W, pad), dtype=torch.bool, device=dev)], dim=1)
    C = NP // K
    win_ids = torch.arange(W, device=dev)[:, None]

    def bucket_of(k):  # digit -> flat bucket index (W*B = out of range)
        return torch.where((k >= lo) & (k - lo < B), win_ids * B + (k - lo), W * B)

    # last element of each segment (flat sorted order)
    is_last = torch.cat(
        [keys[:, :-1] != keys[:, 1:], torch.ones((W, 1), dtype=torch.bool, device=dev)],
        dim=1,
    )

    def to_steps(x):  # (W, NP) -> (K, W*C), step-major
        return x.reshape(W, C, K).movedim(-1, 0).reshape(K, W * C)

    keys_t = to_steps(keys)
    order_t = to_steps(order)
    negs_t = to_steps(negs) if signed else None

    # point-major copy for the streaming gather: one row = one point
    # (affine rows when mixed: 2L words instead of 3L)
    points_rows = points.reshape(RP, N).T.contiguous()  # (N, RP)
    inf_row = g1.inf.reshape(R)

    def combine(run, gathered, sel, ng, out):
        """One segmented-scan step on freshly gathered points, written by
        the combiner's kernel straight into ``out``."""
        if mixed:
            if signed:
                g1.madd_select_neg(run, gathered, sel, ng, out=out)
            else:
                g1.madd_select(run, gathered, sel, out=out)
        elif signed:
            g1.add_select_neg(run, gathered, sel, ng, out=out)
        else:
            g1.add_select(run, gathered, sel, out=out)

    # flat index into the (K, W*C) capture buffer of the running sum AT
    # sorted position (w, i): i = chunk*K + step
    i_idx = torch.arange(NP, device=dev)
    ys_pos = (i_idx % K)[None, :] * (W * C) + (win_ids * C + (i_idx // K)[None, :])
    # per-bucket capture position (sentinel = empty bucket); slot W*B is a
    # spare row that takes every non-segment-end write and is sliced away
    pos = torch.full((W * B + 1,), _SENTINEL, dtype=torch.int64, device=dev)
    pos[torch.where(is_last, bucket_of(keys), W * B).reshape(-1)] = ys_pos.reshape(-1)
    pos = pos[: W * B]

    # The capture buffer, preallocated and written in place one step at a
    # time (K * W*C * 3L * 4 bytes: 4.8 GB at 2^20 points, c=16).  Step s
    # reads the running sums of step s-1 straight out of it.
    ys = torch.empty((K, 3, L, W * C), dtype=torch.int32, device=dev)
    ck = torch.full((W * C,), _SENTINEL, dtype=keys.dtype, device=dev)
    run = g1.inf.expand(3, L, W * C)
    for s in range(K):
        gathered = gather_rows_t(points_rows, order_t[s]).view(points.shape[-3], L, W * C)
        combine(run, gathered, keys_t[s] == ck, negs_t[s] if signed else None, ys[s])
        run, ck = ys[s], keys_t[s]

    flat = pos.clamp(max=K * W * C - 1)
    rows = ys.view(K, R, W * C)[flat // (W * C), :, flat % (W * C)]  # (W*B, R)
    bucket_rows = torch.where((pos == _SENTINEL)[:, None], inf_row[None, :], rows)

    if C > 1:
        # cross-chunk carries from the chunk summaries (1/K the data)
        keys_c = keys.reshape(W, C, K)
        sum_keys = keys_c[..., -1]  # (W, C)
        sum_pts = run.reshape(3, L, W, C).movedim(-2, 0)  # (W, 3, L, C)
        inc = _seg_scan_inclusive(g1, sum_keys, sum_pts, K)  # (W, 3, L, C)
        carry_pt = torch.roll(inc, 1, dims=-1)
        carry_key = torch.roll(sum_keys, 1, dims=-1)
        first_key = keys_c[..., 0]  # (W, C)
        valid = carry_key == first_key
        valid[:, 0] = False
        # the carried-into segment must END within this chunk for its bucket
        # entry to have been captured from here
        next_first = torch.cat(
            [first_key[:, 1:], torch.full((W, 1), _SENTINEL, dtype=keys.dtype, device=dev)],
            dim=1,
        )
        ends_here = first_key != next_first
        in_range = (first_key >= lo) & (first_key - lo < B)
        fix = (valid & ends_here & in_range).reshape(-1)
        tgt = (win_ids * B + first_key - lo).reshape(-1)[fix]  # distinct buckets
        cur = gather_rows_t(bucket_rows, tgt).view(3, L, -1)
        carry_flat = carry_pt.movedim(0, -2).reshape(3, L, W * C)[..., fix]
        bucket_rows[tgt] = g1.add(cur, carry_flat).reshape(R, -1).T

    return bucket_rows.T.reshape(3, L, W, B).contiguous()


def _tree_reduce_last(g1: G1Ctx, x: Tensor, n: int) -> Tensor:
    """Point tree-reduction over the trailing n lanes of (3, L, W*n)."""
    L = x.shape[1]
    W = x.shape[-1] // n
    while n > 1:
        half = n // 2
        x4 = x.reshape(3, L, W, n)
        x = g1.add(
            x4[..., :half].reshape(3, L, W * half),
            x4[..., half : 2 * half].reshape(3, L, W * half),
        )
        n = half
    return x  # (3, L, W)


def _weighted_bucket_sum(g1: G1Ctx, buckets: Tensor, c: int) -> Tensor:
    """sum_{b=1}^{B-1} b * S_b per window: (3, L, W, B) -> (3, L, W).

    For large B, split the bucket index into hi/lo halves first:
      sum_b b*S_b = 2^h * sum_hi hi*R_hi + sum_lo lo*C_lo
    with R/C the row/column sums of the (hi, lo) bucket grid.
    """
    if c > 8:
        L = buckets.shape[1]
        W = buckets.shape[-2]
        h = c // 2
        H, Lo = 1 << h, 1 << (c - h)
        grid = buckets.reshape(3, L, W, H, Lo)
        rows = _tree_reduce_last(g1, grid.reshape(3, L, W * H * Lo), Lo)
        rows = rows.reshape(3, L, W, H)  # R_hi
        cols = _tree_reduce_last(
            g1, grid.movedim(-1, -2).reshape(3, L, W * Lo * H), H
        ).reshape(3, L, W, Lo)  # C_lo
        hi_sum = _weighted_bucket_sum(g1, rows, h)
        lo_sum = _weighted_bucket_sum(g1, cols, c - h)
        for _ in range(c - h):
            hi_sum = g1.double(hi_sum)
        return g1.add(hi_sum, lo_sum)
    return _weighted_bucket_sum_bits(g1, buckets, c)


def _weighted_bucket_sum_bits(g1: G1Ctx, buckets: Tensor, c: int) -> Tensor:
    """Bit decomposition: sum_b b*S_b = sum_k 2^k * (sum_{b: bit k} S_b).

    Each inner sum is a masked lane tree-reduction; the outer combination is
    a short Horner over bits."""
    L = buckets.shape[1]
    W, B = buckets.shape[-2], buckets.shape[-1]
    flat = buckets.reshape(3, L, W * B)
    inf = g1.inf.expand(3, L, W * B)
    bidx = torch.arange(B, device=buckets.device)

    bit_sums = []
    for k in range(c):
        mask = ((bidx >> k) & 1) == 1  # (B,)
        masked = g1.select(mask.expand(W, B).reshape(-1), flat, inf)
        bit_sums.append(_tree_reduce_last(g1, masked, B))  # (3, L, W)

    # Horner over bits, high to low: acc = 2*acc + T_k
    acc = bit_sums[-1]
    for k in range(c - 2, -1, -1):
        acc = g1.add(g1.double(acc), bit_sums[k])
    return acc


def n_windows(g1: G1Ctx, c: int, signed: bool = False, nbits: Optional[int] = None) -> int:
    """Static window count of the bucket table (with the signed-carry window
    when the scalars can fill the top window, e.g. GLV's 128-bit halves)."""
    nbits = nbits or g1.nbits
    nwin = -(-nbits // c)
    if signed and nbits >= c * nwin:
        nwin += 1
    return nwin


def _check_ported(c: int, capture: str) -> None:
    """Raise for what only the reference has (see ROADMAP)."""
    if LIMB_BITS % c:
        raise ValueError(f"window bits c={c} must divide {LIMB_BITS}")
    if capture not in ("auto", "dense"):
        raise NotImplementedError(f"capture={capture!r}: only dense capture is ported")


def _capture_limit(capture: str, limit: Optional[int] = None) -> Optional[int]:
    """Bytes of dense-capture buffer at which the points are split in half:
    ``limit`` or the default for ``"auto"``, never (None) for ``"dense"``."""
    if capture == "dense":
        return None
    return _DENSE_CAPTURE_LIMIT if limit is None else limit


def _split_table(
    g1: G1Ctx, points: Tensor, scalars: Tensor, c: int, K: int, limit: Optional[int], nbits: int,
    signed: bool,
) -> Tensor:
    """``bucket_table``'s body.  While the dense-capture buffer would reach
    ``limit`` bytes (None: never), split the points in half -- bucket tables
    are pointwise-addable -- and recurse with half the default budget."""
    nwin = -(-nbits // c)
    N = points.shape[-1]
    NP = N + ((-N) % K)  # _bucket_table pads to a K multiple
    nwin_eff = n_windows(g1, c, signed, nbits)
    if limit is not None and N % 2 == 0 and NP * nwin_eff * 3 * g1.fp.L * 4 >= limit:
        h, half = N // 2, _DENSE_CAPTURE_LIMIT // 2
        t0 = _split_table(g1, points[..., :h], scalars[..., :h], c, K, half, nbits, signed)
        t1 = _split_table(g1, points[..., h:], scalars[..., h:], c, K, half, nbits, signed)
        L, W, B = t0.shape[1], t0.shape[-2], t0.shape[-1]
        return g1.add(t0.reshape(3, L, W * B), t1.reshape(3, L, W * B)).reshape(3, L, W, B)
    if signed:
        absd, neg = _signed_digits(scalars, c, nwin, nbits=nbits)
        return _bucket_table(g1, points, absd, c, K=K, neg=neg)
    return _bucket_table(g1, points, _digits(scalars, c, nwin), c, K=K)


def bucket_table(
    g1: G1Ctx,
    points: Tensor,
    scalars: Tensor,
    c: int,
    signed: bool = False,
    K: int = 64,
    capture: str = "auto",
    _limit: Optional[int] = None,
    nbits: Optional[int] = None,
) -> Tensor:
    """Stage 1 of Pippenger: per-window bucket sums, (3, L, nwin, 2^c)
    unsigned (bucket = digit) or (3, L, nwin, 2^(c-1)) signed (bucket b =
    magnitude b+1).  Points are projective (3, L, N) or affine (2, L, N)
    (mixed-add scan; the caller zeroes the scalars of infinity inputs).

    ``capture="auto"`` splits the points while the capture buffer would
    reach ``_limit`` bytes (default ``_DENSE_CAPTURE_LIMIT``); ``"dense"``
    never splits."""
    _check_ported(c, capture)
    limit = _capture_limit(capture, _limit)
    return _split_table(g1, points, scalars, c, K, limit, nbits or g1.nbits, signed)


def window_totals(g1: G1Ctx, buckets: Tensor, c: int, signed: bool = False) -> Tensor:
    """Stage 2: weighted bucket sums per window, (3, L, nwin).

    Unsigned: sum_b b * S_b over B = 2^c.  Signed: bucket b holds the
    magnitude-(b+1) sum, so the total is (sum_b b S_b) + (sum_b S_b): the
    weighted sum over half the buckets plus one plain tree reduction."""
    if not signed:
        return _weighted_bucket_sum(g1, buckets, c)
    L = buckets.shape[1]
    W, B = buckets.shape[-2], buckets.shape[-1]
    if B != 1 << (c - 1):
        raise ValueError(f"a signed table has 2^(c-1) = {1 << (c - 1)} buckets, got {B}")
    weighted = _weighted_bucket_sum(g1, buckets, c - 1)
    plain = _tree_reduce_last(g1, buckets.reshape(3, L, W * B), B)
    return g1.add(weighted, plain)


# ---------------------------------------------------------------------------
# GLV: k = k2 * lam + k1 by exact device divmod (BLS12: lam = x^2 - 1, so the
# plain quotient/remainder split is balanced at ~sqrt(r) with NO signs)
# ---------------------------------------------------------------------------


def _limb_col(x: int, n: int) -> np.ndarray:
    """x as an (n, 1) column of 16-bit limbs."""
    return np.array([(x >> (LIMB_BITS * k)) & 0xFFFF for k in range(n)], dtype=np.uint32)[:, None]


class GlvCtx:
    """Device GLV split for BLS12 G1 (endomorphism phi(P) = (beta x, y)).

    With lam = x^2 - 1 and r = x^4 - x^2 + 1, k = k2*lam + k1 gives
    0 <= k1 < lam < 2^128 and 0 <= k2 <= x^2 < 2^128: balanced halves
    without lattice rounding or signs.  The split is exact integer Barrett
    on the limb convolution of ``ops/field.py``; beta is the cube root of
    unity with [lam]G = (beta gx, gy) on the host engine."""

    def __init__(self, g1: G1Ctx):
        from ..curves.params import Family
        from ..host import get_engine

        spec = g1.spec
        if spec.family != Family.BLS12:
            raise ValueError("device GLV split: BLS12 curves only")
        lam = (spec.x * spec.x - 1) % spec.r
        if (lam * lam + lam + 1) % spec.r:
            raise ValueError("lam is not a cube root of unity mod r")
        gx, gy = spec.g1_gen
        want = get_engine(spec).g1.mul(spec.g1_gen, lam)
        p = spec.p
        beta = next((b for b in self._cube_roots(p) if (gx * b % p, gy) == want), None)
        if beta is None:
            raise ValueError("no beta matches the lam eigenvalue")
        self.lam, self.beta = lam, beta
        self.g1 = g1
        self.nbits = 128
        self.SL = self.nbits // LIMB_BITS  # 8 sub-scalar limbs
        S = g1.fr.L
        # Barrett: mu = floor(2^(16*S) / lam) (k < 2^(16*S) gives q_hat in
        # {q-2, q-1, q}); the quotient q <= x^2 < 2^128
        self.shift_limbs = S
        mu = (1 << (LIMB_BITS * S)) // lam
        self.mu = _limb_col(mu, -(-mu.bit_length() // LIMB_BITS))
        self.lam_limbs = _limb_col(lam, self.SL)
        self.beta_mont = g1.fp.encode(beta)  # (L, 1) on the context's device
        dev = g1.device
        self._mu = torch.from_numpy(self.mu.astype(np.int64)).to(dev)
        self._lam = torch.from_numpy(self.lam_limbs.astype(np.int64)).to(dev)

    @staticmethod
    def _cube_roots(m: int) -> list:
        """The roots of z^2 + z + 1 mod m: (-1 +- sqrt(-3)) / 2."""
        from ..curves.params import _fp_sqrt

        s = _fp_sqrt(m - 3, m)  # Tonelli-Shanks where m = 1 mod 4 (BLS12-377)
        if s is None:
            return []
        inv2 = pow(2, -1, m)
        return [((-1 + s) * inv2) % m, ((-1 - s) * inv2) % m]

    @staticmethod
    def _sub_limbs(a: Tensor, b: Tensor, n: int) -> Tensor:
        """a - b on (n, N) canonical int64 16-bit limbs, a >= b."""
        out, borrow = [], torch.zeros_like(a[0])
        for k in range(n):
            v = a[k] + 0x10000 - (b[k] if k < b.shape[0] else 0) - borrow
            out.append(v & 0xFFFF)
            borrow = 1 - (v >> 16)
        return torch.stack(out)

    @staticmethod
    def _geq(a: Tensor, b: Tensor, n: int) -> Tensor:
        """a >= b (b an (m, 1) limb column), lexicographic from the top."""
        ge = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
        decided = torch.zeros_like(ge)
        for k in range(n - 1, -1, -1):
            bv = b[k] if k < b.shape[0] else torch.zeros_like(b[0])
            ne = a[k] != bv
            ge = torch.where(~decided & ne, a[k] > bv, ge)
            decided = decided | ne
        return ge

    def split(self, scalars: Tensor):
        """(S, N) canonical limbs of k in [0, r) -> (k1, k2) int32, each
        (SL, N), with k = k2*lam + k1 exactly and both < 2^128."""
        S = self.g1.fr.L
        k = scalars.to(torch.int64)
        # q_hat = floor(k * mu / 2^(16*S)), at most 2 below the true q
        prod = _normalize(_pad_top(_conv(k, self._mu)))
        q = prod[self.shift_limbs : self.shift_limbs + self.SL]
        # rem = k - q*lam (non-negative, fits S limbs)
        ql = _conv(q, self._lam)
        ql = _normalize(_pad_top(ql, max(1, S - ql.shape[0])))[:S]
        rem = self._sub_limbs(k, ql, S)
        # at most two corrections: rem >= lam -> rem -= lam, q += 1
        for _ in range(2):
            fix = self._geq(rem, self._lam, S)
            rem = torch.where(fix[None, :], self._sub_limbs(rem, self._lam, S), rem)
            carry = fix.to(torch.int64)
            qf = []
            for j in range(self.SL):
                v = q[j] + carry
                qf.append(v & 0xFFFF)
                carry = v >> 16
            q = torch.stack(qf)
        return rem[: self.SL].to(torch.int32), q.to(torch.int32)

    def endo_points(self, points: Tensor) -> Tensor:
        """phi(P): X scaled by beta (the ``mont_mul`` kernel on a card) --
        exact on affine (beta x, y) and projective (beta X : Y : Z) alike."""
        X = self.g1.fp.mont_mul(points[..., 0, :, :], self.beta_mont)
        return torch.cat([X[..., None, :, :], points[..., 1:, :, :]], dim=-3)


_GLV_CACHE: dict = {}


def get_glv_ctx(g1: G1Ctx) -> GlvCtx:
    key = (g1.spec.name, g1.device)
    ctx = _GLV_CACHE.get(key)
    if ctx is None:
        ctx = _GLV_CACHE[key] = GlvCtx(g1)
    return ctx


def _glv_table(g1: G1Ctx, points: Tensor, scalars: Tensor, c: int, signed: bool, K: int,
               capture: str) -> Tensor:
    """The bucket table of the GLV split: 2N points (P, phi(P)) with the
    128-bit halves (k1, k2).  Infinity projective inputs get zero scalars, so
    both halves vanish."""
    gl = get_glv_ctx(g1)
    if points.shape[-3] == 3:
        scalars = torch.where(g1.is_inf(points)[None, :], 0, scalars)
    k1, k2 = gl.split(scalars)
    pts2 = torch.cat([points, gl.endo_points(points)], dim=-1)
    return bucket_table(g1, pts2, torch.cat([k1, k2], dim=-1), c, signed=signed, K=K,
                        capture=capture, nbits=gl.nbits)


def horner_windows(g1: G1Ctx, totals: Tensor, c: int) -> Tensor:
    """Stage 3 on the device: Horner over windows -> one (3, L, 1) point."""
    nwin = totals.shape[-1]
    acc = totals[..., nwin - 1 :]
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = g1.double(acc)
        acc = g1.add(acc, totals[..., w : w + 1])
    return acc


def msm(
    g1: G1Ctx,
    points: Tensor,
    scalars: Tensor,
    c: int = 8,
    signed: bool = False,
    K: int = 64,
    capture: str = "auto",
    glv: bool = False,
) -> Tensor:
    """Pippenger MSM: sum_i [scalars_i] points_i.

    points: (3, L, N) projective or (2, L, N) affine; scalars: (S, N) plain
    16-bit limbs.  ``c`` must divide 16.  Returns a single (3, L, 1) point."""
    totals = msm_totals(g1, points, scalars, c=c, signed=signed, K=K, capture=capture, glv=glv)
    return horner_windows(g1, totals, c)


def msm_totals(
    g1: G1Ctx,
    points: Tensor,
    scalars: Tensor,
    c: int = 8,
    signed: bool = False,
    K: int = 64,
    capture: str = "auto",
    glv: bool = False,
) -> Tensor:
    """The device part of the host-Horner MSM split: per-window totals
    (3, L, nwin).  Finish with ``horner_host``.  ``glv`` (BLS12 curves)
    halves the windows for twice the points."""
    _check_ported(c, capture)
    if glv:
        buckets = _glv_table(g1, points, scalars, c, signed, K, capture)
    else:
        buckets = bucket_table(g1, points, scalars, c, signed=signed, K=K, capture=capture)
    return window_totals(g1, buckets, c, signed=signed)


def horner_host(g1: G1Ctx, totals, c: int) -> Optional[tuple]:
    """Host-side Horner over fetched window totals: (3, L, W) projective
    -> affine host point (None = infinity), on the C++ host engine."""
    from ..host import get_engine

    eng = get_engine(g1.spec)
    pts = g1.decode_points(totals)  # W affine host points, high window last
    acc = None
    for P in reversed(pts):  # windows stored low-to-high; Horner high->low
        if acc is not None:
            acc = eng.g1.mul(acc, 1 << c)
        if acc is None:
            acc = P
        elif P is not None:
            acc = eng.g1.add(acc, P)
    return acc


def msm_naive(g1: G1Ctx, points: Tensor, scalars: Tensor) -> Tensor:
    """Oracle: batched scalar-mul then tree reduction."""
    return g1.sum_reduce(g1.scalar_mul(points, scalars))


def auto_window(n: int, nbits: int = 255) -> int:
    """Window size c in {4, 8, 16} minimising bucket-phase work
    ~n*ceil(nbits/c) plus tail ~2*(nbits/c)*2^c point adds."""
    best, best_cost = 4, float("inf")
    for c in (4, 8, 16):
        w = -(-nbits // c)
        cost = n * w + 2 * w * (1 << c)
        if cost < best_cost:
            best, best_cost = c, cost
    return best


def auto_glv(spec, n: int) -> bool:
    """The reference's GLV rule: on for BLS12 curves up to 2^17 points (its
    measured crossover, where the O(W 2^c) tail stops dominating)."""
    from ..curves.params import Family

    return spec.family == Family.BLS12 and n <= (1 << 17)


def msm_host_bridge(spec, points, scalars, device=None):
    """Host-level MSM: list of affine points (None = infinity) + int scalars
    -> affine point (None = infinity), on the card unless ``device="cpu"``.

    Pads n up to a power of two >= 64 with infinity, zeroes the scalars of
    every infinity entry ([k]inf = inf), encodes the points affine (the
    mixed-add scan), and runs ``msm`` with ``auto_window`` and ``auto_glv``
    of the padded size.  Backs the API's ``MultiScalarMul`` for n >= 64."""
    g1 = get_g1_ctx(spec, device)
    n = len(points)
    if len(scalars) != n:
        raise ValueError("points and scalars differ in length")
    n_pad = 1 << max(6, (n - 1).bit_length())
    pts = list(points) + [None] * (n_pad - n)
    scs = [0 if P is None else int(k) for P, k in zip(pts, list(scalars) + [0] * (n_pad - n))]
    c = auto_window(n_pad, g1.nbits)
    out = msm(g1, g1.encode_points_affine(pts), g1.encode_scalars(scs), c=c,
              glv=auto_glv(spec, n_pad))
    return g1.decode_point(out)
