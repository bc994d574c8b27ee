"""Multi-scalar multiplication (Pippenger), port of ``mathlib_tpu/ops/msm.py``.

The staging is the reference's:

  1. windowed digits of all scalars (``_digits``),
  2. per window: a stable sort of the point indices by digit,
  3. a streaming scan over K chunk steps: each step gathers one sorted slice
     of point rows for ALL windows and advances the segmented running sums
     with the ``add_select`` kernel; every step's running sums are captured
     densely (``capture="dense"``),
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

Only the main path's options are ported: unsigned digits, dense capture and
projective points.  Signed digits, GLV, ``capture="scatter"`` and affine
``(2, L, N)`` points raise ``NotImplementedError`` (see ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch

from .field import LIMB_BITS
from .g1 import G1Ctx

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


def _bucket_table(g1: G1Ctx, points: Tensor, digits: Tensor, c: int, K: int = 64) -> Tensor:
    """Bucket sums for all windows: (3, L, W, B), B = 2^c, bucket = digit
    (bucket 0 is computed but unused downstream).

    points: (3, L, N) projective; digits: (W, N).  Dense capture: the scan
    emits every step's running sums into a capture buffer; segment-end
    positions come from the sorted keys alone, so the bucket table is ONE
    row gather from that buffer after the scan.
    """
    W, N = digits.shape
    L = points.shape[-2]
    B = 1 << c
    R = 3 * L  # words per point row
    dev = points.device

    order = torch.argsort(digits, dim=1, stable=True)  # (W, N)
    keys = torch.gather(digits, 1, order)

    pad = (-N) % K
    NP = N + pad
    if pad:
        keys = torch.cat(
            [keys, torch.full((W, pad), _SENTINEL, dtype=keys.dtype, device=dev)], dim=1
        )
        # gathered points for sentinel keys are never used
        order = torch.cat([order, torch.zeros((W, pad), dtype=order.dtype, device=dev)], dim=1)
    C = NP // K
    win_ids = torch.arange(W, device=dev)[:, None]

    def bucket_of(k):  # digit -> flat bucket index (W*B = out of range)
        return torch.where((k >= 0) & (k < B), win_ids * B + k, W * B)

    # last element of each segment (flat sorted order)
    is_last = torch.cat(
        [keys[:, :-1] != keys[:, 1:], torch.ones((W, 1), dtype=torch.bool, device=dev)],
        dim=1,
    )

    def to_steps(x):  # (W, NP) -> (K, W*C), step-major
        return x.reshape(W, C, K).movedim(-1, 0).reshape(K, W * C)

    keys_t = to_steps(keys)
    order_t = to_steps(order)

    # point-major copy for the streaming gather: one row = one point
    points_rows = points.reshape(R, N).T.contiguous()  # (N, R)
    inf_row = g1.inf.reshape(R)

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
        gathered = points_rows[order_t[s]].T.reshape(3, L, W * C)
        ys[s] = g1.add_select(run, gathered, keys_t[s] == ck)
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
        in_range = (first_key >= 0) & (first_key < B)
        fix = (valid & ends_here & in_range).reshape(-1)
        tgt = (win_ids * B + first_key).reshape(-1)[fix]  # distinct buckets
        cur = bucket_rows[tgt].T.reshape(3, L, -1)
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


def n_windows(g1: G1Ctx, c: int, nbits: Optional[int] = None) -> int:
    """Static window count of the (unsigned) bucket table."""
    return -(-(nbits or g1.nbits) // c)


def _check_ported(c: int, points: Tensor, signed: bool, glv: bool, capture: str) -> None:
    """Raise for the options only the reference has (see ROADMAP)."""
    if LIMB_BITS % c:
        raise ValueError(f"window bits c={c} must divide {LIMB_BITS}")
    if capture not in ("auto", "dense"):
        raise NotImplementedError(f"capture={capture!r}: only dense capture is ported")
    if signed:
        raise NotImplementedError("signed digits are not ported yet (ROADMAP)")
    if glv:
        raise NotImplementedError("the GLV split is not ported yet (ROADMAP)")
    if points.shape[-3] != 3:
        raise NotImplementedError("affine (2, L, N) points are not ported yet (ROADMAP)")


def _capture_limit(capture: str, limit: Optional[int] = None) -> Optional[int]:
    """Bytes of dense-capture buffer at which the points are split in half:
    ``limit`` or the default for ``"auto"``, never (None) for ``"dense"``."""
    if capture == "dense":
        return None
    return _DENSE_CAPTURE_LIMIT if limit is None else limit


def _split_table(
    g1: G1Ctx, points: Tensor, scalars: Tensor, c: int, K: int, limit: Optional[int], nbits: int
) -> Tensor:
    """``bucket_table``'s body.  While the dense-capture buffer would reach
    ``limit`` bytes (None: never), split the points in half -- bucket tables
    are pointwise-addable -- and recurse with half the default budget."""
    nwin = n_windows(g1, c, nbits)
    N = points.shape[-1]
    NP = N + ((-N) % K)  # _bucket_table pads to a K multiple
    if limit is not None and N % 2 == 0 and NP * nwin * 3 * g1.fp.L * 4 >= limit:
        h, half = N // 2, _DENSE_CAPTURE_LIMIT // 2
        t0 = _split_table(g1, points[..., :h], scalars[..., :h], c, K, half, nbits)
        t1 = _split_table(g1, points[..., h:], scalars[..., h:], c, K, half, nbits)
        L, W, B = t0.shape[1], t0.shape[-2], t0.shape[-1]
        return g1.add(t0.reshape(3, L, W * B), t1.reshape(3, L, W * B)).reshape(3, L, W, B)
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
    """Stage 1 of Pippenger: per-window bucket sums, (3, L, nwin, 2^c).

    ``capture="auto"`` splits the points while the capture buffer would
    reach ``_limit`` bytes (default ``_DENSE_CAPTURE_LIMIT``); ``"dense"``
    never splits."""
    _check_ported(c, points, signed, False, capture)
    limit = _capture_limit(capture, _limit)
    return _split_table(g1, points, scalars, c, K, limit, nbits or g1.nbits)


def window_totals(g1: G1Ctx, buckets: Tensor, c: int, signed: bool = False) -> Tensor:
    """Stage 2: weighted bucket sums per window, (3, L, nwin)."""
    if signed:
        raise NotImplementedError("signed digits are not ported yet (ROADMAP)")
    return _weighted_bucket_sum(g1, buckets, c)


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

    points: (3, L, N) projective; scalars: (S, N) plain 16-bit limbs.
    ``c`` must divide 16.  Returns a single (3, L, 1) point."""
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
    (3, L, nwin).  Finish with ``horner_host``."""
    _check_ported(c, points, signed, glv, capture)
    buckets = _split_table(g1, points, scalars, c, K, _capture_limit(capture), g1.nbits)
    return _weighted_bucket_sum(g1, buckets, c)


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
