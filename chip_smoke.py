"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path -- the BLS12-381 G1 multi-scalar multiplication
at 2^20 points (c=16 window bits, K=64 scan steps, unsigned digits, dense
capture, host Horner), as ``bench.py`` times it for the JAX package -- through
``mathlib_tpu_torch`` alone, in phases:

  1. device: needs a CUDA card (exit 1 otherwise); prints its name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compiles the CUDA kernels from ``mathlib_tpu_torch/csrc`` with
     nvcc, one process a source, all at once (ptxas register and spill
     report in the build log; each source's nvcc seconds, and the slowest,
     which sets the build's wall, on the ``[build]`` line);
  3. each kernel (add, double, addsel, smul) against its plain PyTorch
     version on the card, bit for bit (tolerance: exact), and each one's
     time beside the plain version's at the main path's shapes; double (one
     doubling over four warps) on 1, 16, 33 and 4,097 lanes (infinity and
     P = -P lanes among them), timed at the MSM's 16 lanes, at Horner's one
     and at 2^20, device and host time a launch; add and addsel (one add
     over six warps) also at addsel's 4,096-lane shape; smul (the ladder
     over six warps) also at 4,096, 2,048 and 1,024 lanes, each against the
     plain version's first lanes; the split kernels of
     ``g1_split_kernels.cu`` (add, addsel, double, phase 10's signed and
     mixed combiners and dbladd, and the ladder) with their ptxas registers,
     stack and spills (none allowed, at most 128 registers), and mont_mul's
     lines;
  4. the n=512 gates of ``bench.py``: msm_totals + horner_host and the split
     path must equal the port's msm_naive and the host engine's MSM;
  5. the main path at 2^20 points: 8,192 base points by the port's
     scalar_mul (checked against the host engine), tiled to 2^20, scalars
     from ``np.random.default_rng(0)`` reduced mod r; one warm-up and 3
     timed runs; the result must equal a host MSM of the scalars folded per
     base point; every kernel must have launched during this phase (the
     scan's row gather is the gather_rows_t kernel); one more msm_totals
     timed by CUDA events beside PERF.md's device time.

The second main path, the pairing-product check a BLS verifier pays for
(``BatchEngine.pairing_product_is_one`` / ``pairing_products_are_one``):

  6. the split Miller and tree kernels' ptxas lines (no stack and no spill
     allowed); the pairing kernels (mont_mul, miller_lanes, f12_seg_product)
     against their plain PyTorch versions on the card, exact: miller_lanes
     on 64 lanes with n = 61 (3 pad lanes) on BLS12-381, BN254 and
     BLS12-377, the product tree (several levels a launch) on those lanes
     tiled to 1, 2, 64 and 4,096 with seg 2, 64 and the whole batch; then
     each at the shapes of phase 7 (BLS12-381, 4,096 and 2,048 lanes;
     miller_lanes at both, each in the block size the launcher picks there),
     checked against the plain version and timed beside it with its
     launches a call, and the tree's time of one level, of a 4-level launch
     and its depth floor; mont_mul's two bodies, each forced, from 1,024
     to 2^21 elements (to_affine_rows' (2, 24, 2^20) on the 2^20 MSM);
  7. the product check at full width on BLS12-381 through ``BatchEngine``
     on the card: (a) 4,096 pairs (a_i g1, b_i g2) beside (-a_i b_i g1, g2)
     must check True and their twin with one scalar changed False; (b) 1,024
     two-pair BLS verifies e(sig, g2) e(-H, pk), a known half corrupted, must
     give the known verdicts; (c) 8 per-lane Miller values, reduced on the
     host, must equal the host engine's pairings.  One warm-up and 3 timed
     runs of (a) and (b); every pairing kernel must have launched.

The third main path, the pairings themselves (``BatchEngine.pairing_batch``),
and the device final exponentiation of the reference's opt-in strategies:

  8. the split final-exp and add_step kernels' ptxas lines (no stack and
     no spill allowed; add_step at most 64 registers); the kernels of
     pairing_batch (miller_ft, add_step, final_exp; and f12_pow and fp_pow,
     which BN254's final exp ran before it became one final_exp launch;
     fp_pow is timed in phase 11, f12_pow in phase 17, on their paths)
     against their plain PyTorch versions on the card, exact, on 64 lanes of
     BLS12-381, BN254 and BLS12-377 with full chains (final_exp over x on
     every curve and BN254's whole final exp; f12_pow over |x| on BLS12
     curves and over the first hard-part digit on BN254, with and without
     cyclotomic squaring, on a unitary base); then each at phase 9's shapes
     (BLS12-381 at 4,096 lanes: miller_ft, final_exp; BN254 at 1,024:
     add_step, the whole final exp), checked against the plain version and
     timed beside it; and
     final_exp at the strategies' 1,024 and 1 lanes (other blocks), against
     the plain version's first lanes;
  9. pairing_batch at full width: 4,096 BLS12-381 pairs (a g1, b g2), the
     last 16 of them 8 bilinearity pairs (a g1, g2) beside (g1, a g2), and
     1,024 BN254 pairs; 8 sampled lanes of each must equal the host engine's
     pairing and the bilinearity pairs must agree; one warm-up and 3 timed
     calls each (pairings/s), exactly one final_exp launch a call and, on
     BN254, no fp_pow or f12_pow, then one call split into stages.  Then
     ``MATHLIB_PAIR_FUSED=split`` on phase 7's 4,096-pair check and its
     twin, and ``MATHLIB_GROUP_FEXP=device`` on phase 7's 1,024 two-pair
     checks: the verdicts must equal the defaults', timed beside them.  The
     launch counts are set to 0 just before each curve's pairing_batch runs
     and read just after: every kernel that curve's path runs must have
     launched there.  The strategies' launches are counted apart.

The G1 MSM options behind the API's bridge and ``BatchEngine.g1_msm``:

 10. the four kernels of the options (dbladd, addselneg, maddsel,
     maddselneg) against their plain PyTorch versions on the card, bit for
     bit: first on phase 3's 4,097 lanes and edge lanes (P = inf,
     P = lift(Q), P = -lift(Q), sel and neg mixed, a 32-lane block that adds
     nowhere and one that adds everywhere, neg mixed in both, a partial
     last block) on BLS12-381 and BN254, dbladd also with P = inf, Q = inf,
     Q = 2P and Q = -2P lanes; then at the path's shapes (the three
     combiners, each one add or mixed add over six warps, at the 262,144
     lanes of one 2^20, c=16 scan step, dbladd, one bit of the six-warp
     ladder, at 2^20 lanes and at the 8,192 lanes of the ladder below),
     each timed beside its plain version with its bound; their ptxas
     registers, stack and spills (none allowed, at most 128 registers:
     checked in phase 3); and a 64-bit ladder through
     ``G1Ctx.dbl_add_select`` (its launches are dbladd's count) against
     ``scalar_mul``;
 11. the entry points at full size, one warm-up and 3 timed calls each
     (points/s, peak memory), each against a host MSM of the scalars folded
     per base point (8,192 distinct base points, tiled): (a)
     ``msm_host_bridge`` on 60,000 BLS12-381 points with some None (padded
     to 2^16; GLV, c=8, the mixed-add scan), (b) ``msm_host_bridge`` on 2^14
     BN254 points (c=8, 8-word maddsel), (c) ``BatchEngine.g1_msm`` on 2^16
     BLS12-381 projective points (GLV, c=8), (d) ``g1_scalar_mul`` on 8,192
     lanes against the host engine's ``mul``, then fp_pow on the values
     its batch inversion gives it there (BLS12-381, (24, 2,048)) against
     its plain version, each body (the grouped one and one element a
     thread) forced in turn and the wrapper's own pick, timed beside it
     with its bound, (e) phase 5's 2^20 MSM again
     with affine points, with signed digits, and with both, each equal to
     phase 5's result and timed beside it.  The counts are set to 0 just
     before each entry point and read just after: every kernel of its path
     must have launched.

Hash-to-G1 and ``BatchEngine``'s BLS sign and verify:

 12. the two kernels of the hash path against their plain PyTorch versions
     on the card, bit for bit: ``hash_g1`` on 1,001 lanes (a partial
     16-lane block) and 1,024 lanes under both signs (the first lanes u = 0,
     1, p - 1 and a pair with t2 = 0; eight edge lanes also against the host
     map), then timed at 4,096 lanes with its bound; ``smul_static`` on
     4,097 lanes (infinity among them) with h_eff's bits and a 255-bit
     static scalar, then timed at 4,096 lanes; their ptxas lines (hash_g1:
     no stack, no spill and at most 128 registers allowed; the static
     ladder is held to phase 3's budget there);
 13. the entry points at full width on BLS12-381, 4,096 messages, DST
     ``BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_``: ``hash_to_g1_batch``
     on (a) 32-byte messages (the word path), (b) 30-byte messages (the
     block path), (c) ``b"msg-%d"`` of mixed lengths (the host
     hash_to_field path); (d) ``hash_to_g1_bbs_batch``; (e)
     ``bls_sign_batch``; (f) ``bls_verify_batch``, True on (e)'s
     signatures and False with one signature replaced or one message
     changed; (g) BN254 ``bls_sign_batch`` and ``bls_verify_batch`` at
     1,024 messages (the host hasher, outside the device hash's gate); (h)
     the ``sign="none"`` tensor pipeline, whose cofactor ladder is
     ``smul_static``.  64 sampled lanes of each equal the port's host
     hasher (or [sk] of it); each is a warm-up and 3 timed calls, the
     launch counts set to 0 just before and read just after; a
     ``hash_stages`` line splits one (a) call into host pack, XMD on the
     device, the kernel and host decode.

G2's group law, ``BatchEngine.g2_scalar_mul`` and hash-to-G2 (BLS12-381):

 14. the six G2 kernels (g2_add, g2_double, g2_addsel, g2_dblsel, g2_smul,
     g2_smul_static) against their plain PyTorch versions on the card, bit
     for bit: the point kernels on 4,097 lanes with P = Q, P = -Q and
     infinity on either side and a 15/16 selection, g2_addsel and g2_dblsel
     (the add's half with a select, one bit of the G2 ladder) also with a
     block that adds nowhere and one that adds everywhere, in 32-lane
     blocks (4,097 lanes) and the launcher's 16-lane ones (100 lanes),
     g2_dblsel with Q = 2P and Q = -2P lanes; the ladders on 256
     lanes (k = 0, 1, r - 1, lanes 32-63 with k = 0; infinity among them;
     the two cofactor scalars) and on their first 250 (a partial block),
     in the launcher's blocks and in 32-lane blocks, with the ptxas lines
     of the ladders, g2_add, g2_double, g2_addsel and g2_dblsel (at most 96
     registers, no stack, no spill allowed); then each timed at the path's
     4,096 lanes beside its plain version, with its bound; then g2_addsel
     and g2_dblsel on their paths, ``G2Ctx.add_select`` and a 64-bit
     ``G2Ctx.dbl_add_select`` ladder at 4,096 lanes (32-lane blocks) and at
     16 lanes an SM (16-lane blocks), each held to ``G2Ctx.scalar_mul``
     (their launch counts come from there);
 15. the entry points, one warm-up and 3 timed calls each, the launch counts
     set to 0 just before and read just after: ``hash_to_g2_batch`` on 4,096
     messages under ``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_``, (a)
     32-byte (the word path), (b) 30-byte (the block path), (c)
     ``b"msg-%d"`` of mixed lengths (the host path), 64 sampled lanes of
     each against the port's host hasher, with a ``g2_hash_stages`` line
     (XMD, the maps, the cofactor ladders, host decode), then fp_pow on the
     four calls of one more (a) call's first map (the Fp2 inverse at 4,096
     elements, the Fp2 square root's three chains at 8,192, 32,768 and
     8,192) against its
     plain version, each body and the wrapper's pick, timed beside the
     bound; (d)
     ``BatchEngine.g2_scalar_mul`` on 4,096 lanes against the host engine's
     ``mul`` on 64 sampled lanes and the k = 0 and infinity lanes, with a
     ``g2_smul_stages`` line; (e) BN254 ``g2_scalar_mul`` on 1,024 lanes
     (the weier fallback over ``mont_mul``).  Every G2 kernel must have
     launched on its path.

The row gathers and the one-launch pairing check:

 16. (a) gather_rows and gather_rows_t against their plain versions
     (``table[idx]``, ``table[idx].T.contiguous()``), bit for bit, with int64
     and int32 indices, at the scan step's shape (N = 2^20, Wr = 72,
     M = 262,144), a ragged M = 4,097 and the shape of the reference's
     ``tools/profile_stacked.py`` (Wr = 128, M = 2^17), each timed beside
     its plain version and the library call with its bytes bound;
     gather_rows then driven once at the last shape; (b) pairing_check
     against its plain version on 64 lanes with n = 61 (3 pad lanes holding
     points) on BLS12-381 and BLS12-377, a True and a False set, and on 1, 2
     and 257 lanes (n = 256) on BLS12-381: verdicts equal and products bit
     for bit; its ptxas lines (no stack, no spill) and its block at each
     lane count (G x K, and the final exp's 8 x 64); (c) phase 7's 4,096-pair check and its
     twin through ``BatchEngine.pairing_product_is_one`` under
     ``MATHLIB_PAIR_FUSED=check``, verdicts equal the default's and
     ``split``'s, exactly one pairing_check launch a call and no other
     pairing kernel, a warm-up and 3 timed calls beside the default and
     ``split``; the kernel timed at 4,096 lanes beside one run of its plain
     version; (d) ``bls_verify_batch`` on phase 13 (f)'s 4,096 messages
     under ``check``: True, and False with one signature replaced.

The public API (``mathlib_tpu_torch.api``) and its Gt helpers:

 17. (a) ``Curves[CurveID.BLS12_381].MultiScalarMul`` on 2^16 ``G1`` and
     ``Zr`` objects (1,024 distinct points repeated, a zero scalar and an
     infinity point among them; the bridge on the card's kernels), and on
     BN254 and BLS12-377 at 2^14, each equal to the host engine's MSM of the
     scalars folded per distinct point, best of 3 (points/s) with the
     maddsel, gather_rows_t, add and double launches a call; FP256BN_AMCL's
     at n = 64 must raise the G1 kernels' ValueError; (b) the codec on the
     card's curves: the public BLS12-381 generator bytes, and on all 8 IDs
     G1, G2, Gt and Zr round trips (bytes, compressed, JSON) of 64 seeded
     elements and of infinity, and ``Gt.Exp`` of 8 lanes against the
     pure-Python host engine; (c) ``TowerCtx.f12_pow_bits`` on 4,096
     BLS12-381 lanes with a 255-bit shared exponent: exactly one f12_pow
     launch (general squaring) a call, equal word for word to the plain
     version (one run) and on 8 lanes to the host tower's ``f12_pow``,
     timed beside its bound (f12_pow's shape in the ``kernels`` line);
     (d) ``TowerCtx.f12_pow_scalars`` on 64 lanes with per-lane 255-bit
     scalars (tower ops over mont_mul), 8 lanes against the host tower, its
     device ms and launches; (e) ``pairing_products_are_one([], [], 2)``
     under ``MATHLIB_GROUP_FEXP=device`` and a 0-lane ``f12_final_exp``:
     ``[]`` and a 0-lane tensor, no launch.

Inputs come from ``np.random.default_rng(0)`` (phases 1-7),
``np.random.default_rng(1)`` (phases 8-9), ``np.random.default_rng(2)``
(phases 10-11), ``np.random.default_rng(3)`` (phases 12-13) and
``np.random.default_rng(4)`` (phases 14-15), ``np.random.default_rng(5)``
(phase 16) and ``np.random.default_rng(17)`` (phase 17), the points
from the port's C++ host engine (built with g++ at first use).  Prints the card's name and
power limit, one JSON line of per-kernel results (time, plain time, bound,
launches on its main path), then
as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises (exit code != 0) before that line.  Imports no JAX and
nothing of the JAX package.

    python3 chip_smoke.py --profile

adds, after phase 5, one MSM under ``torch.profiler`` (device time by kernel
and by operator, and the device's busy share of the profiled wall time) and
the ``add`` kernel's time at 2^20 lanes on BLS12-381 (12 words) beside BN254
(8 words); and after phase 7, one 4,096-pair check under the profiler.

    python3 chip_smoke.py --time-msm REPO

times phase 5's MSM alone with the ``mathlib_tpu_torch`` of the checkout at
REPO, then that checkout's add and addsel kernels at phase 3's shapes, its
double at 16, 1 and 2^20 lanes, its signed and mixed scan combiners
(addselneg, maddsel, maddselneg) at phase 10's 262,144 lanes, phase 11
(e)'s three 2^20 MSMs (affine, signed, both), ``msm_host_bridge`` on
60,000 BLS12-381 points, its smul at 8,192, 4,096, 2,048 and 1,024 lanes,
its dbladd at 2^20 and 8,192 lanes and smul_static at 4,096 lanes with
h_eff, ``BatchEngine.g1_scalar_mul`` on 8,192 points and mont_mul at (6,
24, 4,096) and (2, 24, 2^20) (each body where the checkout has two); run
for two checkouts in turns to compare them on one card.

    python3 chip_smoke.py --time-pairing REPO

times, with the checkout at REPO, miller_lanes and miller_ft at 4,096 and
2,048 BLS12-381 lanes and 1,024 BN254 lanes, final_exp at 4,096 and 1,024
BLS12-381 lanes, BN254's whole final exp (``TowerCtx.f12_final_exp``) and
add_step at 1,024 lanes, the product tree at 4,096 lanes and 2,048 lanes
with seg 2,
beside their bounds (and prints those kernels' ptxas lines), one 4,096-pair
product check
(pairs/s and device ms), the 1,024 grouped checks under
``MATHLIB_GROUP_FEXP=device``, and ``pairing_batch`` at 4,096 BLS12-381 and
1,024 BN254 pairs.

    python3 chip_smoke.py --time-g2 REPO

times, with the checkout at REPO (built there, each source's nvcc seconds
on its ``[build]`` line), ``g2_add``, ``g2_double``, ``g2_dblsel``
and ``g2_addsel`` at 4,096 lanes and at 16 lanes an SM and one more (the
last count of the launcher's 16-lane blocks and the first of its 32-lane
ones), ``g2_addsel`` with no lane selected at 4,096, ``g2_smul`` at those
counts and at 2,048 and 1,024 lanes, each
cofactor ladder at 4,096 lanes, beside their bounds, with the G2 block
kernels' ptxas lines, and
``BatchEngine.g2_scalar_mul`` on 4,096 points with its ``g2_smul_stages``
line; run for two checkouts in turns.

    python3 chip_smoke.py --time-hash REPO

times, with the checkout at REPO, ``hash_g1`` at 4,096 and 1,024 lanes
beside its bound, fp_pow on ``g1_scalar_mul``'s batch inversion (24, 2,048)
and on the G2 map's four chains (each body where the checkout has two),
beside its bound, mont_mul at (6, 24, 4,096), the three kernels' ptxas
lines, ``hash_to_g1_batch`` (word path) and ``hash_to_g2_batch`` on 4,096
messages with their ``hash_stages`` and ``g2_hash_stages`` lines, and
``BatchEngine.g1_scalar_mul`` on 8,192 points; run for two checkouts in
turns.

    python3 chip_smoke.py --time-batch REPO

times, with the checkout at REPO, ``pairing_batch`` on 4,096 BLS12-381
pairs, whole (best of 3, three rounds) and split into its stages (host
encode, device ms of the Montgomery entry, Miller loop and final exp, host
decode; 5 calls a round).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 1 << 20
N_BASE = 8192
N_GATE = 512
C, K = 16, 64
N_CHECK = 4097  # lanes of the kernel-vs-plain check (a ragged edge)
N_SMUL = 256  # lanes of the smul check
PLAIN_CHUNK = 1 << 16  # lanes per plain-version call when timing big shapes

N_PAIRS = 4096  # phase 7 (a): pairs in one product check
N_CHECKS = 1024  # phase 7 (b): two-pair checks in one grouped call
N_LANES_CHECK, N_VALID_CHECK = 64, 61  # phase 6: lanes, real lanes (3 pad)
# phase 16 (b): pairing_check's further (lanes, real lanes) on BLS12-381: one
# lane, bls_verify_batch's two, and a tree of 16 blocks of 8 with a pad lane
CHECK_LANES = ((1, 1), (2, 2), (257, 256))
TREE_LANES = (1, 2, 64, 4096)  # phase 6: lanes of the product tree against its plain version
PLAIN_PAIR_CHUNK = 1024  # lanes per plain-version call of the pairing kernels

G1_SPLIT_SRC = "mathlib_tpu_torch/csrc/g1_split_kernels.cu"
G2_POINT_SRC = "mathlib_tpu_torch/csrc/g2_point_kernels.cu"
G2_DBLSEL_SRC = "mathlib_tpu_torch/csrc/g2_dblsel_kernels.cu"
G2_SMUL_SRC = "mathlib_tpu_torch/csrc/g2_smul_kernels.cu"
MILLER_SRC = "mathlib_tpu_torch/csrc/miller_split_kernels.cu"
FEXP_SRC = "mathlib_tpu_torch/csrc/fexp_split_kernels.cu"
KERNEL_INFO = {  # name: (source, the TPU kernel it replaces)
    "add": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:174"),
    "double": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:182"),
    "addsel": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:210"),
    "smul": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:476"),
    "dbladd": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:189"),
    "addselneg": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:230"),
    "maddsel": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:263"),
    "maddselneg": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:284"),
    "mont_mul": ("mathlib_tpu_torch/csrc/fp_kernels.cu", "mathlib_tpu/ops/kernels/fp_pallas.py:40"),
    "miller_lanes": (MILLER_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:1188"),
    "f12_seg_product": (FEXP_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:1244"),
    "miller_ft": (MILLER_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:788"),
    "add_step": (MILLER_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:807"),
    "f12_pow": (FEXP_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:828"),
    "final_exp": (FEXP_SRC, "mathlib_tpu/ops/kernels/pairing_pallas.py:914"),
    "fp_pow": ("mathlib_tpu_torch/csrc/fp_kernels.cu",
               "mathlib_tpu/ops/kernels/pairing_pallas.py:1291"),
    "hash_g1": ("mathlib_tpu_torch/csrc/hash_kernels.cu",
                "mathlib_tpu/ops/kernels/hash_pallas.py:258"),
    "smul_static": (G1_SPLIT_SRC, "mathlib_tpu/ops/kernels/g1_pallas.py:509"),
    "g2_add": (G2_POINT_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:201"),
    "g2_double": (G2_POINT_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:206"),
    "g2_addsel": (G2_POINT_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:211"),
    "g2_dblsel": (G2_DBLSEL_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:228"),
    "g2_smul": (G2_SMUL_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:358"),
    "g2_smul_static": (G2_SMUL_SRC, "mathlib_tpu/ops/kernels/g2_pallas.py:393"),
    "gather_rows": ("mathlib_tpu_torch/csrc/gather_kernels.cu",
                    "mathlib_tpu/ops/kernels/gather_pallas.py:68"),
    "gather_rows_t": ("mathlib_tpu_torch/csrc/gather_kernels.cu",
                      "mathlib_tpu/ops/kernels/gather_pallas.py:123"),
    "pairing_check": ("mathlib_tpu_torch/csrc/check_kernels.cu",
                      "mathlib_tpu/ops/kernels/pairing_pallas.py:1065"),
}
# phase 16 (a): (label, table rows N, row words Wr, indices M); the scan step
# of phase 5 (W*C = 262,144 projective rows of 72 words), a ragged M, and the
# shape at which tools/profile_stacked.py times the reference's gathers
GATHER_SHAPES = (("scan", N_MAIN, 72, 1 << 18), ("ragged", N_MAIN, 72, 4097),
                 ("profile_stacked", N_MAIN, 128, 1 << 17))
GATHER_MAIN = {"gather_rows": "profile_stacked", "gather_rows_t": "scan"}  # the JSON line's
N_BATCH = 4096  # phase 9 (a): BLS12-381 pairs of one pairing_batch call
N_BATCH_BN = 1024  # phase 9 (b): BN254 pairs
N_BILIN = 8  # phase 9 (a): bilinearity lanes (a g1, g2) beside (g1, a g2)
N_SAMPLED = 8  # phase 9: lanes checked against the host engine's pairing
N_BRIDGE = 60000  # phase 11 (a): host points of one BLS12-381 bridge call
N_BRIDGE_BN = 1 << 14  # phase 11 (b): BN254 points
N_G1_MSM = 1 << 16  # phase 11 (c): BatchEngine.g1_msm points
N_LADDER_BITS = 64  # phase 10: bits of the dbl_add_select ladder
MAIN_G1 = ("add", "double", "addsel", "smul", "gather_rows_t")  # the kernels of phase 5's path
N_HASH = 4096  # phase 13: messages of one BLS12-381 call; phase 12: timed lanes
N_HASH_CHECK = 1024  # phase 12: lanes of hash_g1 against its plain version
N_HASH_RAGGED = 1001  # phase 12: and on their first 1,001 (a partial block)
N_HASH_BN = 1024  # phase 13 (g): BN254 messages
N_HASH_SAMPLED = 64  # phase 13: lanes of each call held to the host hasher
HASH_DST = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
N_G2 = 4096  # phase 14: timed lanes; phase 15: messages and points of one call
N_G2_BN = 1024  # phase 15 (e): BN254 lanes of g2_scalar_mul
N_G2_SAMPLED = 64  # phase 15: lanes of each call held to the host
N_G2_LADDER_BITS = 64  # phase 14: bits of the G2Ctx.dbl_add_select ladder
G2_RAGGED = 250  # phase 14: a ladder lane count that leaves a partial block
HASH_G2_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
BLS_SK = 0x2B1E5F0D3C7A9B4E6D8F1A3C5E7B9D2F4A6C8E1B3D5F7A9C2E4B6D8F1A3C5E7B
N_API = 1 << 16  # phase 17 (a): G1 and Zr objects of one BLS12-381 MultiScalarMul
N_API_SMALL = 1 << 14  # phase 17 (a): BN254 and BLS12-377
N_API_BASE = 1024  # phase 17 (a): distinct points among them
N_CODEC = 64  # phase 17 (b): seeded elements a curve ID of each round trip
N_GT_EXP = 8  # phase 17 (b): Gt.Exp lanes held to the pure-Python host engine
N_POW = 4096  # phase 17 (c): lanes of TowerCtx.f12_pow_bits
N_POW_SAMPLED = 8  # phase 17 (c), (d): lanes held to the host tower's f12_pow
N_POW_SCALARS = 64  # phase 17 (d): lanes of TowerCtx.f12_pow_scalars
# the public BLS12-381 generator encodings (ZCash / IETF BLS ciphersuite)
G1_GEN_COMPRESSED = bytes.fromhex(
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb"
)
G2_GEN_COMPRESSED = bytes.fromhex(
    "93e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
    "334cf11213945d57e5ac7d055d042b7e024aa2b2f08f0a91260805272dc51051"
    "c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8"
)

# The card's peaks for the bound (NVIDIA H100 SXM data sheet): HBM at
# 3.35 TB/s, and 32-bit integer multiply-adds on 64 INT32 lanes per SM
# (half the 128 float32 lanes behind the sheet's 67 TFLOP/s) at the
# 1.98 GHz boost clock on 132 SMs.  A 32x32->64 product counts as two of
# them (its low and high words), a 32-bit low product as one.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, mads: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the int32 multiply-adds over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, mads / INT32_MADS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def wide_mads(fp_muls: int, L: int) -> int:
    """int32 multiply-adds of fp_muls CIOS Montgomery products at L 16-bit
    limbs (``fp_mul`` in csrc/fp_rows.cuh, NW = L/2 words): per word of b,
    NW 32x32->64 products for a*b[i] and NW for m*p, two multiply-adds
    each, and one low product for m = t[0]*np0: 4 NW^2 + NW."""
    nw = L // 2
    return fp_muls * (4 * nw * nw + nw)


def miller_fp_muls(cfg, lanes: int) -> int:
    """Base-field Montgomery products ``miller_lanes`` runs for ``lanes``
    real lanes (pad lanes run none), counted from the steps it takes."""
    import numpy as np
    from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

    c = mults_per_step(cfg.tower.n, cfg.tower.twist)
    nbits, nadd = len(cfg.bits), int(np.count_nonzero(cfg.bits))
    per = nbits * (c["dbl_step"] + c["f12_sqr"] + c["f12_sparse_mul"])
    per += nadd * (c["add_step"] + c["f12_sparse_mul"])
    if cfg.tail is not None:  # BN: Frobenius of Q (4 Fp2 products), 2 chord steps
        per += 4 * 3 + 2 * (c["add_step"] + c["f12_sparse_mul"])
    return lanes * per


def seg_product_fp_muls(cfg, lanes: int, seg: int) -> int:
    """Base-field Montgomery products of ``f12_seg_product`` on ``lanes``:
    one f12 product per lane that is not the head of its segment."""
    from mathlib_tpu_torch.ops.kernels.tower_rows import mults_per_step

    return (lanes - lanes // seg) * mults_per_step(cfg.tower.n, cfg.tower.twist)["f12_mul"]


def hash_g1_fp_muls(ctx, lanes: int) -> int:
    """Field products of ``hash_g1`` for ``lanes`` lanes, counted from the
    kernel's code: per map 13 (the pre-step, x1, g(x1), x2, g(x2), the
    is-square test, the two signs), the inversion chain and two square-root
    chains (each 14 for the table and 5 a window); per isogeny one a Horner
    step and 4 for X, Y, Z; the add (12); the ladder (8 a double after the
    first bit, 12 an add at each later one-bit)."""
    from mathlib_tpu_torch.ops.kernels.hash_cuda import chain_bits

    def chain(bits):
        return 14 + 5 * ((len(bits) - len(bits) % 4) // 4)

    inv_bits, sqrt_bits = chain_bits(ctx.spec.p)
    per_map = 13 + chain(inv_bits) + 2 * chain(sqrt_bits)
    per_iso = sum(len(cs) - 1 for cs in ctx.iso) + 4
    h = [int(b) for b in ctx.h_bits]
    ladder = 8 * (len(h) - 1) + 12 * (sum(h) - 1)
    return lanes * (2 * (per_map + per_iso) + 12 + ladder)


def ptxas_entries(path: str) -> list:
    """One line per kernel of the build log's ptxas report: its registers
    and its own stack frame and spills."""
    out, name, regs, frame = [], None, None, None
    for ln in list(open(path)) + ["Compiling entry function '' (end)"]:
        if "Compiling entry function" in ln:
            if name:
                out.append(f"{name}: {regs} registers, {frame}")
            m = re.search(r"_ZN3mlt\d+(\w+?)I((?:L[ib]\d+E)+)E", ln)
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m else ""
            name = f"{m.group(1)}<{args}>" if m else ln.split("'")[1]
            regs = frame = None
        elif name and "bytes stack frame" in ln and frame is None:
            frame = ln.split(":", 1)[-1].strip()
        elif name and "Used" in ln and "registers" in ln and regs is None:
            regs = int(ln.split("Used")[1].split()[0])
    return out


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """Mean device milliseconds of fn() over reps runs, after one warm-up,
    and the output of the last run.  A spin of about 50 ms on the stream
    goes first, so the host queues the runs behind it and the events time
    the device's work, not the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def chunked(fn, lanes: int, *args, step: int = PLAIN_CHUNK):
    """fn on step-lane slices of its (..., lanes) arguments, joined."""
    import torch

    return torch.cat(
        [fn(*[a[..., lo : lo + step] for a in args]) for lo in range(0, lanes, step)], dim=-1
    )


def check_equal(results: dict, name: str, got, want):
    """A kernel's output against its plain version's, bit for bit; records
    the largest absolute difference under ``results[name]``."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"kernel {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel {name} disagrees with its plain version ({err=})")
    res = results.setdefault(name, {"max_abs_err": 0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    return got


# the six-warp add kernels' main-path shapes: add on the tail's 2^20 lanes,
# addsel on a scan step's 262,144 and on the chunk-summary scan's 4,096
SPLIT_SHAPES = (("add", N_MAIN), ("addsel", 1 << 18), ("addsel", 4096))


def time_g1_adds(g1_cuda, F, P, Q, sel, design: str) -> None:
    """``add`` and ``addsel`` of the imported checkout (``design``: the
    kernels' name in the log) at SPLIT_SHAPES on contiguous slices of P, Q
    (at least 2^20 lanes) and sel, beside the bound; a ``[time_g1_add]``
    line each."""
    L = F.fp.L
    pt_bytes = 3 * L * 4
    for name, lanes in SPLIT_SHAPES:
        a, b = P[..., :lanes].contiguous(), Q[..., :lanes].contiguous()
        s = sel[:lanes].contiguous()
        if name == "add":
            nbytes, fp_muls = 3 * pt_bytes * lanes, 12 * lanes
        else:
            nbytes, fp_muls = (3 * pt_bytes + 1) * lanes, 12 * int(s.sum())
        bnd = bound(nbytes, wide_mads(fp_muls, L))
        ms, _ = cuda_ms((lambda: g1_cuda.add(F, a, b)) if name == "add"
                        else (lambda: g1_cuda.addsel(F, a, b, s)),
                        reps=5 if lanes > 4096 else 50)
        log("time_g1_add", kernel=name, design=design, lanes=lanes, L=L, ms=f"{ms:.4f}",
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            over_bound=f"{ms / bnd['bound_ms']:.2f}x")


# the signed and mixed combiners' shape: one scan step of the 2^20, c=16 MSM
# (W*C = 16 windows x 16,384 chunks)
COMBINER_LANES = 1 << 18


def time_g1_combiners(g1_cuda, F, P, Q, Qa, sel, neg, design: str) -> None:
    """``addselneg``, ``maddsel`` and ``maddselneg`` of the imported checkout
    (``design``: the kernels' name in the log) at COMBINER_LANES on
    contiguous slices of P, Q, affine Qa and the masks, beside the bound; a
    ``[time_g1_combiner]`` line each."""
    L = F.fp.L
    n = COMBINER_LANES
    a, b, ba = (t[..., :n].contiguous() for t in (P, Q, Qa))
    s, ng = sel[:n].contiguous(), neg[:n].contiguous()
    pt, af, n_sel = 3 * L * 4, 2 * L * 4, int(s.sum())
    runs = {  # name: (call, bytes, field products)
        "addselneg": (lambda: g1_cuda.addselneg(F, a, b, s, ng), (3 * pt + 2) * n, 12 * n_sel),
        "maddsel": (lambda: g1_cuda.maddsel(F, a, ba, s), (2 * pt + af + 1) * n, 11 * n_sel),
        "maddselneg": (lambda: g1_cuda.maddselneg(F, a, ba, s, ng), (2 * pt + af + 2) * n,
                       11 * n_sel),
    }
    for name, (call, nbytes, fp_muls) in runs.items():
        bnd = bound(nbytes, wide_mads(fp_muls, L))
        ms, _ = cuda_ms(call, reps=20)
        log("time_g1_combiner", kernel=name, design=design, lanes=n, L=L, ms=f"{ms:.4f}",
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            over_bound=f"{ms / bnd['bound_ms']:.2f}x")


# the doubling's shapes: one lane a window of the 2^20 MSM (hi_sum and the
# bit Horner of the window sums, 22 launches), one lane (horner_windows, c a
# window), and phase 3's 2^20 lanes
DOUBLE_SHAPES = (16, 1, N_MAIN)


def time_double(g1_cuda, F, P, design: str) -> None:
    """``double`` of the imported checkout at DOUBLE_SHAPES on contiguous
    slices of P (at least 2^20 lanes): device time a launch (CUDA events
    over 200 launches queued behind a spin, 5 at 2^20) and host wall time a
    call (200 calls, one synchronise), beside the bound and, at the small
    shapes, one run of the plain version (phase 3 times it at 2^20); a
    ``[time_double]`` line each."""
    import torch

    L = F.fp.L
    for lanes in DOUBLE_SHAPES:
        a = P[..., :lanes].contiguous()
        reps = 5 if lanes > 4096 else 200
        plain = {}
        if lanes <= 4096:
            plain_ms, _ = cuda_ms(lambda: g1_cuda.double_plain(F, a), reps=1)
            plain = {"plain_us": f"{1e3 * plain_ms:.1f}"}
        ms, _ = cuda_ms(lambda: g1_cuda.double(F, a), reps=reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            g1_cuda.double(F, a)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
        bnd = bound(2 * 3 * L * 4 * lanes, wide_mads(8 * lanes, L))
        log("time_double", design=design, lanes=lanes, L=L, device_us=f"{1e3 * ms:.2f}",
            wall_us=f"{1e3 * wall:.2f}", **plain, bound_us=f"{1e3 * bnd['bound_ms']:.4f}",
            bound_by=bnd["bound_by"], over_bound=f"{ms / bnd['bound_ms']:.1f}x")


def time_dbladd(g1_cuda, F, P, Q, sel, design: str) -> None:
    """``dbladd`` of the imported checkout (``design``: its name in the log)
    at 2^20 lanes and at the 8,192 of phase 10's ladder on contiguous slices
    of P, Q and sel, beside the bound (8 products a lane, 12 more where sel
    is set), each output equal to the plain version's; a ``[time_dbladd]``
    line each."""
    import torch

    L = F.fp.L
    smi = smi_line()
    for lanes in (N_MAIN, N_BASE):
        a, b, s_ = (t[..., :lanes].contiguous() for t in (P, Q, sel))
        ms, got = cuda_ms(lambda: g1_cuda.dbladd(F, a, b, s_), reps=5 if lanes > N_BASE else 50)
        want = chunked(lambda x, y, z: g1_cuda.dbladd_plain(F, x, y, z), lanes, a, b, s_)
        if not torch.equal(got, want):
            raise AssertionError(f"dbladd at {lanes} lanes disagrees with its plain version")
        bnd = bound((3 * 3 * L * 4 + 1) * lanes, wide_mads(8 * lanes + 12 * int(s_.sum()), L))
        log("time_dbladd", design=design, lanes=lanes, L=L, ms=f"{ms:.4f}",
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            over_bound=f"{ms / bnd['bound_ms']:.2f}x", equal=True, card=repr(smi))


def time_smul_static(g1_cuda, F, Q, bits, repo: str, design: str, smi: str) -> None:
    """``smul_static`` of the imported checkout on Q's lanes with the
    MSB-first ``bits``, beside the bound (8 products a bit, 12 more at each
    one-bit), its output equal to the plain version's; a
    ``[time_smul_static]`` line."""
    import torch

    L, n = F.fp.L, Q.shape[-1]
    ms, got = cuda_ms(lambda: g1_cuda.smul_static(F, Q, bits), reps=5)
    if not torch.equal(got, g1_cuda.smul_static_plain(F, Q, bits)):
        raise AssertionError("smul_static disagrees with its plain version")
    h = [int(b) for b in bits]
    b = bound(2 * 3 * L * 4 * n, wide_mads(n * (8 * len(h) + 12 * sum(h)), L))
    log("time_smul_static", repo=repr(repo), design=design, lanes=n, bits=len(h), ones=sum(h),
        ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
        over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True, card=repr(smi))


SPLIT_KERNELS = ("g1_add_kernel", "g1_addsel_kernel", "g1_double_kernel", "g1_addselneg_kernel",
                 "g1_maddsel_kernel", "g1_maddselneg_kernel", "g1_smul_ladder_kernel",
                 "g1_dbladd_kernel")


G2_BLOCK_KERNELS = ("g2_ladder_kernel", "g2_smul", "g2_add_kernel", "g2_double_kernel",
                    "g2_dblsel_kernel", "g2_addsel_kernel")
# the G2 sources that hold kernels on the ladder's step, in this checkout and
# in older ones (before the step code had a header of its own)
G2_STEP_SOURCES = ("g2_point_kernels.cu", "g2_dblsel_kernels.cu", "g2_smul_kernels.cu")


def g2_ladder_ptxas(path: str) -> list:
    """The build log's ptxas lines of the G2 ladder kernels and of the add,
    doubling, addsel and dblsel kernels on the ladder's steps (or their
    one-thread predecessors, in an older checkout)."""
    return [e for e in ptxas_entries(path) if e.startswith(G2_BLOCK_KERNELS)]


def _g2_block(build, kernel: str) -> str:
    """"block" if the imported checkout has ``kernel`` on the G2 ladder's step
    (over a block's warps), else "one-thread" (a lane a thread)."""
    return ("block" if any(_source_has(build, src, kernel) for src in G2_STEP_SOURCES)
            else "one-thread")


def g2_step_design(build) -> str:
    """Which g2_add and g2_double kernels the imported checkout has: "block"
    (a launch of the G2 ladder's add or doubling half over a block's warps)
    or "one-thread"."""
    return _g2_block(build, "g2_add_kernel")


def addsel_design(build) -> str:
    """Which g2_addsel kernel the imported checkout has: "block" (a launch of
    the G2 add's half with the select at its store) or "one-thread"."""
    return _g2_block(build, "g2_addsel_kernel")


def split_ptxas(path: str) -> list:
    """The build log's ptxas lines of the add, addsel, double, the signed
    and mixed combiner kernels and the ladder."""
    return [e for e in ptxas_entries(path) if e.startswith(SPLIT_KERNELS)]


def mont_ptxas(path: str) -> list:
    """The build log's ptxas lines of the two mont_mul kernels."""
    return [e for e in ptxas_entries(path) if e.startswith("mont_mul")]


# the ladder's lane counts: phase 5's base points (8,192), bls_sign_batch's
# 4,096, and two smaller calls, where one 32-lane block a bit sets the time
SMUL_LANES = (N_BASE, 4096, 2048, 1024)


def time_smul(g1_cuda, F, Q, K, design: str, nbits: int, lanes=SMUL_LANES, want=None) -> None:
    """``smul`` of the imported checkout (``design``: its name in the log) on
    the first ``lanes`` lanes of Q and the scalar limbs K, beside the bound
    (8 products a bit, 12 at each one-bit of these scalars) and, if
    ``want`` (the plain version's output on all of Q) is given, checked
    against it; a ``[time_smul]`` line each."""
    import torch

    L, S = F.fp.L, K.shape[-2]
    bits = (K.to(torch.int64) & 0xFFFF).cpu()
    for m in lanes:
        q, k = Q[..., :m].contiguous(), K[..., :m].contiguous()
        ones = sum(bin(int(v)).count("1") for v in bits[:, :m].reshape(-1))
        b = bound((2 * 3 * L * 4 + 4 * S) * m, wide_mads(8 * nbits * m + 12 * ones, L))
        ms, got = cuda_ms(lambda: g1_cuda.smul(F, q, k, nbits), reps=5)
        if want is not None and not torch.equal(got, want[..., :m]):
            raise AssertionError(f"smul at {m} lanes disagrees with its plain version")
        log("time_smul", design=design, lanes=m, L=L, nbits=nbits, ms=f"{ms:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
            over_bound=f"{ms / b['bound_ms']:.2f}x", equal=want is not None)


# mont_mul's shapes (rows, L, n, b an (L, 1) constant): the pairing check's
# Montgomery entry (6 rows of 4,096 pairs, times R^2) and to_affine_rows'
# products on the 2^20 MSM's points; the sweep between them (phase 7) finds
# where the launcher's two bodies cross
MONT_SHAPES = ((6, 24, N_PAIRS, True), (2, 24, N_MAIN, False))
MONT_SWEEP = ((1, 24, 1024, False), (1, 24, 4096, False), (2, 24, 4096, False), MONT_SHAPES[0],
              (6, 24, 1 << 14, False), (2, 24, 1 << 16, False), (2, 24, 1 << 18, False),
              MONT_SHAPES[1])


def time_mont_mul(fp_cuda, fp, design: str, shapes=MONT_SHAPES) -> None:
    """``mont_mul`` of the imported checkout on BLS12-381's p at ``shapes``,
    on seeded relaxed limbs (below p), beside the bound; where the checkout
    picks its body by size (``fp_cuda.mont_group``), each body forced in
    turn as well ("default": the checkout's own choice).  A
    ``[time_mont_mul]`` line each."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    top = int(fp.p >> (16 * (fp.L - 1)))  # top limb below p's: values below p
    for rows, L, n, const in shapes:
        def limbs(*shape):
            t = torch.randint(0, 1 << 16, shape, generator=gen, device="cuda", dtype=torch.int32)
            t[..., L - 1, :] %= top
            return t

        a = limbs(rows, L, n)
        b = limbs(L, 1) if const else limbs(rows, L, n)
        # the plain product in slices: its partial products are L^2 a lane
        want = (fp_cuda.mont_mul_plain(fp, a, b) if const or n <= PLAIN_CHUNK
                else chunked(lambda x, y: fp_cuda.mont_mul_plain(fp, x, y), n, a, b))
        nbytes = (2 + (not const)) * rows * L * 4 * n
        bnd = bound(nbytes, wide_mads(rows * n, L))
        bodies = {"default": None}
        if hasattr(fp_cuda, "mont_group"):
            bodies.update(one_thread=1, grouped=4)
        for body, group in bodies.items():
            pick = getattr(fp_cuda, "mont_group", None)
            if group is not None:
                fp_cuda.mont_group = lambda elements, g=group: g
            try:
                ms, got = cuda_ms(lambda: fp_cuda.mont_mul(fp, a, b),
                                  reps=200 if rows * n <= 1 << 16 else 20)
            finally:
                if pick is not None:
                    fp_cuda.mont_group = pick
            if not torch.equal(got, want):
                raise AssertionError(f"mont_mul ({body}) at {(rows, L, n)} disagrees with plain")
            log("time_mont_mul", design=design, body=body, shape=repr((rows, L, n)),
                b="(L, 1)" if const else "elementwise", ms=f"{ms:.5f}",
                bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
                over_bound=f"{ms / bnd['bound_ms']:.2f}x", equal=True)


def chain_ptxas(path: str) -> list:
    """The build log's ptxas lines of the hash_g1 and fp_pow kernels."""
    return [e for e in ptxas_entries(path) if e.startswith(("hash_g1", "fp_pow"))]


def record_pow_calls(run):
    """run() with every fp_pow call it makes recorded (through
    ``FpCtx.pow_bits``, fp_pow's one caller): returns run()'s output and a
    list of (FpCtx, a copy of the operand, the MSB-first bits)."""
    import numpy as np
    from mathlib_tpu_torch.ops.field import FpCtx

    seen, pow_bits = [], FpCtx.pow_bits

    def recorded(fp_ctx, z, le_bits):
        seen.append((fp_ctx, z.clone(), np.ascontiguousarray(np.asarray(le_bits)[::-1])))
        return pow_bits(fp_ctx, z, le_bits)

    FpCtx.pow_bits = recorded
    try:
        out = run()
    finally:
        FpCtx.pow_bits = pow_bits
    return out, seen


def time_fp_pow(fp_cuda, fp, z, bits, what: str, design: str, smi: str) -> dict:
    """``fp_pow`` of the imported checkout on z (a call an entry point made)
    against one run of its plain version and beside the bound (one square a
    bit and one product a one-bit an element); where the checkout picks its
    body by size (``fp_cuda.pow_group``), each body forced in turn as well
    ("default": the checkout's own choice).  A ``[time_fp_pow]`` line each;
    returns the default body's ms, the plain ms and the bound."""
    import torch
    from mathlib_tpu_torch.ops.kernels.tower_rows import pow_mults

    plain_ms, want = cuda_ms(lambda: fp_cuda.fp_pow_plain(fp, z, bits), reps=1)
    elements = z.numel() // fp.L
    bnd = bound(2 * z.numel() * 4, wide_mads(elements * pow_mults(bits), fp.L))
    pick = getattr(fp_cuda, "pow_group", None)
    bodies = {"default": None, **({"one_thread": 1, "grouped": 4} if pick else {})}
    out = {}
    for body, group in bodies.items():
        if group is not None:
            fp_cuda.pow_group = lambda e, g=group: g
        try:
            ms, got = cuda_ms(lambda: fp_cuda.fp_pow(fp, z, bits), reps=3)
        finally:
            if pick is not None:
                fp_cuda.pow_group = pick
        if not torch.equal(got, want):
            raise AssertionError(f"fp_pow ({body}) on {what} disagrees with its plain version")
        out[body] = ms
        log("time_fp_pow", design=design, body=body, what=repr(what), shape=repr(tuple(z.shape)),
            elements=elements, bits=len(bits), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            over_bound=f"{ms / bnd['bound_ms']:.2f}x", equal=True, card=repr(smi))
    return {"ms": out["default"], "plain_ms": plain_ms, **bnd}


def time_g2_map_pows(fp_cuda, calls, design: str, smi: str) -> None:
    """fp_pow on the calls one G2 map makes (the first half of a
    ``hash_to_g2_batch`` call's eight: the Fp2 inverse, then the Fp2 square
    root's three chains, two square roots and an inverse), each against its
    plain version and timed by ``time_fp_pow``."""
    names = ("f2_inv", "sqrt chain 1", "sqrt chain 2 (stacked)", "sqrt chain 3 (inverse)")
    if len(calls) != 8:
        raise AssertionError(f"hash_to_g2_batch ran fp_pow {len(calls)} times, not 8")
    for what, (fp, z, bits) in zip(names, calls[:4]):
        time_fp_pow(fp_cuda, fp, z, bits, f"G2 map, {what}", design, smi)


def tree_ptxas(path: str) -> list:
    """The build log's ptxas lines of the product tree's kernel."""
    return [e for e in ptxas_entries(path) if e.startswith(("f12_tree", "f12_pair_mul"))]


def miller_ptxas(path: str) -> list:
    """The build log's ptxas lines of the Miller kernels."""
    return [e for e in ptxas_entries(path) if e.startswith("miller_")]


def fexp_ptxas(path: str) -> list:
    """The build log's ptxas lines of the f12_pow and final_exp kernels."""
    return [e for e in ptxas_entries(path) if e.startswith(("f12_pow", "final_exp"))]


def add_step_ptxas(path: str) -> list:
    """The build log's ptxas lines of the add_step kernel."""
    return [e for e in ptxas_entries(path) if e.startswith("add_step")]


def add_step_design(build) -> str:
    """Which add_step kernel the imported checkout has: "split" (one lane's
    step over a block's workers, csrc/miller_split_kernels.cu) or
    "one-thread"."""
    return ("split" if _source_has(build, "miller_split_kernels.cu", "add_step_split_kernel")
            else "one-thread")


def bn_fexp_design(build) -> str:
    """How the imported checkout runs BN's final exp: "one-launch" (the
    final_exp kernel's BN script) or "eager" (tower ops, fp_pow, f12_pow)."""
    from mathlib_tpu_torch.ops.kernels import fexp_prog

    return "one-launch" if hasattr(fexp_prog, "BN_PROGRAMS") else "eager"


def fexp_design(build) -> str:
    """"split" for a checkout with the split final-exp kernels (one lane's
    chain over the workers of a block, csrc/fexp_split_kernels.cu), else
    "one-thread"."""
    return ("split" if os.path.exists(os.path.join(build.CSRC, "fexp_split_kernels.cu"))
            else "one-thread")


def miller_design(build) -> str:
    """Which Miller kernels the imported checkout has: "split" (one lane's
    loop over the warps of a block, csrc/miller_split_kernels.cu) or
    "one-thread" (a lane a thread)."""
    return ("split" if os.path.exists(os.path.join(build.CSRC, "miller_split_kernels.cu"))
            else "one-thread")


def split_design(build) -> str:
    """Which add and addsel kernels the imported checkout has: "six-warp"
    (csrc/g1_split_kernels.cu) or "one-thread" (rcb_add a thread)."""
    return ("six-warp" if os.path.exists(os.path.join(build.CSRC, "g1_split_kernels.cu"))
            else "one-thread")


def combiner_design(build) -> str:
    """Which signed and mixed scan combiners the imported checkout has:
    "six-warp" (split_add and split_madd in csrc/g1_split_kernels.cu) or
    "one-thread" (a lane a thread)."""
    return ("six-warp" if _source_has(build, "g1_split_kernels.cu", "g1_maddselneg_kernel")
            else "one-thread")


def smul_design(build) -> str:
    """Which smul kernel the imported checkout has: "six-warp" (the ladder
    over a block's six warps, csrc/g1_split_kernels.cu) or "one-thread"."""
    return ("six-warp" if _source_has(build, "g1_split_kernels.cu", "g1_smul_ladder_kernel")
            else "one-thread")


def static_design(build) -> str:
    """Which smul_static kernel the imported checkout has: "six-warp" (the
    ladder with one bit string, csrc/g1_split_kernels.cu) or "one-thread"."""
    return ("six-warp" if _source_has(build, "g1_split_kernels.cu", "mlt_g1_smul_static")
            else "one-thread")


def check_design(build) -> str:
    """Which pairing_check kernel the imported checkout has: "split" (the
    split kernels' programs in one launch, csrc/check_kernels.cu) or
    "one-thread" (a lane a thread, one thread's final exp)."""
    return "split" if _source_has(build, "check_kernels.cu", "check_rows") else "one-thread"


def check_ptxas(path: str) -> list:
    """The build log's ptxas lines of the one-launch check kernel."""
    return [e for e in ptxas_entries(path) if e.startswith("pairing_check")]


def static_ptxas(path: str) -> list:
    """The build log's ptxas lines of smul_static's kernel: the ladder with
    STATIC set, or the one-thread kernel."""
    return [e for e in ptxas_entries(path)
            if e.startswith("g1_smul_static") or
            (e.startswith("g1_smul_ladder_kernel") and e.split(":")[0].endswith(",1>"))]


def no_stack_or_spill(entry: str) -> bool:
    return entry.endswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")


def mont_design(build) -> str:
    """Which mont_mul the imported checkout has: "grouped" (four threads an
    element below a size, csrc/fp_kernels.cu) or "one-thread"."""
    return ("grouped" if _source_has(build, "fp_kernels.cu", "mont_mul_group_kernel")
            else "one-thread")


def pow_design(build) -> str:
    """Which fp_pow the imported checkout has: "grouped" (four threads an
    element below a size, csrc/fp_kernels.cu) or "one-thread"."""
    return ("grouped" if _source_has(build, "fp_kernels.cu", "fp_pow_group_kernel")
            else "one-thread")


def hash_design(build) -> str:
    """Which hash_g1 kernel the imported checkout has: "grouped" (a lane over
    four groups of threads, csrc/hash_kernels.cu) or "one-thread"."""
    return "grouped" if _source_has(build, "hash_kernels.cu", "fp_mul_group") else "one-thread"


def _source_has(build, source: str, word: str) -> bool:
    path = os.path.join(build.CSRC, source)
    return os.path.exists(path) and word in open(path).read()


def double_design(build) -> str:
    """Which double kernel the imported checkout has: "four-warp"
    (split_dbl in csrc/g1_split_kernels.cu) or "one-thread" (rcb_dbl a
    thread)."""
    return "four-warp" if _source_has(build, "g1_split_kernels.cu", "split_dbl") else "one-thread"


def dbladd_design(build) -> str:
    """Which dbladd kernel the imported checkout has: "six-warp" (one bit of
    the six-warp ladder, csrc/g1_split_kernels.cu) or "one-thread"."""
    return ("six-warp" if _source_has(build, "g1_split_kernels.cu", "g1_dbladd_kernel")
            else "one-thread")


def dblsel_design(build) -> str:
    """Which g2_dblsel kernel the imported checkout has: "block" (one bit of
    the G2 ladder over a block's warps) or "one-thread"."""
    return _g2_block(build, "g2_dblsel_kernel")


def tree_design(build) -> str:
    """Which product tree the imported checkout has: "split" (levels a
    launch over a block's workers, csrc/fexp_split_kernels.cu) or
    "one-thread" (a launch a level, a lane a thread)."""
    return ("split" if _source_has(build, "fexp_split_kernels.cu", "f12_tree_split_kernel")
            else "one-thread")


def profile_run(run) -> None:
    """Device time of one run() by kernel and by operator (torch.profiler).
    A first run under a warm-up step starts the tracer; the second is the
    one recorded (a second profiler in one process otherwise
    missed the activity of its first ~20 ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()

    def dev_us(ev):
        us = getattr(ev, "self_device_time_total", None)
        return ev.self_cuda_time_total if us is None else us

    events = prof.key_averages()
    kernels = sorted(  # the schedule's "ProfilerStep*" span is not a kernel
        (ev for ev in events if str(ev.device_type).endswith("CUDA") and dev_us(ev) > 0
         and not ev.key.startswith("ProfilerStep")),
        key=dev_us, reverse=True,
    )
    ops = sorted(
        (ev for ev in events if ev.key.startswith("aten::") and dev_us(ev) > 0),
        key=dev_us, reverse=True,
    )
    total_ms = sum(dev_us(ev) for ev in kernels) / 1e3
    for ev in kernels[:12]:
        log("profile_kernel", ms=f"{dev_us(ev) / 1e3:.3f}", count=ev.count, name=repr(ev.key[:90]))
    for ev in ops[:8]:
        log("profile_op", ms=f"{dev_us(ev) / 1e3:.3f}", count=ev.count, name=ev.key)
    log("profile", device_ms=f"{total_ms:.3f}", kernel_launches=sum(ev.count for ev in kernels),
        profiled_wall_ms=f"{wall_ms:.1f}", busy_share=f"{total_ms / wall_ms:.3f}")


def add_ms_by_curve(dev, rng) -> None:
    """The add kernel at 2^20 lanes on BLS12-381 (L=24) and BN254 (L=16):
    tiled random multiples of the generator, checked against the plain
    version on PLAIN_CHUNK lanes."""
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import g1_cuda

    for curve in ("BLS12_381", "BN254"):
        spec = get_spec(curve)
        eng, g = get_engine(spec), G1Ctx(spec, dev)
        pool = [eng.g1.mul(eng.gen_g1, int(k)) for k in rng.integers(1, 1 << 62, 64)]
        P = g.encode_points(pool).repeat(1, 1, N_MAIN // 64).contiguous()
        Q = torch.roll(P, 1, dims=-1).contiguous()
        ms, out = cuda_ms(lambda: g1_cuda.add(g.F, P, Q), reps=5)
        sl = slice(0, PLAIN_CHUNK)
        if not torch.equal(out[..., sl], g1_cuda.add_plain(g.F, P[..., sl], Q[..., sl])):
            raise AssertionError(f"add kernel disagrees with its plain version on {curve}")
        log("profile_add", curve=curve, L=g.fp.L, lanes=N_MAIN, ms=f"{ms:.4f}")


def time_tree_levels(pc, cfg, f, smi: str) -> None:
    """The product tree's depth at check (a)'s 4,096 lanes: one level alone
    (2 lanes, seg 2: one f12 product and one launch), one launch of 4 levels
    (16 lanes), and the whole tree, beside the depth floor (12 levels at one
    level's time) and the ops bound; a ``[tree_levels]`` line (CUDA events,
    mean of 20 calls)."""
    t = {}
    for B in (2, 16, N_PAIRS):
        a = f[..., :B].contiguous()
        t[B], _ = cuda_ms(lambda: pc.f12_seg_product(cfg, a, B), reps=20)
    depth = N_PAIRS.bit_length() - 1
    ops = bound(0, wide_mads(seg_product_fp_muls(cfg, N_PAIRS, N_PAIRS), cfg.fp.L))
    log("tree_levels", lanes=N_PAIRS, levels=depth, launches=len(pc.tree_plan(cfg, N_PAIRS)[2]),
        block=pc.tree_shape(cfg), one_level_ms=f"{t[2]:.4f}", four_levels_ms=f"{t[16]:.4f}",
        level_in_a_launch_ms=f"{(t[16] - t[2]) / 3:.4f}", tree_ms=f"{t[N_PAIRS]:.4f}",
        depth_floor_ms=f"{depth * t[2]:.4f}", ops_bound_ms=f"{ops['bound_ms']:.4f}",
        card=repr(smi))


def pairing_phases(dev, smi: str, results: dict, profile: bool):
    """Phases 6 and 7; fills ``results`` for the pairing kernels and returns
    their launch counts over phase 7's main-path runs, and phase 7's checks
    (engine, inputs, verdicts, timed seconds) for phase 9's strategies."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.kernels import fp_cuda, g1_cuda, pairing_cuda as pc

    rng = np.random.default_rng(0)

    def scalars(spec, count):
        return [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(count)]

    def random_pairs(eng, spec, count):
        g1s = [eng.g1.mul(eng.gen_g1, k) for k in scalars(spec, count)]
        return g1s, [eng.g2.mul(eng.gen_g2, k) for k in scalars(spec, count)]

    def check(name, got, want):
        check_equal(results, name, got, want)

    # ---- 6. the split Miller kernels' ptxas lines (no stack, no spill), then
    # the pairing kernels against their plain versions (exact)
    from mathlib_tpu_torch.ops.kernels import build

    for entry in miller_ptxas(build.BUILD_LOG) + tree_ptxas(build.BUILD_LOG):
        log("ptxas_miller", entry=repr(entry))
        if not entry.endswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
            raise AssertionError(f"split pairing kernel with a stack or a spill: {entry}")
    if not tree_ptxas(build.BUILD_LOG):
        raise AssertionError("the tree kernel's ptxas lines are missing from the build log")
    for curve in ("BLS12_381", "BN254", "BLS12_377"):
        spec = get_spec(curve)
        eng, be = get_engine(spec), BatchEngine(spec, dev)
        cfg = be.pair.cfg
        packed = be._encode_pairs(*random_pairs(eng, spec, N_LANES_CHECK))
        t = torch.from_numpy(packed.astype(np.int32)).to(dev)
        r2 = be.fp.r2_limbs.to(torch.int32)
        check("mont_mul", fp_cuda.mont_mul(be.fp, t, r2), fp_cuda.mont_mul_plain(be.fp, t, r2))
        xP, yP, Qx, Qy = be._pair_split_mont(packed)
        f = pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_VALID_CHECK)
        check("miller_lanes", f, pc.miller_lanes_plain(cfg, xP, yP, Qx, Qy, N_VALID_CHECK))
        if not (f[..., N_VALID_CHECK:] == be.pair.cfg.tower.f12_one_like(1, dev)).all():
            raise AssertionError(f"pad lanes of miller_lanes are not one on {curve}")
        # the tree on 1, 2, 64 and 4,096 lanes (f tiled; its pad lanes are the
        # f12 one, as tree_width pads a check), seg 2, 64 and the whole batch
        tiled = f.repeat(1, 1, 1, 1, N_PAIRS // N_LANES_CHECK)
        segs = {}
        for B in TREE_LANES:
            a = tiled[..., :B].contiguous()
            segs[B] = sorted({s for s in (2, N_LANES_CHECK, B) if s <= B})
            for seg in segs[B]:
                check("f12_seg_product", pc.f12_seg_product(cfg, a, seg),
                      pc.f12_seg_product_plain(cfg, a, seg))
        log("pair_kernels_vs_plain", curve=curve, L=be.fp.L, lanes=N_LANES_CHECK,
            n=N_VALID_CHECK, tree_lanes_segs=segs, tree_block=pc.tree_shape(cfg), equal=True)
        del tiled

    # the same kernels at phase 7's shapes (BLS12-381), timed beside their
    # plain versions (run in PLAIN_PAIR_CHUNK-lane slices)
    spec = get_spec("BLS12_381")
    eng, be = get_engine(spec), BatchEngine(spec, dev)
    cfg, L = be.pair.cfg, be.fp.L
    g1s, g2s = random_pairs(eng, spec, N_PAIRS)
    packed = be._encode_pairs(g1s, g2s)
    t = torch.from_numpy(packed.astype(np.int32)).to(dev)
    r2 = be.fp.r2_limbs.to(torch.int32)
    xP, yP, Qx, Qy = be._pair_split_mont(packed)
    f = pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_PAIRS)
    # miller_lanes at the grouped checks' lane count, which takes a smaller
    # block than 4,096 lanes (and so other programs), against its plain version
    b_args = [a[..., : 2 * N_CHECKS].contiguous() for a in (xP, yP, Qx, Qy)]
    f_b = pc.miller_lanes(cfg, *b_args, 2 * N_CHECKS)
    check("miller_lanes", f_b,
          chunked(lambda a, b, c, d: pc.miller_lanes_plain(cfg, a, b, c, d, PLAIN_PAIR_CHUNK),
                  2 * N_CHECKS, *b_args, step=PLAIN_PAIR_CHUNK))
    log("pair_kernels_vs_plain", curve="BLS12_381", kernel="miller_lanes", lanes=2 * N_CHECKS,
        block=pc.miller_shape(cfg, 2 * N_CHECKS), equal=True)
    del b_args
    limb_bytes = L * 4
    shapes = {  # name: (what, kernel, plain, bytes, field products)
        "mont_mul": (
            f"(6, {L}, {N_PAIRS})",
            lambda: fp_cuda.mont_mul(be.fp, t, r2),
            lambda: fp_cuda.mont_mul_plain(be.fp, t, r2),
            2 * 6 * limb_bytes * N_PAIRS, 6 * N_PAIRS),
        "miller_lanes": (
            f"{N_PAIRS} lanes",
            lambda: pc.miller_lanes(cfg, xP, yP, Qx, Qy, N_PAIRS),
            lambda: chunked(lambda a, b, c, d: pc.miller_lanes_plain(cfg, a, b, c, d, PLAIN_PAIR_CHUNK),
                            N_PAIRS, xP, yP, Qx, Qy, step=PLAIN_PAIR_CHUNK),
            (6 + 12) * limb_bytes * N_PAIRS, miller_fp_muls(cfg, N_PAIRS)),
        "f12_seg_product": (
            f"{N_PAIRS} lanes, seg {N_PAIRS}",
            lambda: pc.f12_seg_product(cfg, f, N_PAIRS),
            lambda: pc.f12_seg_product_plain(cfg, f, N_PAIRS),
            12 * limb_bytes * (N_PAIRS + 1), seg_product_fp_muls(cfg, N_PAIRS, N_PAIRS)),
        "f12_seg_product_seg2": (
            f"{2 * N_CHECKS} lanes, seg 2",
            lambda: pc.f12_seg_product(cfg, f_b, 2),
            lambda: chunked(lambda a: pc.f12_seg_product_plain(cfg, a, 2), 2 * N_CHECKS, f_b,
                            step=PLAIN_PAIR_CHUNK),
            12 * limb_bytes * 3 * N_CHECKS, seg_product_fp_muls(cfg, 2 * N_CHECKS, 2)),
    }
    for name, (what, kern, plain, nbytes, fp_muls) in shapes.items():
        pc.reset_launches()
        reps = 200 if name == "mont_mul" else 3  # a few microseconds a mont_mul launch
        ms, got = cuda_ms(kern, reps=reps)
        calls = reps + 1  # cuda_ms's warm-up and its runs
        per_call = {k: v // calls for k, v in pc.launches().items() if v}
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name.replace("_seg2", ""), got, want)
        del got, want
        b = bound(nbytes, wide_mads(fp_muls, L))
        if name in KERNEL_INFO:
            results[name].update(ms=ms, plain_ms=plain_ms, **b)
        log("time", kernel=name, shape=repr(what), equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"], launches_a_call=per_call)
    time_tree_levels(pc, cfg, f, smi)
    del f, f_b, t, xP, yP, Qx, Qy
    # mont_mul's two bodies from 1,024 elements to the 2^20 MSM's to_affine
    time_mont_mul(fp_cuda, be.fp, mont_design(build), MONT_SWEEP)

    # ---- 7. the product check at full width through BatchEngine
    # (c) per-lane Miller values, reduced on the host, against the host pairing
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s[:8], g2s[:8]))
    lanes = be.tw.f12_decode(pc.miller_lanes(cfg, xP, yP, Qx, Qy, 8))
    for v, P, Q in zip(lanes, g1s, g2s):
        if eng.final_exp(v) != eng.pairing(P, Q):
            raise AssertionError("a reduced per-lane Miller value differs from the host pairing")
    log("pairing_lanes", lanes=8, equal_host_pairing=True)

    # (a) 2,048 pairs (a g1, b g2), each beside (-ab g1, g2)
    a_s, b_s = scalars(spec, N_PAIRS // 2), scalars(spec, N_PAIRS // 2)
    g1s, g2s = [], []
    for a, b in zip(a_s, b_s):
        g1s += [eng.g1.mul(eng.gen_g1, a), eng.g1.mul(eng.gen_g1, (-a * b) % spec.r)]
        g2s += [eng.g2.mul(eng.gen_g2, b), eng.gen_g2]
    bad_g1s = g1s[:-1] + [eng.g1.mul(eng.gen_g1, (-a_s[-1] * b_s[-1] + 1) % spec.r)]
    # (b) 1,024 BLS verifies e(sig, g2) e(-H, pk), a known half corrupted
    sks, hs = scalars(spec, N_CHECKS), scalars(spec, N_CHECKS)
    bad = set(int(i) for i in rng.permutation(N_CHECKS)[: N_CHECKS // 2])
    v_g1s, v_g2s, verdicts = [], [], []
    for k, (sk, h) in enumerate(zip(sks, hs)):
        H = eng.g1.mul(eng.gen_g1, h)
        sig = eng.g1.mul(H, sk + 1 if k in bad else sk)
        v_g1s += [sig, eng.g1.neg(H)]
        v_g2s += [eng.gen_g2, eng.g2.mul(eng.gen_g2, sk)]
        verdicts.append(k not in bad)

    def run_a():
        return be.pairing_product_is_one(g1s, g2s)

    def run_b():
        return be.pairing_products_are_one(v_g1s, v_g2s, 2)

    if be.pairing_product_is_one(bad_g1s, g2s) is not False:
        raise AssertionError("the check with one scalar changed did not fail")
    for mod in (g1_cuda, fp_cuda, pc):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # tensors of the earlier phases
    walls = {"a": [], "b": []}
    for name, run, want in (("a", run_a, True), ("b", run_b, verdicts)):
        got = run()  # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"phase 7 ({name}): wrong verdict(s)")
    launches = {k: v for k, v in {**fp_cuda.launches(), **pc.launches()}.items()
                if k in ("mont_mul", "miller_lanes", "f12_seg_product")}
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"pairing kernels not launched on the pairing path: {missing}")
    log("pairing_check", pairs=N_PAIRS, is_one=True, twin_is_one=False,
        seconds=[round(x, 4) for x in walls["a"]],
        pairings_per_s=f"{N_PAIRS / min(walls['a']):.1f}", card=repr(smi))
    log("pairing_checks_grouped", checks=N_CHECKS, group=2, verdicts_right=N_CHECKS,
        corrupted=len(bad), seconds=[round(x, 4) for x in walls["b"]],
        checks_per_s=f"{N_CHECKS / min(walls['b']):.1f}",
        pairings_per_s=f"{2 * N_CHECKS / min(walls['b']):.1f}")
    log("pairing_peak", peak_mem_GB=f"{peak / 1e9:.3f}", held_before_GB=f"{held / 1e9:.3f}",
        path_peak_GB=f"{(peak - held) / 1e9:.3f}")
    log("pairing_launches", **launches)

    # stages of one more run of each (host clock; device time by CUDA events)
    for name, g1l, g2l, seg in (("a", g1s, g2s, None), ("b", v_g1s, v_g2s, 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = be._encode_pairs(g1l, g2l)
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        split = be._pair_split_mont(packed)
        ev[1].record()
        prod = (be.pair.product_miller(*split) if seg is None
                else be.pair.products_miller(*split, seg))
        ev[2].record()
        prod = prod.cpu()
        t2 = time.perf_counter()
        vals = be.tw.f12_decode(prod)
        t3 = time.perf_counter()
        ok = [eng.gt_is_one(eng.final_exp(v)) for v in vals[:64]]
        t4 = time.perf_counter()
        if seg is None and ok != [True]:
            raise AssertionError("stage run of (a) did not check True")
        log("pairing_stages", run=name, encode_host_s=f"{t1 - t0:.4f}",
            to_mont_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}",
            miller_and_product_device_ms=f"{ev[1].elapsed_time(ev[2]):.4f}",
            device_wall_s=f"{t2 - t1:.4f}", decode_host_s=f"{t3 - t2:.4f}",
            final_exp_host_ms_each=f"{1e3 * (t4 - t3) / len(ok):.3f}")
    if profile:
        profile_run(run_a)
    checks = {"be": be, "a": (g1s, g2s), "a_bad": (bad_g1s, g2s), "b": (v_g1s, v_g2s),
              "b_verdicts": verdicts, "seconds": walls}
    return launches, checks


def hard_digits(spec) -> list:
    """The base-p digits of a BN curve's hard-part exponent, lowest first:
    one f12_pow chain each in ``TowerCtx.f12_final_exp``."""
    e, out = spec.hard_part_exp, []
    while e:
        out.append(e % spec.p)
        e //= spec.p
    return out


def unitary(tw, f):
    """The easy part of the final exp on the tower ops: a unitary base."""
    t = tw.f12_mul(tw.f12_conj(f), tw.f12_inv(f))
    return tw.f12_mul(tw.f12_frob(t, 2), t).contiguous()


def best_of_3(run, want=None):
    """One warm-up and 3 host-clock runs of run(), each ending in a
    synchronise; returns (output, seconds); the outputs must agree (and equal
    ``want`` when given)."""
    import torch

    first = run()
    if want is not None and first != want:
        raise AssertionError("a run gave the wrong result")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if out != first:
            raise AssertionError("runs of one call disagree")
    return first, secs


def pairing_batch_phases(dev, smi: str, results: dict, checks: dict) -> dict:
    """Phases 8 and 9; fills ``results`` for the kernels of pairing_batch and
    returns their launch counts over phase 9's pairing_batch runs (both
    curves; mont_mul included)."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.kernels import fp_cuda, pairing_cuda as pc
    from mathlib_tpu_torch.ops.kernels.tower_rows import (
        final_exp_bn_mults, final_exp_mults, mults_per_step)

    rng = np.random.default_rng(1)

    def scalars(spec, count):
        return [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(count)]

    def random_pairs(eng, spec, count):
        g1s = [eng.g1.mul(eng.gen_g1, k) for k in scalars(spec, count)]
        return g1s, [eng.g2.mul(eng.gen_g2, k) for k in scalars(spec, count)]

    def check(name, got, want):
        check_equal(results, name, got, want)

    # ---- 8. the split final-exp and add_step kernels' ptxas lines (no stack,
    # no spill; add_step at most 64 registers), then each kernel of
    # pairing_batch against its plain version (exact), 64 lanes, full chains,
    # on three curves (final_exp on BN254 over its own x too: the kernel
    # takes any chain)
    from mathlib_tpu_torch.ops.kernels import build

    clean = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    for entry in fexp_ptxas(build.BUILD_LOG):
        log("ptxas_fexp", entry=repr(entry))
        if not entry.endswith(clean):
            raise AssertionError(f"split final-exp kernel with a stack or a spill: {entry}")
    if not add_step_ptxas(build.BUILD_LOG):
        raise AssertionError("the add_step kernel's ptxas lines are missing from the build log")
    for entry in add_step_ptxas(build.BUILD_LOG):
        log("ptxas_add_step", entry=repr(entry))
        if not entry.endswith(clean) or int(entry.split(": ")[1].split()[0]) > 64:
            raise AssertionError(f"add_step kernel with a stack, a spill or > 64 registers: {entry}")
    for curve in ("BLS12_381", "BN254", "BLS12_377"):
        spec = get_spec(curve)
        eng, be = get_engine(spec), BatchEngine(spec, dev)
        cfg, kcfg, tw = be.pair.cfg, be.tw.kcfg, be.tw
        xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(*random_pairs(eng, spec, N_LANES_CHECK)))
        f, T = pc.miller_ft(cfg, xP, yP, Qx, Qy)
        fw, Tw = pc.miller_ft_plain(cfg, xP, yP, Qx, Qy)
        check("miller_ft", f, fw)
        check("miller_ft", T, Tw)
        for got, want in zip(pc.add_step(cfg, f, T, Qx, Qy, xP, yP),
                             pc.add_step_plain(cfg, f, T, Qx, Qy, xP, yP)):
            check("add_step", got, want)
        inv, xb = kcfg.inv_bits, pc.msb_bits(abs(spec.x))
        check("fp_pow", fp_cuda.fp_pow(be.fp, xP, inv), fp_cuda.fp_pow_plain(be.fp, xP, inv))
        u = unitary(tw, f)
        pow_bits = pc.msb_bits(hard_digits(spec)[0]) if spec.family.name == "BN" else xb
        for cyclo in (True, False):
            check("f12_pow", pc.f12_pow(kcfg, u, pow_bits, cyclo),
                  pc.f12_pow_plain(kcfg, u, pow_bits, cyclo))
        check("final_exp", pc.final_exp(kcfg, f, inv, xb, spec.x < 0),
              pc.final_exp_plain(kcfg, f, inv, xb, spec.x < 0))
        kinds = ("final_exp", "f12_pow")
        if spec.family.name == "BN":  # the whole BN final exp, as pairing_batch runs it
            check("final_exp", pc.final_exp(kcfg, f),
                  pc.final_exp_bn_plain(kcfg, f, inv, kcfg.digit_bits))
            kinds += ("final_exp_bn",)
        log("fexp_kernels_vs_plain", curve=curve, L=be.fp.L, lanes=N_LANES_CHECK,
            inv_bits=len(inv), x_bits=len(xb), pow_bits=len(pow_bits), equal=True,
            blocks={k: pc.fexp_shape(kcfg, k, N_LANES_CHECK) for k in kinds},
            add_step_block=pc.add_shape(cfg, N_LANES_CHECK))

    # the same kernels at phase 9's shapes, timed beside their plain versions:
    # BLS12-381 at 4,096 lanes (miller_ft, final_exp), BN254 at 1,024
    # (add_step).  fp_pow is timed at its path's shape in phase 11, f12_pow at
    # its path's (TowerCtx.f12_pow_bits) in phase 17
    bls, bn = get_spec("BLS12_381"), get_spec("BN254")
    be_bls, be_bn = BatchEngine(bls, dev), BatchEngine(bn, dev)
    args_bls = be_bls._pair_split_mont(be_bls._encode_pairs(*random_pairs(get_engine(bls), bls, N_BATCH)))
    args_bn = be_bn._pair_split_mont(be_bn._encode_pairs(*random_pairs(get_engine(bn), bn, N_BATCH_BN)))
    c_bls, k_bls, c_bn, k_bn = be_bls.pair.cfg, be_bls.tw.kcfg, be_bn.pair.cfg, be_bn.tw.kcfg
    f_bls = pc.miller_ft(c_bls, *args_bls)[0]
    f_bn, T_bn = pc.miller_ft(c_bn, *args_bn)
    xP_bn, yP_bn, Qx_bn, Qy_bn = args_bn
    n_bn = mults_per_step(k_bn.tower.n, bn.twist)

    def joined(fn):
        """The (f, T) pair of a kernel as one (18 * L, lanes) tensor."""
        return lambda *a: torch.cat([x.reshape(-1, x.shape[-1]) for x in fn(*a)])

    Lx, Lb = be_bls.fp.L, be_bn.fp.L
    row = 4  # bytes per limb word
    shapes = {  # name: (what, kernel, plain, bytes, field products, L)
        "miller_ft": (
            f"{N_BATCH} lanes",
            lambda: joined(lambda *a: pc.miller_ft(c_bls, *a))(*args_bls),
            lambda: chunked(joined(lambda *a: pc.miller_ft_plain(c_bls, *a)), N_BATCH, *args_bls,
                            step=PLAIN_PAIR_CHUNK),
            (6 + 12 + 6) * Lx * row * N_BATCH, miller_fp_muls(c_bls, N_BATCH), Lx),
        "final_exp": (
            f"{N_BATCH} lanes",
            lambda: pc.final_exp(k_bls, f_bls),
            lambda: chunked(lambda a: pc.final_exp_plain(k_bls, a, k_bls.inv_bits, k_bls.x_bits,
                                                         bls.x < 0),
                            N_BATCH, f_bls, step=PLAIN_PAIR_CHUNK),
            2 * 12 * Lx * row * N_BATCH,
            N_BATCH * final_exp_mults(k_bls.tower.n, bls.twist, k_bls.inv_bits, k_bls.x_bits), Lx),
        "add_step": (
            f"{N_BATCH_BN} lanes",
            lambda: joined(lambda: pc.add_step(c_bn, f_bn, T_bn, Qx_bn, Qy_bn, xP_bn, yP_bn))(),
            lambda: joined(lambda: pc.add_step_plain(c_bn, f_bn, T_bn, Qx_bn, Qy_bn, xP_bn, yP_bn))(),
            (12 + 6 + 4 + 2 + 12 + 6) * Lb * row * N_BATCH_BN,
            N_BATCH_BN * (n_bn["add_step"] + n_bn["f12_sparse_mul"]), Lb),
    }
    for name, (what, kern, plain, nbytes, fp_muls, limbs) in shapes.items():
        ms, got = cuda_ms(kern, reps=3)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name, got, want)
        if name == "final_exp":
            fexp_want = want
        del got, want
        b = bound(nbytes, wide_mads(fp_muls, limbs))
        results[name].update(ms=ms, plain_ms=plain_ms, **b)
        block = {"final_exp": lambda: pc.fexp_shape(k_bls, name, N_BATCH),
                 "add_step": lambda: pc.add_shape(c_bn, N_BATCH_BN)}.get(name)
        log("time", kernel=name, shape=repr(what), equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"], fp_muls=fp_muls,
            **({"block": block()} if block else {}))
    # final_exp at the strategies' lane counts, which take other blocks (1,024
    # under GROUP_FEXP=device, 1 under split): the first lanes of the 4,096,
    # against the plain version's (lanes are independent)
    for lanes in (N_CHECKS, 1):
        f_l = f_bls[..., :lanes].contiguous()
        ms, got = cuda_ms(lambda: pc.final_exp(k_bls, f_l), reps=3)
        check("final_exp", got, fexp_want[..., :lanes])
        b = bound(2 * 12 * Lx * row * lanes, wide_mads(
            lanes * final_exp_mults(k_bls.tower.n, bls.twist, k_bls.inv_bits, k_bls.x_bits), Lx))
        log("time", kernel="final_exp", shape=repr(f"{lanes} lanes"), equal=True,
            block=pc.fexp_shape(k_bls, "final_exp", lanes), ms=f"{ms:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
    # BN254's whole final exp (one final_exp launch) at pairing_batch's 1,024
    # lanes, on its Miller values (f_bn), against the plain version
    ms, got = cuda_ms(lambda: pc.final_exp(k_bn, f_bn), reps=3)
    plain_ms, want = cuda_ms(
        lambda: pc.final_exp_bn_plain(k_bn, f_bn, k_bn.inv_bits, k_bn.digit_bits), reps=1)
    check("final_exp", got, want)
    b = bound(2 * 12 * Lb * row * N_BATCH_BN, wide_mads(N_BATCH_BN * final_exp_bn_mults(
        k_bn.tower.n, bn.twist, k_bn.inv_bits, k_bn.digit_bits), Lb))
    log("time", kernel="final_exp", curve="BN254", shape=repr(f"{N_BATCH_BN} lanes"), equal=True,
        block=pc.fexp_shape(k_bn, "final_exp_bn", N_BATCH_BN), ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.2f}", bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
    del f_bls, f_bn, T_bn, args_bls, args_bn, fexp_want, got, want, f_l

    # ---- 9. pairing_batch at full width through BatchEngine, then the two
    # opt-in device final-exp strategies beside their defaults
    runs = {}
    for spec, n in ((bls, N_BATCH), (bn, N_BATCH_BN)):
        eng = get_engine(spec)
        nrand = n - 2 * N_BILIN if spec is bls else n
        g1s, g2s = random_pairs(eng, spec, nrand)
        if spec is bls:  # bilinearity: e(a g1, g2) == e(g1, a g2)
            for a in scalars(spec, N_BILIN):
                g1s += [eng.g1.mul(eng.gen_g1, a), eng.gen_g1]
                g2s += [eng.gen_g2, eng.g2.mul(eng.gen_g2, a)]
        runs[spec.name] = (eng, BatchEngine(spec, dev), g1s, g2s, nrand)
    be_a, (g1a, g2a), (bad_g1a, _), (g1b, g2b) = (checks["be"], checks["a"], checks["a_bad"],
                                                   checks["b"])

    # each curve's pairing_batch runs count their own launches: the counts
    # are set to 0 just before them and read just after
    want_kernels = {"BLS12_381": ("mont_mul", "miller_ft", "final_exp"),
                    "BN254": ("mont_mul", "miller_ft", "add_step", "final_exp")}
    out, batch_launches = {}, {}
    for name, (eng, be, g1s, g2s, nrand) in runs.items():
        for mod in (fp_cuda, pc):
            mod.reset_launches()
        out[name], secs = best_of_3(lambda: be.pairing_batch(g1s, g2s))
        counts = {k: v for k, v in {**fp_cuda.launches(), **pc.launches()}.items() if v}
        missing = [k for k in want_kernels[name] if k not in counts]
        if missing:
            raise AssertionError(f"kernels not launched by pairing_batch on {name}: {missing}")
        # one final_exp a call (BN254: its whole final exp, no fp_pow or f12_pow)
        if counts["final_exp"] != 4 or "fp_pow" in counts or "f12_pow" in counts:
            raise AssertionError(f"pairing_batch on {name}: not one final_exp a call: {counts}")
        for k, v in counts.items():
            batch_launches[k] = batch_launches.get(k, 0) + v
        sample = [int(i) for i in rng.choice(nrand, N_SAMPLED, replace=False)]
        if any(out[name][i] != eng.pairing(g1s[i], g2s[i]) for i in sample):
            raise AssertionError(f"pairing_batch on {name} differs from the host engine's pairing")
        bilin = all(out[name][nrand + 2 * i] == out[name][nrand + 2 * i + 1]
                    for i in range((len(g1s) - nrand) // 2))
        if not bilin or (name == "BLS12_381" and out[name][nrand] != eng.pairing(g1s[nrand], g2s[nrand])):
            raise AssertionError(f"pairing_batch on {name} is not bilinear")
        log("pairing_batch", curve=name, pairs=len(g1s), sampled_equal_host=N_SAMPLED,
            bilinear_pairs=(len(g1s) - nrand) // 2, seconds=[round(x, 4) for x in secs],
            pairings_per_s=f"{len(g1s) / min(secs):.1f}", card=repr(smi))
        log("pairing_batch_launches", curve=name, calls=4, **counts)

    # the strategies, their launches counted apart from pairing_batch's
    for mod in (fp_cuda, pc):
        mod.reset_launches()
    default_s = checks["seconds"]
    strat = {}
    try:
        os.environ["MATHLIB_PAIR_FUSED"] = "split"
        if be_a.pairing_product_is_one(*checks["a_bad"]) is not False:
            raise AssertionError("split: the check with one scalar changed did not fail")
        _, strat["split"] = best_of_3(lambda: be_a.pairing_product_is_one(g1a, g2a), True)
        del os.environ["MATHLIB_PAIR_FUSED"]
        os.environ["MATHLIB_GROUP_FEXP"] = "device"
        _, strat["group_device"] = best_of_3(lambda: be_a.pairing_products_are_one(g1b, g2b, 2),
                                             checks["b_verdicts"])
    finally:
        os.environ.pop("MATHLIB_PAIR_FUSED", None)
        os.environ.pop("MATHLIB_GROUP_FEXP", None)
    strat_launches = {k: v for k, v in {**fp_cuda.launches(), **pc.launches()}.items() if v}
    missing = [k for k in ("mont_mul", "miller_lanes", "f12_seg_product", "final_exp")
               if k not in strat_launches]
    if missing:
        raise AssertionError(f"kernels not launched by the device final-exp strategies: {missing}")
    log("strategy", name="MATHLIB_PAIR_FUSED=split", pairs=len(g1a), verdicts_equal_default=True,
        seconds=[round(x, 4) for x in strat["split"]],
        default_seconds=[round(x, 4) for x in default_s["a"]])
    log("strategy", name="MATHLIB_GROUP_FEXP=device", checks=len(g1b) // 2,
        verdicts_equal_default=True, seconds=[round(x, 4) for x in strat["group_device"]],
        default_seconds=[round(x, 4) for x in default_s["b"]])
    log("strategy_launches", split_calls=5, group_calls=4, **strat_launches)

    # stages of one more pairing_batch call per curve
    for name, (eng, be, g1s, g2s, _) in runs.items():
        vals, stages = batch_stages(be, g1s, g2s)
        if vals != out[name]:
            raise AssertionError("the stage run of pairing_batch differs")
        log("pairing_batch_stages", curve=name, **stages)
    return {k: batch_launches[k] for k in set(sum(want_kernels.values(), ()))}


def batch_stages(be, g1s, g2s):
    """(values, stages) of one ``pairing_batch`` call split into its stages:
    host encode, the device ms of the Montgomery entry, the Miller loop and
    the final exp by CUDA events, the device wall to the copy back, and the
    host decode (host clock, synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = be._encode_pairs(g1s, g2s)
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    split = be._pair_split_mont(packed)
    ev[1].record()
    f = be.pair.miller_loop(*split)
    ev[2].record()
    f = be.pair.final_exp(f)
    ev[3].record()
    f = f.cpu()
    t2 = time.perf_counter()
    vals = be.tw.f12_decode(f)
    t3 = time.perf_counter()
    return vals, {"encode_host_s": f"{t1 - t0:.4f}",
                  "to_mont_device_ms": f"{ev[0].elapsed_time(ev[1]):.4f}",
                  "miller_device_ms": f"{ev[1].elapsed_time(ev[2]):.4f}",
                  "final_exp_device_ms": f"{ev[2].elapsed_time(ev[3]):.4f}",
                  "device_wall_s": f"{t2 - t1:.4f}", "decode_host_s": f"{t3 - t2:.4f}"}


def g1_option_phases(dev, smi: str, results: dict, main: dict) -> dict:
    """Phases 10 and 11; fills ``results`` for the kernels of the G1 MSM
    options and returns their launch counts: dbladd's over phase 10's
    ladder, the three combiners' summed over phase 11's entry points."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops import msm as M
    from mathlib_tpu_torch.ops.g1 import G1Ctx, get_g1_ctx
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g1_cuda, gather_cuda, pairing_cuda

    rng = np.random.default_rng(2)
    g1, eng, spec = main["g1"], main["eng"], main["spec"]
    t_phase = time.perf_counter()

    def check(name, got, want):
        check_equal(results, name, got, want)

    def reset():
        for mod in (g1_cuda, fp_cuda, pairing_cuda, gather_cuda):
            mod.reset_launches()

    def counts():
        return {k: v for k, v in {**g1_cuda.launches(), **fp_cuda.launches(),
                                  **gather_cuda.launches()}.items() if v}

    # ---- 10. the four kernels against their plain versions (exact): phase
    # 3's 4,097 lanes on BLS12-381, the same construction on BN254
    def edge_inputs(g, e, sp):
        pool = [e.g1.mul(e.gen_g1, int.from_bytes(rng.bytes(32), "big") % sp.r) for _ in range(257)]
        n = N_CHECK
        A = [pool[i] for i in rng.integers(0, len(pool), n)]
        B = [pool[i] for i in rng.integers(0, len(pool), n)]
        for i in range(0, n, 7):
            A[i] = B[i]  # P == lift(Q)
        for i in range(3, n, 17):
            A[i] = e.g1.neg(B[i])  # P == -lift(Q)
        for i in range(5, n, 11):
            A[i] = None
        P = g.add(g.encode_points(A), g.encode_points(B))  # relaxed [0, 2p)
        return P, g.encode_points(B), g.encode_points_affine(B)

    sel = torch.from_numpy(rng.random(N_CHECK) < 15 / 16).to(dev)
    neg = torch.from_numpy(rng.random(N_CHECK) < 0.5).to(dev)
    # a 32-lane block of the six-warp combiners that adds nowhere (it stores
    # Q' or lift(Q') without the formula) and one that adds everywhere, neg
    # mixed in both
    sel[32:64], sel[64:96] = False, True
    for curve in ("BLS12_381", "BN254"):
        sp = get_spec(curve)
        g = g1 if curve == spec.name else G1Ctx(sp, dev)
        P, Q, Qa = edge_inputs(g, get_engine(sp), sp)
        F = g.F
        check("dbladd", g1_cuda.dbladd(F, P, Q, sel), g1_cuda.dbladd_plain(F, P, Q, sel))
        # dbladd's own edge lanes: P = inf, Q = inf, Q = 2P and Q = -2P
        Pd, Qd = P.clone(), Q.clone()
        Pd[..., 5::11] = g.inf
        Qd[..., 1::13] = g.inf
        D = g1_cuda.double_plain(F, Pd)
        Qd[..., 2::7] = D[..., 2::7]
        Qd[..., 4::17] = g.neg(D)[..., 4::17]
        check("dbladd", g1_cuda.dbladd(F, Pd, Qd, sel), g1_cuda.dbladd_plain(F, Pd, Qd, sel))
        check("addselneg", g1_cuda.addselneg(F, P, Q, sel, neg),
              g1_cuda.addselneg_plain(F, P, Q, sel, neg))
        check("maddsel", g1_cuda.maddsel(F, P, Qa, sel), g1_cuda.maddsel_plain(F, P, Qa, sel))
        check("maddselneg", g1_cuda.maddselneg(F, P, Qa, sel, neg),
              g1_cuda.maddselneg_plain(F, P, Qa, sel, neg))
        log("option_kernels_vs_plain", curve=curve, L=g.fp.L, lanes=N_CHECK, equal=True)

    # at the path's shapes, timed beside the plain versions (PLAIN_CHUNK-lane
    # slices): the combiners on the W*C lanes of one scan step, dbladd on 2^20
    F = g1.F
    P, Q, Qa = edge_inputs(g1, eng, spec)
    WC = M.n_windows(g1, C) * (N_MAIN // K)
    lanes_b = max(N_MAIN, WC)
    reps = -(-lanes_b // N_CHECK)
    Pb = P.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    Qb = Q.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    Qab = Qa.repeat(1, 1, reps)[..., :WC].contiguous()
    selb = torch.from_numpy(rng.random(lanes_b) < 15 / 16).to(dev)
    negb = torch.from_numpy(rng.random(WC) < 0.5).to(dev)
    # contiguous, as the scan gives them to the combiners (a strided slice
    # would time the wrapper's relayout copy too)
    Pw, Qw, sw = Pb[..., :WC].contiguous(), Qb[..., :WC].contiguous(), selb[:WC]
    Pb, Qb, selb = Pb[..., :N_MAIN], Qb[..., :N_MAIN], selb[:N_MAIN]
    pt = 3 * g1.fp.L * 4  # bytes of a projective point
    af = 2 * g1.fp.L * 4
    n_sel_w, n_sel = int(sw.sum()), int(selb.sum())
    shapes = {  # name: (lanes, kernel, plain, bytes, field products)
        "maddsel": (WC, lambda: g1_cuda.maddsel(F, Pw, Qab, sw),
                    lambda: chunked(lambda a, b, c_: g1_cuda.maddsel_plain(F, a, b, c_), WC,
                                    Pw, Qab, sw),
                    (2 * pt + af + 1) * WC, 11 * n_sel_w),
        "addselneg": (WC, lambda: g1_cuda.addselneg(F, Pw, Qw, sw, negb),
                      lambda: chunked(lambda a, b, c_, d: g1_cuda.addselneg_plain(F, a, b, c_, d),
                                      WC, Pw, Qw, sw, negb),
                      (3 * pt + 2) * WC, 12 * n_sel_w),
        "maddselneg": (WC, lambda: g1_cuda.maddselneg(F, Pw, Qab, sw, negb),
                       lambda: chunked(lambda a, b, c_, d: g1_cuda.maddselneg_plain(F, a, b, c_, d),
                                       WC, Pw, Qab, sw, negb),
                       (2 * pt + af + 2) * WC, 11 * n_sel_w),
        "dbladd": (N_MAIN, lambda: g1_cuda.dbladd(F, Pb, Qb, selb),
                   lambda: chunked(lambda a, b, c_: g1_cuda.dbladd_plain(F, a, b, c_), N_MAIN,
                                   Pb, Qb, selb),
                   (3 * pt + 1) * N_MAIN, 8 * N_MAIN + 12 * n_sel),
    }
    for name, (lanes, kern, plain, nbytes, fp_muls) in shapes.items():
        ms, got = cuda_ms(kern, reps=5)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name, got, want)
        del got, want
        results[name].update(ms=ms, plain_ms=plain_ms, lanes=lanes,
                             **bound(nbytes, wide_mads(fp_muls, g1.fp.L)))
        log("time", kernel=name, lanes=lanes, equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{results[name]['bound_ms']:.4f}", bound_by=results[name]["bound_by"],
            fp_muls=fp_muls)
    # dbladd at the 8,192 lanes of the ladder below, where a lane's chain of
    # layers sets the time
    Pl, Ql, sl = (t[..., :N_BASE].contiguous() for t in (Pb, Qb, selb))
    ms, got = cuda_ms(lambda: g1_cuda.dbladd(F, Pl, Ql, sl), reps=50)
    plain_ms, want = cuda_ms(lambda: g1_cuda.dbladd_plain(F, Pl, Ql, sl), reps=1)
    check("dbladd", got, want)
    b = bound((3 * pt + 1) * N_BASE, wide_mads(8 * N_BASE + 12 * int(sl.sum()), g1.fp.L))
    log("time", kernel="dbladd", design=dbladd_design(build), lanes=N_BASE, equal=True,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"], card=repr(smi))
    del Pb, Qb, Qab, selb, negb, Pw, Qw, sw, Pl, Ql, sl, got, want

    # dbladd on its path: a 64-bit double-and-add ladder through
    # G1Ctx.dbl_add_select, as the reference's XLA scalar_mul runs, against
    # the one-launch ladder of scalar_mul
    base = main["base"]
    ks64 = [int.from_bytes(rng.bytes(8), "big") >> (64 - N_LADDER_BITS) for _ in range(N_BASE)]
    K64 = g1.encode_scalars(ks64)
    reset()
    acc = g1.inf.expand(base.shape)
    for i in range(N_LADDER_BITS - 1, -1, -1):
        acc = g1.dbl_add_select(acc, base, g1_cuda.scalar_bit(K64, i))
    ladder = counts()
    if ladder.get("dbladd", 0) != N_LADDER_BITS:
        raise AssertionError(f"the dbl_add_select ladder did not run on dbladd: {ladder}")
    if not bool(g1.eq(acc, g1.scalar_mul(base, K64)).all()):
        raise AssertionError("the dbl_add_select ladder disagrees with scalar_mul")
    log("dbladd_ladder", lanes=N_BASE, bits=N_LADDER_BITS, equals_scalar_mul=True, **ladder)
    log("phase10", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 11. the entry points at full size
    t_phase = time.perf_counter()
    # fp_pow: g1_scalar_mul's affine exit (batch_inv)
    new_launches = {"dbladd": ladder["dbladd"], "addselneg": 0, "maddsel": 0, "maddselneg": 0,
                    "fp_pow": 0}

    def entry(name, run, want, points, need):
        """One warm-up and 3 timed calls of run(), its launches counted
        apart; every kernel in ``need`` must have launched."""
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out, secs = best_of_3(run, want)
        got = counts()
        missing = [k for k in need if k not in got]
        if missing:
            raise AssertionError(f"{name}: kernels not launched on its path: {missing}")
        for k in new_launches:
            if k != "dbladd":
                new_launches[k] += got.get(k, 0)
        peak = torch.cuda.max_memory_allocated()
        log("entry", name=name, points=points, equals_folded_host_oracle=True,
            seconds=[round(x, 4) for x in secs], points_per_s=f"{points / min(secs):.1f}",
            path_peak_GB=f"{(peak - held) / 1e9:.3f}", card=repr(smi))
        log("entry_launches", name=name, calls=4, **got)
        return secs

    def tiled(base_aff, n, sp, nones):
        """n points tiling the base points, None at ``nones``; scalars mod r;
        the host oracle: the MSM of the scalars folded per base point."""
        pts = [base_aff[i % len(base_aff)] for i in range(n)]
        for i in nones:
            pts[i] = None
        ks = [int.from_bytes(rng.bytes(32), "big") % sp.r for _ in range(n)]
        folded = [0] * len(base_aff)
        for i, (P, k) in enumerate(zip(pts, ks)):
            if P is not None:
                folded[i % len(base_aff)] += k
        return pts, ks, get_engine(sp).g1.msm(base_aff, [f % sp.r for f in folded])

    base_aff = main["base_aff"]
    nones = [int(i) for i in rng.choice(N_BRIDGE, 24, replace=False)]
    pts, ks, want = tiled(base_aff, N_BRIDGE, spec, nones)
    entry("msm_host_bridge BLS12_381", lambda: M.msm_host_bridge(spec, pts, ks), want,
          N_BRIDGE, ("maddsel", "add", "double", "addsel", "mont_mul", "gather_rows_t"))
    # stages of one more bridge call, as msm_host_bridge runs them (host
    # clock, synchronised between stages)
    g = get_g1_ctx(spec)
    n_pad = 1 << (N_BRIDGE - 1).bit_length()
    pad = pts + [None] * (n_pad - N_BRIDGE)
    t0 = time.perf_counter()
    A = g.encode_points_affine(pad)
    S = g.encode_scalars([0 if P is None else k for P, k in zip(pad, ks + [0] * n_pad)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = M.msm(g, A, S, c=M.auto_window(n_pad, g.nbits), glv=M.auto_glv(spec, n_pad))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if g.decode_point(out) != want:
        raise AssertionError("the stage run of the bridge differs")
    log("bridge_stages", n_pad=n_pad, encode_host_s=f"{t1 - t0:.4f}",
        msm_device_s=f"{t2 - t1:.4f}", decode_host_s=f"{time.perf_counter() - t2:.4f}")

    bn = get_spec("BN254")
    g_bn = get_g1_ctx(bn)
    bn_ks = [int.from_bytes(rng.bytes(32), "big") % bn.r for _ in range(N_BASE)]
    bn_base = g_bn.decode_points(g_bn.scalar_mul(g_bn.gen, g_bn.encode_scalars(bn_ks)))
    pts_bn, ks_bn, want_bn = tiled(bn_base, N_BRIDGE_BN, bn, [1, N_BRIDGE_BN // 3, N_BRIDGE_BN - 2])
    entry("msm_host_bridge BN254", lambda: M.msm_host_bridge(bn, pts_bn, ks_bn), want_bn,
          N_BRIDGE_BN, ("maddsel", "add", "double", "addsel", "gather_rows_t"))

    be = BatchEngine(spec, dev)
    pts_c, ks_c, want_c = tiled(base_aff, N_G1_MSM, spec, [7])
    entry("BatchEngine.g1_msm BLS12_381", lambda: be.g1_msm(pts_c, ks_c), want_c, N_G1_MSM,
          ("addsel", "add", "double", "mont_mul", "gather_rows_t"))

    ks_d = [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(N_BASE)]
    ks_d[:2] = [0, spec.r - 1]
    want_d = [eng.g1.mul(P, k) for P, k in zip(base_aff, ks_d)]
    entry("BatchEngine.g1_scalar_mul BLS12_381", lambda: be.g1_scalar_mul(base_aff, ks_d),
          want_d, N_BASE, ("smul", "mont_mul", "fp_pow"))
    # fp_pow at the shape and on the values batch_inv gives it there: one
    # more call with fp_pow's calls recorded, then the kernel (each body)
    # against its plain version on them
    _, seen = record_pow_calls(lambda: be.g1_scalar_mul(base_aff, ks_d))
    if len(seen) != 1:
        raise AssertionError(f"g1_scalar_mul ran fp_pow {len(seen)} times, not once")
    fp_ctx, z, inv_bits = seen[0]
    results["fp_pow"].update(time_fp_pow(fp_cuda, fp_ctx, z, inv_bits, "BLS12-381, batch_inv",
                                         pow_design(build), smi))
    del seen, z

    # (e) phase 5's 2^20 MSM with the options, each equal to phase 5's result
    points, scalars = main["points"], main["scalars"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aff = g1.to_affine_rows(points)
    torch.cuda.synchronize()
    log("to_affine_rows", lanes=N_MAIN, seconds=f"{time.perf_counter() - t0:.4f}")
    runs = {"affine (maddsel)": (aff, {}, "maddsel"),
            "signed (addselneg)": (points, {"signed": True}, "addselneg"),
            "affine signed (maddselneg)": (aff, {"signed": True}, "maddselneg")}
    for name, (pts_e, kw, kern) in runs.items():
        secs = entry(f"msm_totals 2^20 {name}",
                     lambda: M.horner_host(g1, M.msm_totals(g1, pts_e, scalars, c=C, K=K,
                                                            capture="dense", **kw), C),
                     main["result"], N_MAIN, (kern, "add", "double", "gather_rows_t"))
        log("options_vs_unsigned", run=name, seconds_best=f"{min(secs):.4f}",
            unsigned_projective_best=f"{min(main['seconds']):.4f}")
    del aff
    log("phase11", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return new_launches


def _host_hash_none(hasher, u0: int, u1: int):
    """The host oracle of the ``sign="none"`` pipeline: the SSWU maps without
    the sign fix, added on E', mapped through the isogeny, cofactor-cleared."""
    from mathlib_tpu_torch.host.curve import WeierstrassCurve
    from mathlib_tpu_torch.host.hash_to_curve import apply_isogeny

    m, isod = hasher._g1_sswu
    F = hasher.e.fp_ops
    Q = WeierstrassCurve(F, m.A, m.B).add(hasher._sswu_no_sign(m, u0), hasher._sswu_no_sign(m, u1))
    return hasher._clear_cofactor_g1(apply_isogeny(F, isod, Q))


class _OpCount:
    """Counts the aten operators dispatched inside a ``with`` block (one
    CUDA launch each, views aside)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def hash_g1_stages(ctx, msgs, dev, counts=None):
    """One ``hash_to_g1_batch`` word-path call (32-byte messages, HASH_DST)
    in stages: host pack (host clock), the XMD and field embedding on the
    device and the hash_g1 kernel (CUDA events), host decode of every lane,
    then the XMD's aten operators counted in one more run.  Returns the
    ``hash_stages`` line's fields (with ``counts()``' launches, read after
    the decode, if given), the decoded points and the (u0, u1) batches."""
    import torch
    from mathlib_tpu_torch.ops import xmd

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = xmd.to_device_words(xmd.pack_msg_words(msgs, 32), dev)
    tmpl = xmd.b0_template(32, HASH_DST, 128)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    uu = xmd.hash_to_field_device(ctx.fp, xmd.b0_blocks_device(words, tmpl, 32), HASH_DST, 2, 64)
    ev[1].record()
    out = ctx.hash_to_g1(*uu)
    ev[2].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pts = ctx.g1.decode_points(out)
    t3 = time.perf_counter()
    launched = counts() if counts else {}
    with _OpCount() as ops:
        xmd.hash_to_field_device(ctx.fp, xmd.b0_blocks_device(words, tmpl, 32), HASH_DST, 2, 64)
    fields = dict(n=len(msgs), pack_host_s=f"{t1 - t0:.4f}",
                  xmd_embed_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}",
                  hash_g1_device_ms=f"{ev[1].elapsed_time(ev[2]):.4f}",
                  device_wall_s=f"{t2 - t1:.4f}", decode_host_s=f"{t3 - t2:.4f}",
                  xmd_aten_ops=ops.n, **launched)
    return fields, pts, uu


def hash_g2_stages(ctx, msgs, dev, counts=None):
    """One ``hash_to_g2_batch`` word-path call (32-byte messages,
    HASH_G2_DST) in stages: host pack, XMD and embedding on the card, the two
    maps (tower ops on mont_mul and fp_pow, the isogenies, g2_add; their
    aten operators counted), the cofactor clearing (the two static ladders,
    psi, g2_add x2, g2_double), host decode of every lane.  Returns the
    ``g2_hash_stages`` line's fields (with ``counts()``' launches, if given)
    and the decoded points."""
    import torch
    from mathlib_tpu_torch.ops import xmd

    g2 = ctx.g2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = xmd.to_device_words(xmd.pack_msg_words(msgs, 32), dev)
    tmpl = xmd.b0_template(32, HASH_G2_DST, 256)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    es = xmd.hash_to_field_device(ctx.fp, xmd.b0_blocks_device(words, tmpl, 32), HASH_G2_DST,
                                  4, 64)
    ev[1].record()
    with _OpCount() as map_ops:
        x0, y0 = ctx.sswu(torch.stack(es[:2]))
        x1, y1 = ctx.sswu(torch.stack(es[2:]))
        Pm = g2.add(ctx.iso_project(x0, y0), ctx.iso_project(x1, y1))
    ev[2].record()
    out = ctx.clear_cofactor(Pm)
    ev[3].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pts = g2.decode_points(out)
    t3 = time.perf_counter()
    fields = dict(n=len(msgs), pack_host_s=f"{t1 - t0:.4f}",
                  xmd_embed_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}",
                  map_device_ms=f"{ev[1].elapsed_time(ev[2]):.4f}", map_aten_ops=map_ops.n,
                  cofactor_device_ms=f"{ev[2].elapsed_time(ev[3]):.4f}",
                  device_wall_s=f"{t2 - t1:.4f}", decode_host_s=f"{t3 - t2:.4f}",
                  **(counts() if counts else {}))
    return fields, pts


def hash_phases(dev, smi: str, results: dict, main: dict) -> dict:
    """Phases 12 and 13; fills ``results`` for hash_g1 and smul_static and
    returns their launch counts: hash_g1's summed over phase 13's entry
    points (a)-(f), smul_static's over the ``sign="none"`` pipeline (h)."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.curves import isogeny_data
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher
    from mathlib_tpu_torch.ops.hash import get_hash_g1_ctx
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g1_cuda, hash_cuda, pairing_cuda

    rng = np.random.default_rng(3)
    spec, eng = main["spec"], main["eng"]
    ctx = get_hash_g1_ctx(spec, dev)
    g1, p, L = ctx.g1, spec.p, ctx.fp.L
    hasher = get_hasher(spec)
    t_phase = time.perf_counter()

    def check(name, got, want):
        check_equal(results, name, got, want)

    def rand_fp(n):
        return [int.from_bytes(rng.bytes(64), "big") % p for _ in range(n)]

    # ---- 12. hash_g1 and smul_static against their plain versions (exact);
    # hash_g1's ptxas line: no stack, no spill, at most 128 registers
    for entry in static_ptxas(build.BUILD_LOG):
        log("ptxas", kernel="smul_static", design=static_design(build), entry=repr(entry))
    for entry in ptxas_entries(build.BUILD_LOG):
        if entry.startswith("hash_g1"):
            log("ptxas", entry=repr(entry))
        if entry.startswith("hash_g1") and hash_design(build) == "grouped" and (
                int(entry.split(": ")[1].split()[0]) > 128 or not entry.endswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")):
            raise AssertionError(f"hash_g1 over its register budget: {entry}")
    a = (-pow(isogeny_data.G1[spec.name]["Z"], -1, p)) % p  # t2 = 0 <=> u^2 = -1/Z
    r = pow(a, (p + 1) // 4, p)
    if r * r % p != a:
        raise AssertionError("no nonzero u with t2 = 0 on this curve")
    us0 = [0, 1, p - 1, r] + rand_fp(N_HASH_CHECK - 4)
    us1 = [1, 0, 7, p - r] + rand_fp(N_HASH_CHECK - 4)
    u0, u1 = ctx.fp.encode(us0), ctx.fp.encode(us1)
    for sign in hash_cuda.SIGNS:
        # a ragged count first (a partial 16-lane block), then all 1,024
        r0, r1 = u0[..., :N_HASH_RAGGED].contiguous(), u1[..., :N_HASH_RAGGED].contiguous()
        got = hash_cuda.hash_g1(ctx, r0, r1, sign)
        check("hash_g1", got, hash_cuda.hash_g1_plain(ctx, r0, r1, sign))
        got = hash_cuda.hash_g1(ctx, u0, u1, sign)
        check("hash_g1", got, hash_cuda.hash_g1_plain(ctx, u0, u1, sign))
    # the edge lanes, canonically, against the host map ("be": the hasher's
    # BBS sign; the "none" oracle with the sign fixes applied)
    host = g1.decode_points(got[..., :8])
    m = hasher._g1_sswu[0]

    def host_map_be(u):
        x, y = hasher._sswu_no_sign(m, u)
        return (x, (p - y) % p) if ((p - y) % p >= y) != ((p - u) % p >= u) else (x, y)

    from mathlib_tpu_torch.host.curve import WeierstrassCurve
    from mathlib_tpu_torch.host.hash_to_curve import apply_isogeny

    Ep = WeierstrassCurve(hasher.e.fp_ops, m.A, m.B)
    want = [hasher._clear_cofactor_g1(apply_isogeny(hasher.e.fp_ops, hasher._g1_sswu[1],
                                                    Ep.add(host_map_be(x), host_map_be(y))))
            for x, y in zip(us0[:8], us1[:8])]
    if host != want:
        raise AssertionError("hash_g1 (be) disagrees with the host map on the edge lanes")
    log("hash_g1_vs_plain", lanes=[N_HASH_RAGGED, N_HASH_CHECK], signs=list(hash_cuda.SIGNS),
        equal=True, edge_lanes_equal_host=len(host))

    # at the path's 4,096 lanes, timed beside the plain version
    U0, U1 = ctx.fp.encode(rand_fp(N_HASH)), ctx.fp.encode(rand_fp(N_HASH))
    ms, got = cuda_ms(lambda: hash_cuda.hash_g1(ctx, U0, U1, "parity"), reps=3)
    plain_ms, want = cuda_ms(lambda: hash_cuda.hash_g1_plain(ctx, U0, U1, "parity"), reps=1)
    check("hash_g1", got, want)
    fp_muls = hash_g1_fp_muls(ctx, N_HASH)
    results["hash_g1"].update(ms=ms, plain_ms=plain_ms, lanes=N_HASH,
                              **bound(5 * L * 4 * N_HASH, wide_mads(fp_muls, L)))
    log("time", kernel="hash_g1", lanes=N_HASH, equal=True, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
        bound_ms=f"{results['hash_g1']['bound_ms']:.4f}", bound_by=results["hash_g1"]["bound_by"],
        fp_muls=fp_muls, fp_muls_per_lane=fp_muls // N_HASH)

    # smul_static: 4,097 lanes (the hash outputs, relaxed, infinity at two
    # lanes) with h_eff's bits and with one 255-bit static scalar
    Q = torch.cat([got, got[..., :1]], dim=-1).clone()
    Q[..., 5] = g1.inf[..., 0]
    Q[..., N_HASH] = g1.inf[..., 0]
    k255 = int.from_bytes(rng.bytes(32), "big") | (1 << 254)
    k255 &= (1 << 255) - 1
    bits255 = [int(b) for b in bin(k255)[2:]]
    for bits in (ctx.h_bits, bits255):
        check("smul_static", g1_cuda.smul_static(g1.F, Q, bits),
              g1_cuda.smul_static_plain(g1.F, Q, bits))
    log("smul_static_vs_plain", lanes=Q.shape[-1], scalars=["h_eff", "255-bit"], equal=True)
    Qt = Q[..., :N_HASH].contiguous()
    ms, got_s = cuda_ms(lambda: g1_cuda.smul_static(g1.F, Qt, ctx.h_bits), reps=5)
    plain_ms, want_s = cuda_ms(lambda: g1_cuda.smul_static_plain(g1.F, Qt, ctx.h_bits), reps=1)
    check("smul_static", got_s, want_s)
    h = [int(b) for b in ctx.h_bits]
    fp_muls = N_HASH * (8 * len(h) + 12 * sum(h))
    results["smul_static"].update(ms=ms, plain_ms=plain_ms, lanes=N_HASH,
                                  **bound(2 * 3 * L * 4 * N_HASH, wide_mads(fp_muls, L)))
    log("time", kernel="smul_static", lanes=N_HASH, bits=len(h), equal=True, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
        bound_ms=f"{results['smul_static']['bound_ms']:.4f}",
        bound_by=results["smul_static"]["bound_by"], fp_muls=fp_muls)
    del Q, Qt, got, want, got_s, want_s, U0, U1
    log("phase12", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 13. the entry points at full width
    t_phase = time.perf_counter()
    mods = (g1_cuda, fp_cuda, pairing_cuda, hash_cuda)

    def reset():
        for mod in mods:
            mod.reset_launches()

    def counts():
        out = {}
        for mod in mods:
            out.update({k: v for k, v in mod.launches().items() if v})
        return out

    new_launches = {"hash_g1": 0, "smul_static": 0}

    def timed(name, run, same, need, n, unit):
        """A warm-up and 3 host-clock calls of run() (their outputs equal),
        the launch counts set to 0 just before and read just after; every
        kernel in ``need`` must have launched."""
        reset()
        first = run()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not same(out, first):
                raise AssertionError(f"{name}: runs of one call disagree")
        got = counts()
        missing = [k for k in need if k not in got]
        if missing:
            raise AssertionError(f"{name}: kernels not launched on its path: {missing}")
        for k in new_launches:
            new_launches[k] += got.get(k, 0)
        log("hash_entry", name=name, n=n, seconds=[round(x, 4) for x in secs],
            **{f"{unit}_per_s": f"{n / min(secs):.1f}"}, card=repr(smi))
        log("hash_entry_launches", name=name, calls=4, **got)
        return first

    sample = sorted(int(i) for i in rng.choice(N_HASH, N_HASH_SAMPLED, replace=False))
    be = BatchEngine(spec, dev)
    need_hash = ("hash_g1", "mont_mul")
    msgs = {"a": [rng.bytes(32) for _ in range(N_HASH)],
            "b": [rng.bytes(30) for _ in range(N_HASH)],
            "c": [b"msg-%d" % i for i in range(N_HASH)]}
    titles = {"a": "(a) hash_to_g1_batch, 32-byte messages (word path)",
              "b": "(b) hash_to_g1_batch, 30-byte messages (block path)",
              "c": "(c) hash_to_g1_batch, b'msg-%d' (host hash_to_field)"}
    host_a = None
    for key in ("a", "b", "c"):
        ms_ = msgs[key]
        out = timed(titles[key], lambda: be.hash_to_g1_batch(ms_, HASH_DST), torch.equal,
                    need_hash, N_HASH, "hashes")
        want = [hasher.hash_to_g1(ms_[i], HASH_DST) for i in sample]
        if g1.decode_points(out[..., sample]) != want:
            raise AssertionError(f"{titles[key]}: sampled lanes differ from the host hasher")
        host_a = want if key == "a" else host_a
    msgs_d = [b"bbs-%d" % i for i in range(N_HASH)]
    out = timed("(d) hash_to_g1_bbs_batch", lambda: be.hash_to_g1_bbs_batch(msgs_d, HASH_DST),
                torch.equal, need_hash, N_HASH, "hashes")
    if g1.decode_points(out[..., sample]) != [hasher.hash_to_g1_bbs(msgs_d[i], HASH_DST)
                                              for i in sample]:
        raise AssertionError("(d): sampled lanes differ from the host hasher")
    log("hash_sampled", entries="a-d", lanes=N_HASH_SAMPLED, equal_host_hasher=True)

    # stages of one more (a) call: host pack, XMD on the device (PyTorch ops
    # and the embedding's mont_mul), the kernel, host decode of every lane
    ms_a = msgs["a"]
    reset()
    stages, pts, uu = hash_g1_stages(ctx, ms_a, dev, counts)
    if [pts[i] for i in sample] != host_a:
        raise AssertionError("the stage run of (a) differs from the host hasher")
    log("hash_stages", **stages)

    # (e) bls_sign_batch, (f) bls_verify_batch, on (a)'s messages
    sigs = timed("(e) bls_sign_batch", lambda: be.bls_sign_batch(BLS_SK, ms_a, HASH_DST),
                 lambda x, y: x == y, need_hash + ("smul",), N_HASH, "signatures")
    if [sigs[i] for i in sample] != [eng.g1.mul(h, BLS_SK) for h in host_a]:
        raise AssertionError("(e): sampled signatures differ from [sk] of the host hasher")
    pk = eng.g2.mul(eng.gen_g2, BLS_SK)
    bad_sig = list(sigs)
    bad_sig[1] = sigs[2]
    bad_msg = list(ms_a)
    bad_msg[3] = bytes(32)
    verdicts = [be.bls_verify_batch(pk, bad_sig, ms_a, HASH_DST),
                be.bls_verify_batch(pk, sigs, bad_msg, HASH_DST)]
    if verdicts != [False, False]:
        raise AssertionError(f"(f): tampered verifies gave {verdicts}")
    ok = timed("(f) bls_verify_batch", lambda: be.bls_verify_batch(pk, sigs, ms_a, HASH_DST),
               lambda x, y: x == y, need_hash + ("addsel", "add", "double", "miller_lanes",
                                                 "f12_seg_product"), N_HASH, "verifies")
    if ok is not True:
        raise AssertionError("(f): the verify of (e)'s signatures failed")
    log("bls_verdicts", true_on_signed=True, one_signature_replaced=False,
        one_message_changed=False)
    main["bls_verify"] = (be, pk, sigs, ms_a)  # phase 16 (d) verifies them under check

    # (g) BN254, outside the device hash's gate: the host hasher, then the card
    bn = get_spec("BN254")
    eng_bn, hasher_bn = get_engine(bn), get_hasher(bn)
    be_bn = BatchEngine(bn, dev)
    msgs_g = [rng.bytes(32) for _ in range(N_HASH_BN)]
    samp_bn = sorted(int(i) for i in rng.choice(N_HASH_BN, N_HASH_SAMPLED, replace=False))
    sigs_bn = timed("(g) BN254 bls_sign_batch", lambda: be_bn.bls_sign_batch(BLS_SK, msgs_g, HASH_DST),
                    lambda x, y: x == y, ("smul", "mont_mul", "fp_pow"), N_HASH_BN, "signatures")
    if [sigs_bn[i] for i in samp_bn] != [eng_bn.g1.mul(hasher_bn.hash_to_g1(msgs_g[i], HASH_DST),
                                                       BLS_SK) for i in samp_bn]:
        raise AssertionError("(g): sampled BN254 signatures differ from the host")
    pk_bn = eng_bn.g2.mul(eng_bn.gen_g2, BLS_SK)
    bad_bn = list(sigs_bn)
    bad_bn[1] = sigs_bn[2]
    if be_bn.bls_verify_batch(pk_bn, bad_bn, msgs_g, HASH_DST) is not False:
        raise AssertionError("(g): the BN254 verify with one signature replaced passed")
    ok = timed("(g) BN254 bls_verify_batch",
               lambda: be_bn.bls_verify_batch(pk_bn, sigs_bn, msgs_g, HASH_DST),
               lambda x, y: x == y, ("addsel", "add", "double", "miller_lanes", "f12_seg_product"),
               N_HASH_BN, "verifies")
    if ok is not True:
        raise AssertionError("(g): the BN254 verify failed")

    # (h) the sign="none" tensor pipeline on (a)'s field elements: the
    # clear_cofactor ladder on smul_static
    u_ints = [ctx.fp.decode(u[..., sample]) for u in uu]
    out = timed("(h) HashG1Ctx.hash_to_g1 sign=none (tensor pipeline)",
                lambda: ctx.hash_to_g1(uu[0], uu[1], "none"), torch.equal,
                ("smul_static", "fp_pow", "mont_mul", "add"), N_HASH, "hashes")
    if g1.decode_points(out[..., sample]) != [_host_hash_none(hasher, int(x), int(y))
                                              for x, y in zip(*u_ints)]:
        raise AssertionError("(h): sampled lanes differ from the host pipeline")
    log("phase13", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return new_launches


def g2_smul_work(pt: int, s_limbs: int, nbits: int, m: int) -> tuple:
    """Bytes and field products of ``g2_smul`` on m lanes of pt-byte points:
    each point read and written once, the scalars' s_limbs 32-bit words a
    lane read once; 60 field products a bit (a doubling's 24, an add's 36)."""
    return (2 * pt + 4 * s_limbs) * m, 60 * nbits * m


def g2_static_work(pt: int, bits: list, m: int) -> tuple:
    """Bytes and field products of ``g2_smul_static`` on m lanes: each point
    read and written once; a doubling's 24 products every bit, an add's 36
    at each one-bit."""
    return 2 * pt * m, (24 * len(bits) + 36 * sum(bits)) * m


def g2_phases(dev, smi: str, results: dict) -> dict:
    """Phases 14 and 15; fills ``results`` for the six G2 kernels and returns
    their launch counts: g2_add's, g2_double's and g2_smul_static's summed
    over phase 15's hash calls (a)-(c), g2_smul's over (d), g2_addsel's and
    g2_dblsel's over phase 14's drive through ``G2Ctx``."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher
    from mathlib_tpu_torch.ops.hash import get_hash_g2_ctx, hash_to_g2_batch
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g2_cuda

    rng = np.random.default_rng(4)
    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    ctx = get_hash_g2_ctx(spec, dev)
    g2, L = ctx.g2, ctx.fp.L
    F = g2.rows
    r = spec.r
    t_phase = time.perf_counter()

    def check(name, got, want):
        return check_equal(results, name, got, want)

    def rand_k():
        return int.from_bytes(rng.bytes(32), "big") % r

    # ---- 14. the six kernels against their plain versions (exact); the
    # ladders' ptxas lines: no stack, no spill
    for entry in ptxas_entries(build.BUILD_LOG):
        if entry.startswith("g2_"):
            log("ptxas", entry=repr(entry))
    g2_block = g2_ladder_ptxas(build.BUILD_LOG)
    for entry in g2_block:
        regs = int(entry.split(": ")[1].split()[0])
        if regs > 96 or not no_stack_or_spill(entry):
            raise AssertionError(f"G2 block kernel over 96 registers, or with a stack or a "
                                 f"spill: {entry}")
    if len(g2_block) != 12:  # both ladders, add, double, addsel, dblsel, at 16 and 32 lanes
        raise AssertionError(f"the G2 block kernels' ptxas lines are missing: {g2_block}")
    pool = [eng.g2.mul(eng.gen_g2, rand_k()) for _ in range(256)] + [None]
    n = N_CHECK
    A = [pool[i] for i in rng.integers(0, len(pool), n)]
    B = [pool[i] for i in rng.integers(0, len(pool), n)]
    for i in range(0, n, 7):
        B[i] = A[i]  # P == Q
    for i in range(3, n, 17):
        B[i] = eng.g2.neg(A[i]) if A[i] else None  # P == -Q
    for i in range(5, n, 11):
        A[i] = None
    for i in range(6, n, 13):
        B[i] = None
    P, Q = g2.encode_points(A), g2.encode_points(B)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(dev)
    S = check("g2_add", g2_cuda.add(F, P, Q), g2_cuda.add_plain(F, P, Q))  # relaxed outputs
    if g2.decode_points(S[..., :64]) != [eng.g2.add(a, b) for a, b in zip(A[:64], B[:64])]:
        raise AssertionError("g2_add disagrees with the host engine")
    check("g2_double", g2_cuda.double(F, S), g2_cuda.double_plain(F, S))
    check("g2_addsel", g2_cuda.addsel(F, S, Q, sel), g2_cuda.addsel_plain(F, S, Q, sel))
    check("g2_dblsel", g2_cuda.dblsel(F, S, Q, sel), g2_cuda.dblsel_plain(F, S, Q, sel))
    # the selects' own edge lanes: a block that adds nowhere and one that
    # adds everywhere (lanes 32-63, 64-95), in 32-lane blocks (4,097 lanes)
    # and the launcher's 16-lane ones (100); g2_addsel on P, Q (P = Q, P = -Q,
    # infinity) and on S (relaxed limbs), g2_dblsel with Q = 2P and Q = -2P
    Qd = Q.clone()
    D = g2_cuda.double_plain(F, S)
    Qd[..., 2::7] = D[..., 2::7]
    Qd[..., 4::17] = g2.neg(D)[..., 4::17]
    seld = sel.clone()
    seld[32:64], seld[64:96] = False, True
    for m in (n, 100):
        Pm, Sm, Qm, sm = (t[..., :m].contiguous() for t in (P, S, Q, seld))
        for Am in (Pm, Sm):
            check("g2_addsel", g2_cuda.addsel(F, Am, Qm, sm), g2_cuda.addsel_plain(F, Am, Qm, sm))
        Qm = Qd[..., :m].contiguous()
        check("g2_dblsel", g2_cuda.dblsel(F, Sm, Qm, sm), g2_cuda.dblsel_plain(F, Sm, Qm, sm))
    del Qd, D, Pm, Sm, Qm, Am
    # the ladders against the plain version's lanes on 256 lanes and on the
    # first G2_RAGGED of them (a partial block), both in the launcher's
    # 16-lane blocks, and on 88 lanes past 16 an SM (32-lane blocks, a
    # partial last one); lanes 32-63 have k = 0 (a 32-lane block, or two
    # 16-lane ones, that never adds)
    m_big = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + 88
    ks = [0, 1, r - 1] + [rand_k() for _ in range(m_big - 3)]
    ks[32:64] = [0] * 32
    Ks = g2.encode_scalars(ks)
    Sl = S[..., :m_big].clone()
    Sl[..., 3] = g2.inf[..., 0]
    wants = {"g2_smul": g2_cuda.smul_plain(F, Sl, Ks, g2.nbits)}
    for j, bits in enumerate((ctx.x_bits_1, ctx.x_bits_2)):
        wants[f"g2_smul_static{j}"] = g2_cuda.smul_static_plain(F, Sl, bits)
    for m in (N_SMUL, G2_RAGGED, m_big):
        check("g2_smul", g2_cuda.smul(F, Sl[..., :m], Ks[..., :m], g2.nbits),
              wants["g2_smul"][..., :m])
        for j, bits in enumerate((ctx.x_bits_1, ctx.x_bits_2)):
            check("g2_smul_static", g2_cuda.smul_static(F, Sl[..., :m], bits),
                  wants[f"g2_smul_static{j}"][..., :m])
    del wants
    log("g2_kernels_vs_plain", lanes=n, ladder_lanes=[N_SMUL, G2_RAGGED, m_big],
        ladder_blocks=[16, 16, 32], zero_block="32-63", equal=True,
        max_abs_err={k: v["max_abs_err"] for k, v in results.items() if k.startswith("g2_")})

    # at the path's shapes (4,096 lanes: one hash or g2_scalar_mul call),
    # timed beside the plain versions, with their bounds: bytes of int32
    # points in and out, field products counted from the inputs (add 36,
    # double 24, the selects' adds only on selected lanes; the ladders 60 a
    # bit, or 24 a bit and 36 a one-bit)
    reps = -(-N_G2 // n)
    Pt = S.repeat(1, 1, 1, reps)[..., :N_G2].contiguous()
    Qt = Q.repeat(1, 1, 1, reps)[..., :N_G2].contiguous()
    selt = torch.from_numpy(rng.random(N_G2) < 15 / 16).to(dev)
    Kt = g2.encode_scalars([rand_k() for _ in range(N_G2)])
    pt = 3 * 2 * L * 4  # bytes of a projective G2 point
    n_sel = int(selt.sum())
    b1, b2 = ([int(b) for b in bits] for bits in (ctx.x_bits_1, ctx.x_bits_2))
    static_work = [x + y for x, y in zip(g2_static_work(pt, b1, N_G2),
                                         g2_static_work(pt, b2, N_G2))]
    shapes = {  # name: (kernel, plain, bytes, field products)
        "g2_add": (lambda: g2_cuda.add(F, Pt, Qt), lambda: g2_cuda.add_plain(F, Pt, Qt),
                   3 * pt * N_G2, 36 * N_G2),
        "g2_double": (lambda: g2_cuda.double(F, Pt), lambda: g2_cuda.double_plain(F, Pt),
                      2 * pt * N_G2, 24 * N_G2),
        "g2_addsel": (lambda: g2_cuda.addsel(F, Pt, Qt, selt),
                      lambda: g2_cuda.addsel_plain(F, Pt, Qt, selt),
                      (3 * pt + 1) * N_G2, 36 * n_sel),
        "g2_dblsel": (lambda: g2_cuda.dblsel(F, Pt, Qt, selt),
                      lambda: g2_cuda.dblsel_plain(F, Pt, Qt, selt),
                      (3 * pt + 1) * N_G2, 24 * N_G2 + 36 * n_sel),
        "g2_smul": (lambda: g2_cuda.smul(F, Pt, Kt, g2.nbits),
                    lambda: g2_cuda.smul_plain(F, Pt, Kt, g2.nbits),
                    *g2_smul_work(pt, Kt.shape[-2], g2.nbits, N_G2)),
        # both cofactor ladders of one clear_cofactor, |x^2 - x - 1| and |x - 1|
        "g2_smul_static": (lambda: torch.cat([g2_cuda.smul_static(F, Pt, b1),
                                              g2_cuda.smul_static(F, Pt, b2)], dim=-1),
                           lambda: torch.cat([g2_cuda.smul_static_plain(F, Pt, b1),
                                              g2_cuda.smul_static_plain(F, Pt, b2)], dim=-1),
                           *static_work),
    }
    for name, (kern, plain, nbytes, fp_muls) in shapes.items():
        ms, got = cuda_ms(kern, reps=3 if name.startswith("g2_smul") else 50)
        plain_ms, want = cuda_ms(plain, reps=1)
        check(name, got, want)
        del got, want
        results[name].update(ms=ms, plain_ms=plain_ms, lanes=N_G2,
                             **bound(nbytes, wide_mads(fp_muls, L)))
        log("time", kernel=name, lanes=N_G2, equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{results[name]['bound_ms']:.4f}", bound_by=results[name]["bound_by"],
            fp_muls_per_lane=fp_muls / N_G2, card=repr(smi))
    for bits, what in ((b1, "|x^2-x-1|"), (b2, "|x-1|")):
        ms, _ = cuda_ms(lambda: g2_cuda.smul_static(F, Pt, bits), reps=3)
        log("time_static_ladder", scalar=what, bits=len(bits), ones=sum(bits), lanes=N_G2,
            ms=f"{ms:.4f}")

    # g2_addsel and g2_dblsel on their paths (no entry point reaches them by
    # default): G2Ctx.add_select, and a 64-bit ladder of G2Ctx.dbl_add_select
    # held to G2Ctx.scalar_mul, at 4,096 lanes (32-lane blocks) and at 16
    # lanes an SM (the launcher's 16-lane blocks)
    g2_cuda.reset_launches()
    check("g2_addsel", g2.add_select(Pt, Qt, selt), g2_cuda.addsel_plain(F, Pt, Qt, selt))
    ks64 = [int.from_bytes(rng.bytes(8), "big") >> (64 - N_G2_LADDER_BITS) for _ in range(N_G2)]
    K64 = g2.encode_scalars(ks64)
    ladder_lanes = (N_G2, 16 * torch.cuda.get_device_properties(dev).multi_processor_count)
    for m in ladder_lanes:
        q, k64 = Qt[..., :m].contiguous(), K64[..., :m].contiguous()
        acc = g2.inf.expand(q.shape)
        for i in range(N_G2_LADDER_BITS - 1, -1, -1):
            acc = g2.dbl_add_select(acc, q, g2_cuda.scalar_bit(k64, i))
        if not bool(g2.eq(acc, g2.scalar_mul(q, k64)).all()):
            raise AssertionError(f"the G2 dbl_add_select ladder at {m} lanes disagrees with "
                                 "scalar_mul")
    sel_launches = {k: v for k, v in g2_cuda.launches().items() if k in ("g2_addsel", "g2_dblsel")}
    if sel_launches != {"g2_addsel": 1, "g2_dblsel": 2 * N_G2_LADDER_BITS}:
        raise AssertionError(f"G2Ctx did not run on g2_addsel/g2_dblsel: {sel_launches}")
    log("g2_dblsel_ladder", lanes=list(ladder_lanes), block_lanes=[32, 16],
        bits=N_G2_LADDER_BITS, equals_scalar_mul=True, **sel_launches)
    del Pt, Qt, selt, Kt, acc, S, P, Q
    log("phase14", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 15. the entry points at full width
    t_phase = time.perf_counter()
    hasher = get_hasher(spec)
    launches = dict(sel_launches, g2_add=0, g2_double=0, g2_smul=0, g2_smul_static=0)

    def reset():
        g2_cuda.reset_launches()
        fp_cuda.reset_launches()

    def counts():
        return {k: v for k, v in {**g2_cuda.launches(), **fp_cuda.launches()}.items() if v}

    def timed(name, run, same, need, count, unit):
        """A warm-up and 3 host-clock calls of run() (their outputs equal),
        the launch counts set to 0 just before and read just after; every
        kernel in ``need`` must have launched."""
        reset()
        first = run()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not same(out, first):
                raise AssertionError(f"{name}: runs of one call disagree")
        got = counts()
        missing = [k for k in need if k not in got]
        if missing:
            raise AssertionError(f"{name}: kernels not launched on its path: {missing}")
        for k in ("g2_add", "g2_double", "g2_smul", "g2_smul_static"):
            launches[k] += got.get(k, 0)
        log("g2_entry", name=name, n=count, seconds=[round(x, 4) for x in secs],
            **{f"{unit}_per_s": f"{count / min(secs):.1f}"}, card=repr(smi))
        log("g2_entry_launches_per_call", name=name, **{k: v / 4 for k, v in got.items()})
        return first

    sample = sorted(int(i) for i in rng.choice(N_G2, N_G2_SAMPLED, replace=False))
    need_hash = ("g2_add", "g2_double", "g2_smul_static", "mont_mul", "fp_pow")
    msgs = {"a": [rng.bytes(32) for _ in range(N_G2)],
            "b": [rng.bytes(30) for _ in range(N_G2)],
            "c": [b"msg-%d" % i for i in range(N_G2)]}
    titles = {"a": "(a) hash_to_g2_batch, 32-byte messages (word path)",
              "b": "(b) hash_to_g2_batch, 30-byte messages (block path)",
              "c": "(c) hash_to_g2_batch, b'msg-%d' (host hash_to_field)"}
    host_a = None
    for key in ("a", "b", "c"):
        ms_ = msgs[key]
        out = timed(titles[key], lambda: hash_to_g2_batch(spec, ms_, HASH_G2_DST, device=dev),
                    torch.equal, need_hash, N_G2, "hashes")
        if out.shape != (3, 2, L, N_G2):
            raise AssertionError(f"{titles[key]}: shape {tuple(out.shape)}")
        want = [hasher.hash_to_g2(ms_[i], HASH_G2_DST) for i in sample]
        if g2.decode_points(out[..., sample]) != want:
            raise AssertionError(f"{titles[key]}: sampled lanes differ from the host hasher")
        host_a = want if key == "a" else host_a
    log("g2_hash_sampled", entries="a-c", lanes=N_G2_SAMPLED, equal_host_hasher=True)

    # stages of one more (a) call (hash_g2_stages), then fp_pow on the calls
    # of one more: each body against its plain version at the G2 map's shapes
    ms_a = msgs["a"]
    reset()
    stages, pts = hash_g2_stages(ctx, ms_a, dev, counts)
    if [pts[i] for i in sample] != host_a:
        raise AssertionError("the stage run of (a) differs from the host hasher")
    log("g2_hash_stages", **stages)
    _, calls = record_pow_calls(lambda: hash_to_g2_batch(spec, ms_a, HASH_G2_DST, device=dev))
    time_g2_map_pows(fp_cuda, calls, pow_design(build), smi)
    del calls

    # (d) BatchEngine.g2_scalar_mul on 4,096 BLS12-381 lanes: 256 host points
    # tiled, infinity and k = 0 among them
    be = BatchEngine(spec, dev)
    pts_d = [pool[i % 256] for i in range(N_G2)]
    pts_d[3] = None
    ks_d = [rand_k() for _ in range(N_G2)]
    ks_d[5] = 0
    check_lanes = sorted(set(sample) | {3, 5})

    def host_mul(points, scalars, e):
        return [e.g2.mul_any(points[i], scalars[i]) for i in check_lanes]

    got_d = timed("(d) BatchEngine.g2_scalar_mul", lambda: be.g2_scalar_mul(pts_d, ks_d),
                  lambda x, y: x == y, ("g2_smul",), N_G2, "points")
    if [got_d[i] for i in check_lanes] != host_mul(pts_d, ks_d, eng):
        raise AssertionError("(d): sampled lanes differ from the host engine")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Pd, Sd = g2.encode_points(pts_d), g2.encode_scalars(ks_d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    Od = g2.scalar_mul(Pd, Sd)
    ev[1].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    g2.decode_points(Od)
    t3 = time.perf_counter()
    log("g2_smul_stages", n=N_G2, encode_host_s=f"{t1 - t0:.4f}",
        g2_smul_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}", decode_host_s=f"{t3 - t2:.4f}")

    # (e) BN254, outside the kernels' gate: weier over Fp2Adapter on mont_mul
    bn = get_spec("BN254")
    eng_bn = get_engine(bn)
    be_bn = BatchEngine(bn, dev)
    pool_bn = [eng_bn.g2.mul(eng_bn.gen_g2, int.from_bytes(rng.bytes(32), "big") % bn.r)
               for _ in range(64)]
    pts_e = [pool_bn[i % 64] for i in range(N_G2_BN)]
    pts_e[3] = None
    ks_e = [int.from_bytes(rng.bytes(32), "big") % bn.r for _ in range(N_G2_BN)]
    ks_e[5] = 0
    check_lanes = sorted(set(int(i) for i in rng.choice(N_G2_BN, N_G2_SAMPLED, replace=False))
                         | {3, 5})
    got_e = timed("(e) BN254 BatchEngine.g2_scalar_mul", lambda: be_bn.g2_scalar_mul(pts_e, ks_e),
                  lambda x, y: x == y, ("mont_mul",), N_G2_BN, "points")
    if [got_e[i] for i in check_lanes] != host_mul(pts_e, ks_e, eng_bn):
        raise AssertionError("(e): sampled lanes differ from the host engine")
    log("g2_smul_sampled", entries="d-e", equal_host_engine=True)
    log("phase15", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


def gather_check_phase(dev, smi: str, results: dict, main: dict, checks: dict) -> dict:
    """Phase 16; fills ``results`` for gather_rows, gather_rows_t and
    pairing_check and returns the launch counts of gather_rows (its direct
    drive, as tools/profile_stacked.py drives the reference's) and of
    pairing_check (the entry points of (c) and (d))."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, gather_cuda as gc, pairing_cuda as pc

    rng = np.random.default_rng(5)
    t_phase = time.perf_counter()

    def check(name, got, want):
        check_equal(results, name, got, want)

    # ---- (a) the gathers against their plain versions (exact), timed beside
    # them and beside the library calls table[idx] and table[idx].T.contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, n_rows, wr, m in GATHER_SHAPES:
        table = torch.randint(-2**31, 2**31 - 1, (n_rows, wr), dtype=torch.int32, device=dev,
                              generator=gen)
        idx = torch.from_numpy(rng.integers(0, n_rows, m)).to(dev)
        nbytes = 2 * m * wr * 4 + m * idx.element_size()
        b = bound(nbytes, 0)
        for name, kern, plain, library in (
                ("gather_rows", gc.gather_rows, gc.gather_rows_plain, lambda: table[idx]),
                ("gather_rows_t", gc.gather_rows_t, gc.gather_rows_t_plain,
                 lambda: table[idx].T.contiguous())):
            ms, got = cuda_ms(lambda: kern(table, idx), reps=20)
            plain_ms, want = cuda_ms(lambda: plain(table, idx), reps=20)
            library_ms, _ = cuda_ms(library, reps=20)
            check(name, got, want)
            check(name, kern(table, idx.to(torch.int32)), want)
            del got, want
            if label == GATHER_MAIN[name]:
                results[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
            log("time", kernel=name, shape=repr(f"{label}: N={n_rows} Wr={wr} M={m}"), equal=True,
                ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
                GB_per_s=f"{nbytes / ms / 1e6:.1f}")
        del table, idx
    # gather_rows has no caller in the library: driven once at the reference
    # tool's shape, its count set to 0 just before and read just after
    _, n_rows, wr, m = GATHER_SHAPES[-1]
    table = torch.randint(-2**31, 2**31 - 1, (n_rows, wr), dtype=torch.int32, device=dev,
                          generator=gen)
    idx = torch.from_numpy(rng.integers(0, n_rows, m)).to(dev)
    gc.reset_launches()
    rows = gc.gather_rows(table, idx)
    torch.cuda.synchronize()
    launches = {"gather_rows": gc.launches()["gather_rows"]}
    if not torch.equal(rows[:256], table[idx[:256]]):
        raise AssertionError("gather_rows differs from table[idx] on its drive")
    del table, idx, rows

    # ---- (b) pairing_check against its plain version: 64 lanes, n = 61 (3
    # pad lanes holding points), a True set (29 pairs (P_i, Q_i) beside
    # (-P_i, Q_i) and a triple A + B + C = 0 against one G2 point) and a
    # False set (one scalar changed)
    def scalar(spec):
        return int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1

    for curve in ("BLS12_381", "BLS12_377"):
        spec = get_spec(curve)
        eng, be = get_engine(spec), BatchEngine(spec, dev)
        g1s, g2s = [], []
        for _ in range((N_VALID_CHECK - 3) // 2):
            P, Q = eng.g1.mul(eng.gen_g1, scalar(spec)), eng.g2.mul(eng.gen_g2, scalar(spec))
            g1s += [P, eng.g1.neg(P)]
            g2s += [Q, Q]
        A, B = eng.g1.mul(eng.gen_g1, scalar(spec)), eng.g1.mul(eng.gen_g1, scalar(spec))
        G = eng.g2.mul(eng.gen_g2, scalar(spec))
        g1s += [A, B, eng.g1.neg(eng.g1.add(A, B))]
        g2s += [G, G, G]
        pads = [(eng.g1.mul(eng.gen_g1, scalar(spec)), eng.g2.mul(eng.gen_g2, scalar(spec)))
                for _ in range(N_LANES_CHECK - N_VALID_CHECK)]
        bad = list(g1s)
        bad[5] = eng.g1.mul(bad[5], 2)
        for want_ok, g1l in ((True, g1s), (False, bad)):
            packed = be._encode_pairs(g1l + [P for P, _ in pads], g2s + [Q for _, Q in pads])
            xP, yP, Qx, Qy = be._pair_split_mont(packed)
            ok, prod = pc.pairing_check(be.pair.cfg, xP, yP, Qx, Qy, N_VALID_CHECK)
            ok_p, prod_p = pc.pairing_check_plain(be.pair.cfg, xP, yP, Qx, Qy, N_VALID_CHECK)
            if not bool(ok) == bool(ok_p) == want_ok:
                raise AssertionError(f"pairing_check on {curve}: verdict {bool(ok)}, "
                                     f"plain {bool(ok_p)}, want {want_ok}")
            check("pairing_check", prod, prod_p)  # bit for bit: the plain version's tree
        log("pair_check_vs_plain", curve=curve, lanes=N_LANES_CHECK, n=N_VALID_CHECK,
            verdicts_equal=True, products_equal=True,
            block=pc.check_shape(be.pair.cfg, N_LANES_CHECK),
            fexp_block=(pc.check_prog.FEXP_GROUP, pc.check_prog.FEXP_WORKERS))
    # 1, 2 and 257 lanes on BLS12-381: (P_i, Q_i) beside (-P_i, Q_i), a
    # random pair on an odd lane (False where it is real), its block and
    # its tree's shape
    spec = get_spec("BLS12_381")
    eng, be = get_engine(spec), BatchEngine(spec, dev)
    cfg = be.pair.cfg
    for lanes, n in CHECK_LANES:
        g1s, g2s = [], []
        for _ in range(lanes // 2):
            P, Q = eng.g1.mul(eng.gen_g1, scalar(spec)), eng.g2.mul(eng.gen_g2, scalar(spec))
            g1s += [P, eng.g1.neg(P)]
            g2s += [Q, Q]
        if lanes % 2:
            g1s.append(eng.g1.mul(eng.gen_g1, scalar(spec)))
            g2s.append(eng.g2.mul(eng.gen_g2, scalar(spec)))
        want_ok = n % 2 == 0
        xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
        pc.reset_launches()
        ok, prod = pc.pairing_check(cfg, xP, yP, Qx, Qy, n)
        if pc.launches()["pairing_check"] != 1:
            raise AssertionError("pairing_check: not one launch a call")
        ok_p, prod_p = pc.pairing_check_plain(cfg, xP, yP, Qx, Qy, n)
        if not bool(ok) == bool(ok_p) == want_ok:
            raise AssertionError(f"pairing_check at {lanes} lanes: verdict {bool(ok)}, "
                                 f"plain {bool(ok_p)}, want {want_ok}")
        check("pairing_check", prod, prod_p)
        pl = pc.check_prog.plan(lanes, n, pc.check_shape(cfg, lanes)[0])
        log("pair_check_vs_plain", curve="BLS12_381", lanes=lanes, n=n, verdict=want_ok,
            verdicts_equal=True, products_equal=True, block=pc.check_shape(cfg, lanes),
            blocks=pl.blocks, block_levels=pl.block_levels, rounds=list(pl.rounds),
            fexp_block=(pc.check_prog.FEXP_GROUP, pc.check_prog.FEXP_WORKERS))
    for entry in check_ptxas(build.BUILD_LOG):
        log("ptxas", kernel="pairing_check", design=check_design(build), entry=repr(entry))
        if check_design(build) == "split" and not no_stack_or_spill(entry):
            raise AssertionError(f"pairing_check: a stack or a spill: {entry}")

    # ---- (c) phase 7's 4,096-pair check and its twin under
    # MATHLIB_PAIR_FUSED=check through BatchEngine, beside the default and split
    be = checks["be"]
    (g1a, g2a), (bad_g1a, _) = checks["a"], checks["a_bad"]
    secs, per_call = {}, None
    try:
        for strat in ("default", "split", "check"):
            if strat == "default":
                os.environ.pop("MATHLIB_PAIR_FUSED", None)
            else:
                os.environ["MATHLIB_PAIR_FUSED"] = strat
            if be.pairing_product_is_one(bad_g1a, g2a) is not False:
                raise AssertionError(f"{strat}: the twin with one scalar changed did not fail")
            pc.reset_launches()
            _, secs[strat] = best_of_3(lambda: be.pairing_product_is_one(g1a, g2a), True)
            if strat == "check":
                per_call = {k: v for k, v in pc.launches().items() if v}
                if per_call != {"pairing_check": 4}:  # a warm-up and 3 timed calls
                    raise AssertionError(f"check: pairing kernels per 4 calls {per_call}")
                launches["pairing_check"] = per_call["pairing_check"]
    finally:
        os.environ.pop("MATHLIB_PAIR_FUSED", None)
    log("strategy", name="MATHLIB_PAIR_FUSED=check", pairs=len(g1a),
        verdicts_equal_default_and_split=True, launches_per_call={"pairing_check": 1},
        seconds=[round(x, 4) for x in secs["check"]],
        split_seconds=[round(x, 4) for x in secs["split"]],
        default_seconds=[round(x, 4) for x in secs["default"]],
        pairings_per_s=f"{len(g1a) / min(secs['check']):.1f}", card=repr(smi))

    # the kernel at phase 7's 4,096 lanes, beside its plain version (one run:
    # the plain Miller loops and final exp take tens of seconds) and its bound
    cfg, L = be.pair.cfg, be.fp.L
    xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1a, g2a))
    ms, (ok, prod) = cuda_ms(lambda: pc.pairing_check(cfg, xP, yP, Qx, Qy, N_PAIRS), reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok_p, prod_p = pc.pairing_check_plain(cfg, xP, yP, Qx, Qy, N_PAIRS)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not bool(ok) == bool(ok_p) is True:
        raise AssertionError("pairing_check at 4,096 lanes: not True")
    check("pairing_check", prod, prod_p)
    from mathlib_tpu_torch.ops.kernels.tower_rows import final_exp_mults

    tw = cfg.tower
    fp_muls = (miller_fp_muls(cfg, N_PAIRS) + seg_product_fp_muls(cfg, N_PAIRS, N_PAIRS)
               + final_exp_mults(tw.n, tw.twist, cfg.tc.inv_bits, cfg.tc.x_bits))
    b = bound(6 * L * 4 * N_PAIRS + (12 * L + 1) * 4, wide_mads(fp_muls, L))
    results["pairing_check"].update(ms=ms, plain_ms=plain_ms, **b)
    log("time", kernel="pairing_check", shape=repr(f"{N_PAIRS} lanes"), equal=True,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
        split_kernels_ms="see phase 6 (miller_lanes, f12_seg_product) and 8 (final_exp)")
    del xP, yP, Qx, Qy

    # ---- (d) bls_verify_batch on phase 13 (f)'s 4,096 messages under check
    be13, pk, sigs, msgs = main["bls_verify"]
    bad_sig = list(sigs)
    bad_sig[1] = sigs[0]
    try:
        os.environ["MATHLIB_PAIR_FUSED"] = "check"
        pc.reset_launches()
        fp_cuda.reset_launches()
        if be13.bls_verify_batch(pk, bad_sig, msgs, HASH_DST) is not False:
            raise AssertionError("(d): the verify with one signature replaced did not fail")
        _, vsecs = best_of_3(lambda: be13.bls_verify_batch(pk, sigs, msgs, HASH_DST), True)
        per = {k: v for k, v in pc.launches().items() if v}
    finally:
        os.environ.pop("MATHLIB_PAIR_FUSED", None)
    if per != {"pairing_check": 5}:
        raise AssertionError(f"(d): pairing kernels over 5 verifies {per}")
    launches["pairing_check"] += per["pairing_check"]
    log("bls_verify_check", n=len(msgs), true_on_signed=True, one_signature_replaced=False,
        seconds=[round(x, 4) for x in vsecs], verifies_per_s=f"{len(msgs) / min(vsecs):.1f}",
        launches=per, card=repr(smi))
    log("phase16", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


def api_phase(dev, smi: str, results: dict) -> dict:
    """Phase 17; fills ``results`` for f12_pow at its path's shape and
    returns its launch count on that path (``TowerCtx.f12_pow_bits``)."""
    import numpy as np
    import torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.api import G1, G2, Gt, CurveID, Curves, Zr
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host.engine import HostEngine
    from mathlib_tpu_torch.ops.kernels import fp_cuda, g1_cuda, gather_cuda, pairing_cuda as pc
    from mathlib_tpu_torch.ops.kernels.tower_rows import f12_pow_mults
    from mathlib_tpu_torch.ops.tower import TowerCtx

    rng = np.random.default_rng(17)
    t_phase = time.perf_counter()

    def draw(r, count):
        return [int.from_bytes(rng.bytes(32), "big") % r for _ in range(count)]

    def kernel_counts():
        return {k: v for k, v in {**g1_cuda.launches(), **gather_cuda.launches(),
                                  **fp_cuda.launches()}.items() if v}

    # ---- (a) Curves[...].MultiScalarMul on G1 and Zr objects, n >= 64: the
    # bridge on the card's kernels; N_API_BASE distinct points repeated, a
    # zero scalar and an infinity point among them; the oracle is the host
    # engine's MSM of the scalars folded per distinct point
    for cid, n in ((CurveID.BLS12_381, N_API), (CurveID.BN254, N_API_SMALL),
                   (CurveID.BLS12_377_GURVY, N_API_SMALL)):
        c = Curves[cid]
        spec, eng = c.spec, c.engine
        if c.device.type != "cuda":
            raise AssertionError(f"Curves[{cid.name}] is not on the card: {c.device}")
        base = [eng.g1.mul(eng.gen_g1, k) for k in draw(spec.r, N_API_BASE)]
        ks = draw(spec.r, n)
        ks[3] = 0
        g1s = [G1(base[i % N_API_BASE], cid, c) for i in range(n)]
        g1s[7] = c.NewG1()
        zrs = [c.NewZrFromInt(k) for k in ks]
        folded = [0] * N_API_BASE
        for i, k in enumerate(ks):
            if i != 7:
                folded[i % N_API_BASE] += k
        want = eng.g1.msm(base, [f % spec.r for f in folded])
        for mod in (g1_cuda, gather_cuda, fp_cuda):
            mod.reset_launches()
        _, secs = best_of_3(lambda: c.MultiScalarMul(g1s, zrs).point, want)
        got = kernel_counts()
        missing = [k for k in ("maddsel", "gather_rows_t", "add", "double") if k not in got]
        if missing:
            raise AssertionError(f"MultiScalarMul on {cid.name}: kernels not launched: {missing}")
        log("api_msm", curve=cid.name, n=n, distinct_points=N_API_BASE,
            equals_folded_host_oracle=True, seconds=[round(x, 4) for x in secs],
            points_per_s=f"{n / min(secs):.1f}", card=repr(smi))
        log("api_msm_launches", curve=cid.name, per_call={k: v / 4 for k, v in got.items()})
    f = Curves[CurveID.FP256BN_AMCL]
    try:
        f.MultiScalarMul([f.GenG1] * 64, [f.NewZrFromInt(3)] * 64)
    except ValueError as e:
        log("api_msm_fp256bn", n=64, raises="ValueError", message=repr(str(e)))
    else:
        raise AssertionError("FP256BN MultiScalarMul at n >= 64 did not raise the kernels' error")

    # ---- (b) the codec on the card's curves: the public BLS12-381 generator
    # bytes; G1, G2, Gt and Zr round trips of N_CODEC seeded elements an ID
    # (bytes, compressed, JSON), infinity included; Gt.Exp against the
    # pure-Python host engine
    t0 = time.perf_counter()
    bls = Curves[CurveID.BLS12_381]
    if (bls.GenG1.Compressed(), bls.GenG2.Compressed()) != (G1_GEN_COMPRESSED, G2_GEN_COMPRESSED):
        raise AssertionError("the BLS12-381 generators do not encode to their public bytes")
    for cid in CurveID:
        c = Curves[cid]
        for k in draw(c.spec.r, N_CODEC):
            z = c.NewZrFromInt(k)
            g1, g2, gt = c.GenG1.Mul(z), c.GenG2.Mul(z), c.GenGt.Exp(z)
            backs = [c.NewG1FromBytes(g1.Bytes()), c.NewG1FromCompressed(g1.Compressed()),
                     c.NewG2FromBytes(g2.Bytes()), c.NewG2FromCompressed(g2.Compressed()),
                     c.NewGtFromBytes(gt.Bytes())]
            if any(err is not None for _, err in backs) or not all(
                    v.Equals(w) for (v, _), w in zip(backs, (g1, g1, g2, g2, gt))):
                raise AssertionError(f"{cid.name}: a byte round trip differs")
            if not (Zr.UnmarshalJSON(z.MarshalJSON()).Equals(z)
                    and c.NewZrFromBytes(z.Bytes()).Equals(z)
                    and G1.UnmarshalJSON(g1.MarshalJSON()).Equals(g1)
                    and G2.UnmarshalJSON(g2.MarshalJSON()).Equals(g2)
                    and Gt.UnmarshalJSON(gt.MarshalJSON()).Equals(gt)):
                raise AssertionError(f"{cid.name}: a JSON round trip differs")
        inf1, inf2 = c.NewG1(), c.NewG2()
        if not (c.NewG1FromBytes(inf1.Bytes())[0].IsInfinity()
                and c.NewG1FromCompressed(inf1.Compressed())[0].IsInfinity()
                and c.NewG2FromBytes(inf2.Bytes())[0].point is None):
            raise AssertionError(f"{cid.name}: infinity does not round-trip")
    py = HostEngine(bls.spec)
    for k in draw(bls.spec.r, N_GT_EXP):
        if bls.GenGt.Exp(bls.NewZrFromInt(k)).val != py.gt_exp(bls.GenGt.val, k):
            raise AssertionError("Gt.Exp differs from the host engine's gt_exp")
    log("api_codec", ids=len(CurveID), elements_per_id=N_CODEC, g1_g2_gt_zr_round_trips=True,
        bls12_381_generator_bytes=True, gt_exp_lanes=N_GT_EXP, gt_exp_equals_host=True,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- (c) TowerCtx.f12_pow_bits, the Gt power with one shared exponent:
    # one f12_pow launch (general squaring) on N_POW BLS12-381 lanes with a
    # 255-bit exponent, equal word for word to the plain version, 8 lanes to
    # the host tower's f12_pow; timed beside its plain version and its bound
    spec = get_spec("BLS12_381")
    tw = TowerCtx(spec, dev)
    coeffs = np.array(draw(spec.p, 12 * N_POW), dtype=object).reshape(2, 3, 2, N_POW)
    a = tw.fp.encode(coeffs)
    e = draw(spec.r, 1)[0] | (1 << 254)
    bits_le = np.array([(e >> i) & 1 for i in range(e.bit_length())], dtype=np.uint8)
    msb = np.ascontiguousarray(bits_le[::-1])
    pc.reset_launches()
    got = tw.f12_pow_bits(a, bits_le)  # the path's run: its launches counted alone
    torch.cuda.synchronize()
    path_launches = pc.launches()
    if path_launches.get("f12_pow") != 1 or sum(path_launches.values()) != 1:
        raise AssertionError(f"f12_pow_bits is not one f12_pow launch: {path_launches}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = pc.f12_pow_plain(tw.kcfg, a, msb, False)  # one run: ~10 s of plain ops
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    check_equal(results, "f12_pow", got, want)
    vals = tw.f12_decode(a[..., :N_POW_SAMPLED])
    if tw.f12_decode(got[..., :N_POW_SAMPLED]) != [tw.host.f12_pow(v, e) for v in vals]:
        raise AssertionError("f12_pow_bits differs from the host tower's f12_pow")
    del want
    ms, again = cuda_ms(lambda: tw.f12_pow_bits(a, bits_le), reps=5)
    if not torch.equal(again, got):
        raise AssertionError("f12_pow_bits is not deterministic")
    L = tw.fp.L
    fp_muls = N_POW * f12_pow_mults(tw.kcfg.tower.n, spec.twist, msb, False)
    b = bound(2 * 12 * L * 4 * N_POW, wide_mads(fp_muls, L))
    results["f12_pow"].update(ms=ms, plain_ms=plain_ms, lanes=N_POW, **b)
    log("time", kernel="f12_pow", path="TowerCtx.f12_pow_bits", shape=repr(
        f"{N_POW} lanes, {len(msb)}-bit exponent, cyclo=False"), equal=True,
        host_tower_lanes=N_POW_SAMPLED, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        speedup=f"{plain_ms / ms:.1f}x", bound_ms=f"{b['bound_ms']:.4f}",
        bound_by=b["bound_by"], fp_muls=fp_muls, block=pc.fexp_shape(tw.kcfg, "f12_pow", N_POW),
        launches_per_call=1, card=repr(smi))

    # ---- (d) TowerCtx.f12_pow_scalars (per-lane 255-bit scalars): tower
    # glue over mont_mul, recorded for a later kernel
    a64 = a[..., :N_POW_SCALARS].contiguous()
    ks = draw(spec.r, N_POW_SCALARS)
    S = torch.from_numpy(np.ascontiguousarray(
        np.array([[(k >> (16 * j)) & 0xFFFF for k in ks] for j in range(16)], dtype=np.int32))).to(dev)
    fp_cuda.reset_launches()
    pc.reset_launches()
    ev[0].record()
    out = tw.f12_pow_scalars(a64, S)
    ev[1].record()
    torch.cuda.synchronize()
    scal_launches = {k: v for k, v in {**fp_cuda.launches(), **pc.launches()}.items() if v}
    lanes8 = tw.f12_decode(a64[..., :N_POW_SAMPLED])
    if tw.f12_decode(out[..., :N_POW_SAMPLED]) != [
            tw.host.f12_pow(v, k) for v, k in zip(lanes8, ks)]:
        raise AssertionError("f12_pow_scalars differs from the host tower's f12_pow")
    log("f12_pow_scalars", lanes=N_POW_SCALARS, nbits=spec.r.bit_length(),
        host_tower_lanes=N_POW_SAMPLED, device_ms=f"{ev[0].elapsed_time(ev[1]):.2f}",
        launches=scal_launches, card=repr(smi))

    # ---- (e) the empty calls on the card: no groups, no lanes, no launch
    be = BatchEngine(spec, dev)
    pc.reset_launches()
    try:
        os.environ["MATHLIB_GROUP_FEXP"] = "device"
        verdicts = be.pairing_products_are_one([], [], 2)
    finally:
        os.environ.pop("MATHLIB_GROUP_FEXP", None)
    empty = be.tw.f12_final_exp(be.tw.f12_one[..., :0])
    torch.cuda.synchronize()
    if verdicts != [] or empty.shape != (2, 3, 2, L, 0) or any(pc.launches().values()):
        raise AssertionError(f"the empty calls: {verdicts}, {tuple(empty.shape)}, {pc.launches()}")
    log("api_empty", grouped_checks=verdicts, final_exp_shape=tuple(empty.shape), launches=0)
    log("phase17", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"f12_pow": path_launches["f12_pow"]}


def time_msm(repo: str) -> int:
    """Phase 5's 2^20 MSM alone, with the ``mathlib_tpu_torch`` of the
    checkout at ``repo`` (built there at first use): the same inputs, one
    warm-up and 5 host-clock runs of msm_totals + horner_host, each beside
    the device time of its msm_totals (CUDA events, gaps included); one
    ``[time_msm]`` line; then that checkout's add and addsel kernels timed
    at phase 3's shapes (``time_g1_adds``) with the split kernels' ptxas
    lines, its double at 16, 1 and 2^20 lanes (``time_double``), its signed
    and mixed combiners at phase 10's 262,144 lanes (``time_g1_combiners``),
    its dbladd at 2^20 and 8,192 lanes (``time_dbladd``) and smul_static at
    4,096 lanes with h_eff (``time_smul_static``), phase 11 (e)'s 2^20 MSMs
    with affine points, signed digits and both (one warm-up and 3 runs each,
    each equal to the first line's result; ``[time_msm_option]`` lines) and ``msm_host_bridge`` on 60,000
    BLS12-381 host points (one warm-up and 3 calls, against a host MSM of
    the scalars folded per base point; a ``[time_bridge]`` line).  Run it
    for two checkouts in turns (A, B, B, A) in one call to compare them on
    one card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    repo = os.path.abspath(repo)
    sys.path.insert(0, repo)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.ops import msm as M
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import build

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(repo + os.sep):
        raise RuntimeError(f"mathlib_tpu_torch was not imported from {repo}")
    build.load()
    spec = get_spec("BLS12_381")
    g1 = G1Ctx(spec, mathlib_tpu_torch.device("cuda"))
    rng = np.random.default_rng(0)

    def rand_ints(count):
        return [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(count)]

    base = g1.scalar_mul(g1.gen, g1.encode_scalars(rand_ints(N_BASE)))
    points = base.repeat(1, 1, N_MAIN // N_BASE).contiguous()
    scalars = g1.encode_scalars(rand_ints(N_MAIN))
    walls, device_ms, outs = [], [], []
    for i in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        totals = M.msm_totals(g1, points, scalars, c=C, K=K, capture="dense")
        ev[1].record()
        outs.append(M.horner_host(g1, totals, C))
        torch.cuda.synchronize()
        if i:  # the first run is the warm-up
            walls.append(time.perf_counter() - t0)
            device_ms.append(ev[0].elapsed_time(ev[1]))
    if any(o != outs[0] for o in outs):
        raise AssertionError("time_msm: runs disagree")
    log("time_msm", repo=repr(repo), n=N_MAIN, seconds=[round(x, 4) for x in walls],
        msm_totals_device_ms=[round(x, 3) for x in device_ms],
        points_per_s=f"{N_MAIN / min(walls):.1f}", card=repr(smi_line()))
    # phase 3's add and addsel of this checkout at their main-path shapes
    from mathlib_tpu_torch.ops.kernels import g1_cuda

    for entry in split_ptxas(build.BUILD_LOG):
        log("ptxas_g1_add", repo=repr(repo), entry=repr(entry))
    Q = torch.roll(points, 1, dims=-1).contiguous()
    sel = torch.from_numpy(np.random.default_rng(1).random(N_MAIN) < 15 / 16).to(points.device)
    time_g1_adds(g1_cuda, g1.F, points, Q, sel, split_design(build))
    time_double(g1_cuda, g1.F, points, double_design(build))
    neg = torch.from_numpy(np.random.default_rng(7).random(N_MAIN) < 0.5).to(points.device)
    time_g1_combiners(g1_cuda, g1.F, points, Q, g1.to_affine_rows(Q[..., :COMBINER_LANES]), sel,
                      neg, combiner_design(build))
    time_dbladd(g1_cuda, g1.F, points, Q, sel, dbladd_design(build))
    del Q, sel, neg
    # smul_static, the ladder whose layers dbladd shares, at 4,096 lanes with
    # h_eff (the cofactor clearing of hash_to_g1_batch)
    from mathlib_tpu_torch.ops.hash import get_hash_g1_ctx

    time_smul_static(g1_cuda, g1.F, base[..., :N_HASH].contiguous(),
                     get_hash_g1_ctx(spec, points.device).h_bits, repo, static_design(build),
                     smi_line())

    # phase 11 (e): the 2^20 MSM with affine points, signed digits and both
    aff = g1.to_affine_rows(points)
    for name, (pts_o, kw) in {"affine": (aff, {}), "signed": (points, {"signed": True}),
                              "affine signed": (aff, {"signed": True})}.items():
        walls, device_ms = [], []
        for i in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            totals = M.msm_totals(g1, pts_o, scalars, c=C, K=K, capture="dense", **kw)
            ev[1].record()
            got = M.horner_host(g1, totals, C)
            torch.cuda.synchronize()
            if got != outs[0]:
                raise AssertionError(f"time_msm: the {name} MSM differs from the projective one")
            if i:  # the first run is the warm-up
                walls.append(time.perf_counter() - t0)
                device_ms.append(ev[0].elapsed_time(ev[1]))
        log("time_msm_option", repo=repr(repo), run=repr(name), n=N_MAIN,
            design=combiner_design(build), seconds=[round(x, 4) for x in walls],
            msm_totals_device_ms=[round(x, 3) for x in device_ms],
            points_per_s=f"{N_MAIN / min(walls):.1f}", equals_projective=True)
    del aff

    # msm_host_bridge on 60,000 host points tiling the base points, 24 None
    from mathlib_tpu_torch.host import get_engine

    base_aff = g1.decode_points(base)
    brng = np.random.default_rng(8)
    pts = [base_aff[i % N_BASE] for i in range(N_BRIDGE)]
    for i in brng.choice(N_BRIDGE, 24, replace=False):
        pts[int(i)] = None
    ks = [int.from_bytes(brng.bytes(32), "big") % spec.r for _ in range(N_BRIDGE)]
    folded = [0] * N_BASE
    for i, (P, k) in enumerate(zip(pts, ks)):
        if P is not None:
            folded[i % N_BASE] += k
    want = get_engine(spec).g1.msm(base_aff, [f % spec.r for f in folded])
    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = M.msm_host_bridge(spec, pts, ks)
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError("time_msm: msm_host_bridge disagrees with the folded host oracle")
        if i:
            walls.append(time.perf_counter() - t0)
    log("time_bridge", repo=repr(repo), points=N_BRIDGE, design=combiner_design(build),
        seconds=[round(x, 4) for x in walls], points_per_s=f"{N_BRIDGE / min(walls):.1f}",
        equals_folded_host_oracle=True, card=repr(smi_line()))

    # the ladder at 8,192 lanes and below, BatchEngine.g1_scalar_mul on the
    # 8,192 base points (one warm-up and 3 calls, against the host engine),
    # and mont_mul at its two shapes
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.ops.kernels import fp_cuda

    krng = np.random.default_rng(9)
    k_ints = [int.from_bytes(krng.bytes(32), "big") % spec.r for _ in range(N_BASE)]
    design = smul_design(build)
    time_smul(g1_cuda, g1.F, base, g1.encode_scalars(k_ints), design, g1.nbits)
    be, host = BatchEngine(spec), get_engine(spec)
    want = [host.g1.mul(P, k) for P, k in zip(base_aff, k_ints)]
    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = be.g1_scalar_mul(base_aff, k_ints)
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError("time_msm: g1_scalar_mul disagrees with the host engine")
        if i:
            walls.append(time.perf_counter() - t0)
    log("time_g1_scalar_mul", repo=repr(repo), points=N_BASE, design=design,
        seconds=[round(x, 4) for x in walls], points_per_s=f"{N_BASE / min(walls):.1f}",
        equals_host=True, card=repr(smi_line()))
    time_mont_mul(fp_cuda, g1.fp, mont_design(build))
    for entry in split_ptxas(build.BUILD_LOG) + mont_ptxas(build.BUILD_LOG):
        log("ptxas_ladder_mont", repo=repr(repo), entry=repr(entry))
    return 0


def time_miller_instructions(repo: str, base_cfg) -> None:
    """What one instruction of the split Miller kernels costs: synthetic
    programs (one phase a loop bit, 200 iterations) run by miller_ft on
    4,096 BLS12-381 lanes in 32-lane blocks of 32 workers (the block
    ``miller_shape`` picks there); a
    ``[miller_ins]`` line each, in cycles at the 1.98 GHz boost clock: a
    chain of one worker's instructions (the others idle), an empty phase
    (the barrier), and every worker multiplying at once."""
    import ctypes

    import numpy as np
    import torch
    from mathlib_tpu_torch.ops.kernels import miller_prog as mp, pairing_cuda as pc

    G, K, iters, n = 32, 32, 200, 200
    slots = 42 + K  # the last case stores one product a worker from slot 42 on
    L = base_cfg.fp.L
    lanes = [torch.zeros(s, dtype=torch.int32, device="cuda")
             for s in ((L, N_PAIRS), (L, N_PAIRS), (2, L, N_PAIRS), (2, L, N_PAIRS))]
    I = mp._ins  # noqa: E741

    def one(steps):
        return [[mp.encode(steps)] + [[] for _ in range(K - 1)]]

    chain3 = [x for i in range(n) for x in (I(mp.LD, 40 + i % 2), I(mp.ADD, 42),
                                             I(mp.ST, 41 - i % 2))]
    cases = (
        ("barrier", [[[] for _ in range(K)]] * 20, 20),
        ("nop", one([I(mp.LD, 40)] + [I(mp.NOP)] * n + [I(mp.ST, 41)]), n),
        ("add", one([I(mp.LD, 40)] + [I(mp.ADD, 41)] * n + [I(mp.ST, 42)]), n),
        ("sub", one([I(mp.LD, 40)] + [I(mp.SUB, 41)] * n + [I(mp.ST, 42)]), n),
        ("d=x+y", one(chain3), n),
        ("mul", one([I(mp.LD, 40)] + [I(mp.MUL, 41)] * (n // 4) + [I(mp.ST, 42)]), n // 4),
        ("mul_all_workers", [[mp.encode([I(mp.LD, 40)] + [I(mp.MUL, 41)] * (n // 4)
                                        + [I(mp.ST, 42 + w)]) for w in range(K)]], n // 4),
    )
    bits = np.zeros(iters, np.uint8)
    for name, phases, count in cases:
        prog = mp.Program(phases, slots, 0, [])
        code, ranges = mp.pack([prog, prog, None], K)
        cfg = pc.MillerCfg(base_cfg.tc, bits, False, None)
        if pc.miller_shape(cfg, N_PAIRS) != (G, K):
            raise AssertionError(f"miller_shape no longer picks ({G}, {K}) at {N_PAIRS} lanes")
        meta = (ctypes.c_int32 * 10)(G, K, slots, pc.slot_words(L, G), *ranges)
        cfg._dev[("miller_prog", "cuda:0", G)] = (torch.from_numpy(code).cuda(), meta)
        ms, _ = cuda_ms(lambda: pc.miller_ft(cfg, *lanes), reps=3)
        log("miller_ins", repo=repr(repo), case=name, G=G, K=K,
            cycles_each=f"{ms * 1e-3 / iters / count * 1.98e9:.1f}")


def time_fexp_programs(repo: str, engines: dict) -> None:
    """What the split final-exp kernels' steps cost: f12_pow over 128 zero
    bits (128 squarings) and 128 one bits (128 squarings and multiplies), and
    final_exp with one-bit x-chains (BN254: four one-bit digits), with and
    without the inverse's 250- to 380-odd bits (one bit instead), at 4,096
    and 1,024 BLS12-381 lanes and 1,024 BN254 lanes (the blocks the launcher
    picks there); a ``[fexp_ins]`` line each, ms and cycles at the 1.98 GHz
    boost clock."""
    import numpy as np
    import torch
    from mathlib_tpu_torch.ops.kernels import fexp_prog, pairing_cuda as pc

    one = np.ones(1, np.uint8)
    gen = np.random.default_rng(8)
    for curve, lanes in (("BLS12_381", N_PAIRS), ("BLS12_381", N_CHECKS), ("BN254", N_BATCH_BN)):
        kcfg = engines[curve][1].tw.kcfg
        L = kcfg.fp.L
        vals = np.array([[int.from_bytes(gen.bytes(48), "big") % kcfg.fp.p for _ in range(lanes)]
                         for _ in range(12)], dtype=object)  # random f12 values
        f = kcfg.fp.encode(vals).reshape(2, 3, 2, L, lanes).to("cuda", torch.int32).contiguous()
        cases = [("sqr", lambda: pc.f12_pow(kcfg, f, np.zeros(128, np.uint8), True), 128),
                 ("sqrmul", lambda: pc.f12_pow(kcfg, f, np.ones(128, np.uint8), True), 128)]
        if curve == "BLS12_381":
            cases += [("fexp_fixed", lambda: pc.final_exp(kcfg, f, kcfg.inv_bits, one, False), 1),
                      ("fexp_fixed_no_inverse", lambda: pc.final_exp(kcfg, f, one, one, False),
                       1)]
        elif hasattr(fexp_prog, "BN_PROGRAMS"):  # BN's script with four one-bit digits
            cases += [("fexp_bn_fixed", lambda: pc.final_exp(kcfg, f, digit_bits=[one] * 4), 1),
                      ("fexp_bn_fixed_no_inverse",
                       lambda: pc.final_exp(kcfg, f, one, digit_bits=[one] * 4), 1)]
        for name, run, count in cases:
            ms, _ = cuda_ms(run, reps=5)
            kind = ("final_exp_bn" if name.startswith("fexp_bn") else
                    "final_exp" if name.startswith("fexp") else "f12_pow")
            log("fexp_ins", repo=repr(repo), curve=curve, lanes=lanes,
                block=pc.fexp_shape(kcfg, kind, lanes), case=name, ms_each=f"{ms / count:.5f}",
                cycles_each=f"{ms * 1e-3 / count * 1.98e9:.0f}")


def time_tree(pc, cfg, f, lanes: int, seg: int, repo: str, design: str, smi: str) -> None:
    """The imported checkout's ``f12_seg_product`` on f (``lanes`` lanes)
    with segments of ``seg`` (CUDA events, mean of 5 after a warm-up) and its
    launches a call, beside the bound; a ``[time_pairing]`` line."""
    L = cfg.fp.L
    b = bound(12 * L * 4 * (lanes + lanes // seg),
              wide_mads(seg_product_fp_muls(cfg, lanes, seg), L))
    pc.reset_launches()
    ms, _ = cuda_ms(lambda: pc.f12_seg_product(cfg, f, seg), reps=5)
    log("time_pairing", repo=repr(repo), design=design, kernel="f12_seg_product",
        curve="BLS12_381", lanes=lanes, seg=seg, launches=pc.launches()["f12_seg_product"] // 6,
        ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
        over_bound=f"{ms / b['bound_ms']:.2f}x", card=repr(smi))


# --time-pairing: (curve, lanes) of the Miller kernels' timings: the product
# check and pairing_batch at BLS12-381, the grouped checks, BN254 pairing_batch
TIME_PAIRING_SHAPES = (("BLS12_381", N_PAIRS), ("BLS12_381", 2 * N_CHECKS),
                       ("BN254", N_BATCH_BN))


def time_pairing(repo: str) -> int:
    """The pairing paths alone, with the ``mathlib_tpu_torch`` of the
    checkout at ``repo`` (built there at first use): its miller_lanes and
    miller_ft at TIME_PAIRING_SHAPES (CUDA events, mean of 5 after a
    warm-up) beside their bounds, with its Miller kernels' ptxas lines; its
    final_exp at 4,096 and 1,024 BLS12-381 lanes, BN254's whole
    ``TowerCtx.f12_final_exp`` and ``add_step`` at 1,024 lanes the same way,
    with their launches a call and ptxas lines (``design=``: one-launch or
    eager, split or one-thread); one
    4,096-pair ``pairing_product_is_one`` (best of 5 host-clock runs, the
    device ms of its Montgomery entry and Miller product by CUDA events,
    pairs/s); the 1,024 grouped two-pair checks under
    ``MATHLIB_GROUP_FEXP=device`` (best of 5); and ``pairing_batch`` at
    4,096 BLS12-381 and 1,024 BN254 pairs (best of 3 each); its product
    tree (``f12_seg_product``) at check (a)'s 4,096 lanes and at the grouped
    checks' 2,048 lanes, seg 2, with its launches a call and its ptxas
    lines; the one-launch ``pairing_check`` at 4,096 lanes and at 2 (a
    ``bls_verify_batch`` check) beside the split strategy's three kernels
    on the same inputs (``miller_lanes``, the tree, ``final_exp`` on the
    product), with its launches a call and its ptxas lines.  A
    ``[time_pairing]`` line each (and ``[miller_ins]`` lines for a checkout
    with the split Miller kernels).  Run it for two checkouts in turns (A, B, B, A) in one call
    to compare them on one card."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    repo = os.path.abspath(repo)
    sys.path.insert(0, repo)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, pairing_cuda as pc

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(repo + os.sep):
        raise RuntimeError(f"mathlib_tpu_torch was not imported from {repo}")
    from mathlib_tpu_torch.ops.kernels import tower_rows
    from mathlib_tpu_torch.ops.kernels.tower_rows import final_exp_mults, mults_per_step

    build.load()
    design, fdesign, smi = miller_design(build), fexp_design(build), smi_line()
    bn_design, add_design = bn_fexp_design(build), add_step_design(build)
    for entry in miller_ptxas(build.BUILD_LOG):
        log("ptxas_miller", repo=repr(repo), entry=repr(entry))
    for entry in fexp_ptxas(build.BUILD_LOG):
        log("ptxas_fexp", repo=repr(repo), entry=repr(entry))
    for entry in add_step_ptxas(build.BUILD_LOG):
        log("ptxas_add_step", repo=repr(repo), entry=repr(entry))
    for entry in tree_ptxas(build.BUILD_LOG):
        log("ptxas_tree", repo=repr(repo), entry=repr(entry))
    tdesign = tree_design(build)
    rng = np.random.default_rng(7)
    engines = {}

    def pairs(curve, count):
        spec = get_spec(curve)
        if curve not in engines:
            engines[curve] = (get_engine(spec), BatchEngine(spec, mathlib_tpu_torch.device("cuda")))
        eng, be = engines[curve]
        ks = [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(2 * count)]
        return ([eng.g1.mul(eng.gen_g1, k) for k in ks[:count]],
                [eng.g2.mul(eng.gen_g2, k) for k in ks[count:]])

    for curve, lanes in TIME_PAIRING_SHAPES:
        g1s, g2s = pairs(curve, lanes)
        eng, be = engines[curve]
        cfg, L = be.pair.cfg, be.fp.L
        xP, yP, Qx, Qy = be._pair_split_mont(be._encode_pairs(g1s, g2s))
        for name, run, out_fp in (
                ("miller_lanes", lambda: pc.miller_lanes(cfg, xP, yP, Qx, Qy, lanes), 12),
                ("miller_ft", lambda: pc.miller_ft(cfg, xP, yP, Qx, Qy), 18)):
            ms, _ = cuda_ms(run, reps=5)
            b = bound((6 + out_fp) * L * 4 * lanes, wide_mads(miller_fp_muls(cfg, lanes), L))
            log("time_pairing", repo=repr(repo), design=design, kernel=name, curve=curve,
                lanes=lanes, ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
                over_bound=f"{ms / b['bound_ms']:.2f}x", card=repr(smi))
        # the final-exp kernels on these Miller values: final_exp at 4,096 and
        # 1,024 BLS12-381 lanes (pairing_batch, GROUP_FEXP=device); BN254's
        # whole TowerCtx.f12_final_exp and add_step (f, T after miller_ft) at
        # 1,024 (pairing_batch), with their launches a call
        kcfg = be.tw.kcfg
        tw = kcfg.tower
        f, T = pc.miller_ft(cfg, xP, yP, Qx, Qy)
        if curve == "BN254":
            # a checkout without final_exp_bn_mults gives no bound (the inputs
            # and the bound are the same for both checkouts)
            count = getattr(tower_rows, "final_exp_bn_mults", None)
            per = count and count(tw.n, tw.twist, kcfg.inv_bits, [
                pc.msb_bits(d) for d in hard_digits(be.spec)])
            m = mults_per_step(tw.n, tw.twist)
            runs = [("f12_final_exp", bn_design, lambda: be.tw.f12_final_exp(f), 24, per),
                    ("add_step", add_design, lambda: pc.add_step(cfg, f, T, Qx, Qy, xP, yP),
                     12 + 6 + 4 + 2 + 12 + 6, m["add_step"] + m["f12_sparse_mul"])]
        elif lanes == N_PAIRS:
            per = final_exp_mults(tw.n, tw.twist, kcfg.inv_bits, kcfg.x_bits)
            f_c = f[..., :N_CHECKS].contiguous()
            runs = [("final_exp", fdesign, lambda a=a: pc.final_exp(kcfg, a), 24, per, n)
                    for n, a in ((lanes, f), (N_CHECKS, f_c))]
        else:
            runs = []
        for name, kdesign, run, fp_words, per, *n in runs:
            n = n[0] if n else lanes
            pc.reset_launches()
            fp_cuda.reset_launches()
            ms, _ = cuda_ms(run, reps=5)  # a warm-up and 5 runs
            calls = {k: v // 6 for k, v in {**pc.launches(), **fp_cuda.launches()}.items() if v}
            b = per and bound(fp_words * L * 4 * n, wide_mads(n * per, L))
            log("time_pairing", repo=repr(repo), design=kdesign, kernel=name, curve=curve,
                lanes=n, launches=calls, ms=f"{ms:.4f}",
                **({"bound_ms": f"{b['bound_ms']:.4f}", "over_bound": f"{ms / b['bound_ms']:.2f}x"}
                   if b else {}), card=repr(smi))
        if curve == "BLS12_381":  # the product tree: check (a) at 4,096, (b) at 2,048, seg 2
            time_tree(pc, cfg, f, lanes, lanes if lanes == N_PAIRS else 2, repo, tdesign, smi)

    if design == "split":
        time_miller_instructions(repo, engines["BLS12_381"][1].pair.cfg)
    if fdesign == "split":
        time_fexp_programs(repo, engines)

    # the product check (a): 2,048 pairs (a g1, b g2), each beside (-ab g1, g2)
    eng, be = engines["BLS12_381"]
    spec = be.spec
    ks = [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(N_PAIRS)]
    g1s, g2s = [], []
    for a, b in zip(ks[0::2], ks[1::2]):
        g1s += [eng.g1.mul(eng.gen_g1, a), eng.g1.mul(eng.gen_g1, (-a * b) % spec.r)]
        g2s += [eng.g2.mul(eng.gen_g2, b), eng.gen_g2]
    walls = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = be.pairing_product_is_one(g1s, g2s)
        torch.cuda.synchronize()
        if ok is not True:
            raise AssertionError("time_pairing: the product check did not hold")
        if i:
            walls.append(time.perf_counter() - t0)
    packed = be._encode_pairs(g1s, g2s)
    dev_ms = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        split = be._pair_split_mont(packed)
        ev[1].record()
        be.pair.product_miller(*split)
        ev[2].record()
        torch.cuda.synchronize()
        dev_ms.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    best = min(dev_ms, key=sum)
    log("time_pairing", repo=repr(repo), design=design, call="pairing_product_is_one",
        pairs=N_PAIRS, seconds=[round(x, 4) for x in walls],
        pairs_per_s=f"{N_PAIRS / min(walls):.1f}", device_ms=f"{sum(best):.4f}",
        to_mont_ms=f"{best[0]:.4f}", miller_and_product_ms=f"{best[1]:.4f}")

    # the one-launch check on these pairs at 4,096 lanes and on their first
    # 2 (bls_verify_batch's check), beside the split strategy's three kernels
    # on the same inputs: miller_lanes, the tree over every lane, final_exp
    # on the product (CUDA events, mean of 5 each after a warm-up)
    cdesign = check_design(build)
    for entry in check_ptxas(build.BUILD_LOG):
        log("ptxas_check", repo=repr(repo), design=cdesign, entry=repr(entry))
    cfg, kcfg, L = be.pair.cfg, be.tw.kcfg, be.fp.L
    tw = cfg.tower
    split = be._pair_split_mont(packed)
    for lanes in (N_PAIRS, 2):
        args = [t[..., :lanes].contiguous() for t in split]
        pc.reset_launches()
        ms, (ok, prod) = cuda_ms(lambda: pc.pairing_check(cfg, *args, lanes), reps=5)
        calls = pc.launches()["pairing_check"] // 6
        m_ms, f = cuda_ms(lambda: pc.miller_lanes(cfg, *args, lanes), reps=5)
        t_ms, pr = cuda_ms(lambda: pc.f12_seg_product(cfg, f, lanes), reps=5)
        e_ms, _ = cuda_ms(lambda: pc.final_exp(kcfg, pr), reps=5)
        if not bool(ok) or not torch.equal(pr, prod):
            raise AssertionError(f"time_pairing: pairing_check at {lanes} lanes: verdict "
                                 f"{bool(ok)}, product equal to the split one: "
                                 f"{torch.equal(pr, prod)}")
        fp_muls = (miller_fp_muls(cfg, lanes) + seg_product_fp_muls(cfg, lanes, lanes)
                   + final_exp_mults(tw.n, tw.twist, cfg.tc.inv_bits, cfg.tc.x_bits))
        b = bound(6 * L * 4 * lanes + (12 * L + 1) * 4, wide_mads(fp_muls, L))
        split_ms = m_ms + t_ms + e_ms
        log("time_pairing", repo=repr(repo), design=cdesign, kernel="pairing_check",
            curve="BLS12_381", lanes=lanes, launches=calls, ms=f"{ms:.4f}",
            split_ms=f"{split_ms:.4f}", miller_lanes_ms=f"{m_ms:.4f}", tree_ms=f"{t_ms:.4f}",
            final_exp_ms=f"{e_ms:.4f}", over_split=f"{ms / split_ms:.3f}x",
            bound_ms=f"{b['bound_ms']:.4f}", over_bound=f"{ms / b['bound_ms']:.2f}x",
            card=repr(smi))
    del split, args, f, pr, prod

    # the grouped checks (b) under MATHLIB_GROUP_FEXP=device: 1,024 BLS
    # verifies e(sig, g2) e(-H, pk), every other one corrupted
    v_g1s, v_g2s, verdicts = [], [], []
    for k in range(N_CHECKS):
        sk = ks[k] % (spec.r - 2) + 1
        H = eng.g1.mul(eng.gen_g1, ks[N_CHECKS + k])
        v_g1s += [eng.g1.mul(H, sk + (k % 2)), eng.g1.neg(H)]
        v_g2s += [eng.gen_g2, eng.g2.mul(eng.gen_g2, sk)]
        verdicts.append(k % 2 == 0)
    prev = os.environ.get("MATHLIB_GROUP_FEXP")
    os.environ["MATHLIB_GROUP_FEXP"] = "device"
    try:
        walls = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = be.pairing_products_are_one(v_g1s, v_g2s, 2)
            torch.cuda.synchronize()
            if got != verdicts:
                raise AssertionError("time_pairing: wrong grouped verdicts")
            if i:
                walls.append(time.perf_counter() - t0)
    finally:
        if prev is None:
            os.environ.pop("MATHLIB_GROUP_FEXP")
        else:
            os.environ["MATHLIB_GROUP_FEXP"] = prev
    log("time_pairing", repo=repr(repo), design=design, fexp_design=fdesign,
        call="pairing_products_are_one", group_fexp="device", checks=N_CHECKS, seconds=[round(x, 4) for x in walls],
        checks_per_s=f"{N_CHECKS / min(walls):.1f}")

    # pairing_batch at 4,096 BLS12-381 pairs, 8 lanes held to the host engine
    g1s, g2s = pairs("BLS12_381", N_BATCH)
    out, secs = best_of_3(lambda: be.pairing_batch(g1s, g2s))
    for i in range(N_SAMPLED):
        if out[i] != eng.pairing(g1s[i], g2s[i]):
            raise AssertionError("time_pairing: pairing_batch differs from the host pairing")
    log("time_pairing", repo=repr(repo), design=design, fexp_design=fdesign,
        call="pairing_batch", curve="BLS12_381", pairs=N_BATCH, seconds=[round(x, 4) for x in secs],
        pairings_per_s=f"{N_BATCH / min(secs):.1f}")

    # pairing_batch at 1,024 BN254 pairs (its final exp, add steps), 8 lanes
    # held to the host engine
    eng, be = engines["BN254"]
    g1s, g2s = pairs("BN254", N_BATCH_BN)
    out, secs = best_of_3(lambda: be.pairing_batch(g1s, g2s))
    for i in range(N_SAMPLED):
        if out[i] != eng.pairing(g1s[i], g2s[i]):
            raise AssertionError("time_pairing: BN254 pairing_batch differs from the host pairing")
    log("time_pairing", repo=repr(repo), design=design, fexp_design=bn_design,
        add_step_design=add_design, call="pairing_batch", curve="BN254", pairs=N_BATCH_BN,
        seconds=[round(x, 4) for x in secs], pairings_per_s=f"{N_BATCH_BN / min(secs):.1f}")
    return 0


def time_batch(repo: str) -> int:
    """``pairing_batch`` on 4,096 BLS12-381 pairs alone, with the
    ``mathlib_tpu_torch`` of the checkout at ``repo``: 8 lanes held to the
    host engine, then 3 rounds of a best of 3 host-clock calls and 5 calls
    split into stages (``batch_stages``), a ``[time_batch]`` line each.  Run
    it for two checkouts in turns (A, B, B, A) in one call."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    repo = os.path.abspath(repo)
    sys.path.insert(0, repo)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(repo + os.sep):
        raise RuntimeError(f"mathlib_tpu_torch was not imported from {repo}")
    spec = get_spec("BLS12_381")
    eng, be = get_engine(spec), BatchEngine(spec, mathlib_tpu_torch.device("cuda"))
    rng = np.random.default_rng(7)
    ks = [int.from_bytes(rng.bytes(32), "big") % (spec.r - 1) + 1 for _ in range(2 * N_BATCH)]
    g1s = [eng.g1.mul(eng.gen_g1, k) for k in ks[:N_BATCH]]
    g2s = [eng.g2.mul(eng.gen_g2, k) for k in ks[N_BATCH:]]
    out = be.pairing_batch(g1s, g2s)
    if any(out[i] != eng.pairing(g1s[i], g2s[i]) for i in range(N_SAMPLED)):
        raise AssertionError("time_batch: pairing_batch differs from the host pairing")
    smi = smi_line()
    for r in range(3):
        _, secs = best_of_3(lambda: be.pairing_batch(g1s, g2s), out)
        log("time_batch", repo=repr(repo), round=r, call="pairing_batch", pairs=N_BATCH,
            seconds=[round(x, 4) for x in secs], pairings_per_s=f"{N_BATCH / min(secs):.1f}",
            card=repr(smi))
        for _ in range(5):
            vals, stages = batch_stages(be, g1s, g2s)
            if vals != out:
                raise AssertionError("time_batch: the stage run of pairing_batch differs")
            log("time_batch", repo=repr(repo), round=r, call="stages", **stages)
    return 0


# --time-g2: the lane counts of g2_smul (g2_scalar_mul's 4,096 and two
# smaller calls)


def time_g2(repo: str) -> int:
    """The G2 kernels alone, with the ``mathlib_tpu_torch`` of the checkout at
    ``repo`` (built there at first use): the ptxas lines of its G2 ladder,
    add, doubling, addsel and dblsel kernels and each source's nvcc
    seconds; ``g2_add``, ``g2_double``, ``g2_dblsel`` and ``g2_addsel`` (15/16
    of the lanes selected) at 4,096 lanes and at 16 lanes an SM and one more,
    and ``g2_addsel`` with no lane selected at 4,096 (CUDA events, mean of
    100 after a warm-up, beside their bounds, each output equal to the plain
    version's);
    ``g2_smul`` (255 bits) at 4,096, 2,048 and 1,024 lanes and at 16 lanes
    an SM and one more (where the block ladder turns from 16- to 32-lane
    blocks) and each cofactor ladder (``g2_smul_static``) at 4,096 lanes,
    CUDA events, mean of 5 after a warm-up, beside their bounds
    (``[time_g2]`` lines; every output equal to the plain version's on the
    same lanes); then ``BatchEngine.g2_scalar_mul`` on 4,096
    points (a warm-up and 3 host-clock calls, 64 sampled lanes and the k = 0
    and infinity lanes against the host engine) and one call split into
    stages (``g2_smul_stages``: host encode, device ms, host decode).  Run it
    for two checkouts in turns (A, B, B, A) in one call."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    repo = os.path.abspath(repo)
    sys.path.insert(0, repo)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.ops.hash import get_hash_g2_ctx
    from mathlib_tpu_torch.ops.kernels import build, g2_cuda

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(repo + os.sep):
        raise RuntimeError(f"mathlib_tpu_torch was not imported from {repo}")
    t0 = time.perf_counter()
    lib = build.load()
    log("build", repo=repr(repo), seconds=f"{time.perf_counter() - t0:.1f}",
        nvcc_seconds=build.SECONDS)
    smi = smi_line()
    design = ("block" if _source_has(build, "g2_smul_kernels.cu", "g2_ladder_kernel")
              else "one-thread")
    for entry in g2_ladder_ptxas(build.BUILD_LOG):
        log("ptxas_g2_ladder", repo=repr(repo), design=design,
            step_design=g2_step_design(build), entry=repr(entry))
    dev = mathlib_tpu_torch.device("cuda")
    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    ctx = get_hash_g2_ctx(spec, dev)
    g2, L = ctx.g2, ctx.fp.L
    F = g2.rows
    rng = np.random.default_rng(9)

    def rand_k():
        return int.from_bytes(rng.bytes(32), "big") % spec.r

    pool = [eng.g2.mul(eng.gen_g2, rand_k()) for _ in range(256)]
    pts = [pool[i % 256] for i in range(N_G2)]
    pts[3] = None
    base = g2.encode_points(pts)
    Q = g2_cuda.add_plain(F, base, base.roll(1, -1)).contiguous()  # relaxed limbs
    ks = [rand_k() for _ in range(N_G2)]
    ks[5] = 0
    K = g2.encode_scalars(ks)
    want = g2_cuda.smul_plain(F, Q, K, g2.nbits)
    pt = 3 * 2 * L * 4
    S = K.shape[-2]

    # the add and the doubling at the path's 4,096 lanes and where the
    # launcher's blocks turn from 16 to 32 lanes (16 lanes an SM, and one
    # more), each against its plain version's lanes
    edge = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    sdesign = g2_step_design(build)
    R = base.roll(7, -1).contiguous()
    sel = torch.from_numpy(rng.random(N_G2) < 15 / 16).to(dev)
    want_add, want_dbl = g2_cuda.add_plain(F, Q, R), g2_cuda.double_plain(F, Q)
    want_dblsel, want_addsel = (g2_cuda.dblsel_plain(F, Q, R, sel),
                                g2_cuda.addsel_plain(F, Q, R, sel))
    ddesign, adesign = dblsel_design(build), addsel_design(build)
    for m in (N_G2, edge + 1, edge):
        p_, r_, s_ = Q[..., :m].contiguous(), R[..., :m].contiguous(), sel[:m].contiguous()
        n_sel = int(s_.sum())
        for name, design_m, run, want_m, nbytes, fp_muls in (
                ("g2_add", sdesign, lambda: g2_cuda.add(F, p_, r_), want_add, 3 * pt * m, 36 * m),
                ("g2_double", sdesign, lambda: g2_cuda.double(F, p_), want_dbl, 2 * pt * m,
                 24 * m),
                ("g2_dblsel", ddesign, lambda: g2_cuda.dblsel(F, p_, r_, s_), want_dblsel,
                 (3 * pt + 1) * m, 24 * m + 36 * n_sel),
                ("g2_addsel", adesign, lambda: g2_cuda.addsel(F, p_, r_, s_), want_addsel,
                 (3 * pt + 1) * m, 36 * n_sel)):
            b = bound(nbytes, wide_mads(fp_muls, L))
            ms, got = cuda_ms(run, reps=100)
            if not torch.equal(got, want_m[..., :m]):
                raise AssertionError(f"time_g2: {name} at {m} lanes disagrees with its plain "
                                     "version")
            log("time_g2", repo=repr(repo), design=design_m, kernel=name, lanes=m,
                block_lanes=(16 if m <= edge else 32) if design_m == "block" else None,
                ms=f"{ms:.5f}", bound_ms=f"{b['bound_ms']:.5f}", bound_by=b["bound_by"],
                over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True, card=repr(smi))
    # g2_addsel with no lane selected: every block stores Q and adds nowhere
    none = torch.zeros_like(sel)
    b = bound((3 * pt + 1) * N_G2, 0)
    ms, got = cuda_ms(lambda: g2_cuda.addsel(F, Q, R, none), reps=100)
    if not torch.equal(got, R):
        raise AssertionError("time_g2: g2_addsel with no lane selected is not Q")
    log("time_g2", repo=repr(repo), design=adesign, kernel="g2_addsel", lanes=N_G2, selected=0,
        ms=f"{ms:.5f}", bound_ms=f"{b['bound_ms']:.5f}", bound_by=b["bound_by"],
        over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True, card=repr(smi))
    del want_add, want_dbl, want_dblsel, want_addsel

    def smul_at(m):
        q, k = Q[..., :m].contiguous(), K[..., :m].contiguous()
        nbytes, fp_muls = g2_smul_work(pt, S, g2.nbits, m)
        b = bound(nbytes, wide_mads(fp_muls, L))
        ms, got = cuda_ms(lambda: g2_cuda.smul(F, q, k, g2.nbits), reps=5)
        if not torch.equal(got, want[..., :m]):
            raise AssertionError(f"time_g2: g2_smul at {m} lanes disagrees with its plain version")
        return ms, b

    for m in (N_G2, edge + 1, edge, 2048, 1024):
        ms, b = smul_at(m)
        log("time_g2", repo=repr(repo), design=design, kernel="g2_smul", lanes=m,
            block_lanes=(16 if m <= edge else 32) if design == "block" else None,
            nbits=g2.nbits, ms=f"{ms:.4f}", bound_ms=f"{b['bound_ms']:.4f}",
            bound_by=b["bound_by"], over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True,
            card=repr(smi))
    for bits, what in ((ctx.x_bits_1, "|x^2-x-1|"), (ctx.x_bits_2, "|x-1|")):
        b_ = [int(x) for x in bits]
        nbytes, fp_muls = g2_static_work(pt, b_, N_G2)
        b = bound(nbytes, wide_mads(fp_muls, L))
        ms, got = cuda_ms(lambda: g2_cuda.smul_static(F, Q, b_), reps=5)
        if not torch.equal(got, g2_cuda.smul_static_plain(F, Q, b_)):
            raise AssertionError(f"time_g2: g2_smul_static {what} disagrees with its plain version")
        log("time_g2", repo=repr(repo), design=design, kernel="g2_smul_static", scalar=what,
            bits=len(b_), ones=sum(b_), lanes=N_G2, ms=f"{ms:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
            over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True, card=repr(smi))

    be = BatchEngine(spec, dev)
    check_lanes = sorted(set(int(i) for i in rng.choice(N_G2, N_G2_SAMPLED, replace=False))
                         | {3, 5})
    first = be.g2_scalar_mul(pts, ks)
    if [first[i] for i in check_lanes] != [eng.g2.mul_any(pts[i], ks[i]) for i in check_lanes]:
        raise AssertionError("time_g2: g2_scalar_mul differs from the host engine")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = be.g2_scalar_mul(pts, ks)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if out != first:
            raise AssertionError("time_g2: calls of g2_scalar_mul disagree")
    log("time_g2_scalar_mul", repo=repr(repo), design=design, points=N_G2,
        seconds=[round(x, 4) for x in secs], points_per_s=f"{N_G2 / min(secs):.1f}",
        equals_host=True, card=repr(smi))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Pd, Sd = g2.encode_points(pts), g2.encode_scalars(ks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    Od = g2.scalar_mul(Pd, Sd)
    ev[1].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if g2.decode_points(Od) != first:
        raise AssertionError("time_g2: the stage run of g2_scalar_mul differs")
    t3 = time.perf_counter()
    log("g2_smul_stages", repo=repr(repo), design=design, n=N_G2,
        encode_host_s=f"{t1 - t0:.4f}", g2_smul_device_ms=f"{ev[0].elapsed_time(ev[1]):.4f}",
        decode_host_s=f"{t3 - t2:.4f}", card=repr(smi))
    return 0


def time_hash(repo: str) -> int:
    """The chain kernels on their paths, with the ``mathlib_tpu_torch`` of the
    checkout at ``repo`` (built there at first use): the hash_g1, fp_pow and
    mont_mul kernels' ptxas lines; ``hash_g1`` (parity sign) at 4,096 and
    1,024 lanes beside its bound (``[time_hash_g1]``, each output equal to
    the plain version's); ``BatchEngine.g1_scalar_mul`` on 8,192 points (a
    warm-up and 3 host-clock calls, against the host engine) and fp_pow on
    the values its batch inversion gives it (``time_fp_pow``: each body
    where the checkout has two); ``hash_to_g1_batch`` on 4,096 32-byte
    messages (word path; a warm-up and 3 calls, 64 sampled lanes against the
    host hasher) with its ``hash_stages`` line; ``hash_to_g2_batch`` on 4,096
    32-byte messages, the same way, with its ``g2_hash_stages`` line and
    fp_pow on its first map's four calls; mont_mul at (6, 24, 4,096);
    ``smul_static`` at 4,096 lanes with h_eff (``[time_smul_static]``, its
    ptxas lines ``[ptxas_static]``).  Every
    line carries the card's name and power limit.  Run it for two checkouts
    in turns (A, B, B, A) in one call."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    repo = os.path.abspath(repo)
    sys.path.insert(0, repo)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.batch import BatchEngine
    from mathlib_tpu_torch.host import get_engine
    from mathlib_tpu_torch.host.hash_to_curve import get_hasher
    from mathlib_tpu_torch.ops.hash import get_hash_g1_ctx, get_hash_g2_ctx, hash_to_g2_batch
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g1_cuda, hash_cuda

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(repo + os.sep):
        raise RuntimeError(f"mathlib_tpu_torch was not imported from {repo}")
    build.load()
    smi = smi_line()
    hdesign, pdesign = hash_design(build), pow_design(build)
    for entry in chain_ptxas(build.BUILD_LOG) + mont_ptxas(build.BUILD_LOG):
        log("ptxas_chain", repo=repr(repo), entry=repr(entry))
    dev = mathlib_tpu_torch.device("cuda")
    spec = get_spec("BLS12_381")
    p, eng, hasher = spec.p, get_engine(spec), get_hasher(spec)
    ctx = get_hash_g1_ctx(spec, dev)
    g1, L = ctx.g1, ctx.fp.L
    rng = np.random.default_rng(3)

    def rand_fp(n):
        return [int.from_bytes(rng.bytes(64), "big") % p for _ in range(n)]

    U0, U1 = ctx.fp.encode(rand_fp(N_HASH)), ctx.fp.encode(rand_fp(N_HASH))
    want = hash_cuda.hash_g1_plain(ctx, U0, U1, "parity")
    for m in (N_HASH, N_HASH_CHECK):
        u0, u1 = U0[..., :m].contiguous(), U1[..., :m].contiguous()
        ms, got = cuda_ms(lambda: hash_cuda.hash_g1(ctx, u0, u1, "parity"), reps=5)
        if not torch.equal(got, want[..., :m]):
            raise AssertionError(f"time_hash: hash_g1 at {m} lanes disagrees with its plain version")
        fp_muls = hash_g1_fp_muls(ctx, m)
        b = bound(5 * L * 4 * m, wide_mads(fp_muls, L))
        log("time_hash_g1", repo=repr(repo), design=hdesign, lanes=m, ms=f"{ms:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
            over_bound=f"{ms / b['bound_ms']:.2f}x", equal=True, card=repr(smi))

    # smul_static at the hash's 4,096 lanes with h_eff (the cofactor clearing
    # of sign="none"), its output equal to the plain version's
    sdesign = static_design(build)
    for entry in static_ptxas(build.BUILD_LOG):
        log("ptxas_static", repo=repr(repo), design=sdesign, entry=repr(entry))
    time_smul_static(g1_cuda, g1.F, want, ctx.h_bits, repo, sdesign, smi)
    del U0, U1, want

    def calls(name, run, same, n, unit):
        """A warm-up (its fp_pow calls recorded) and 3 host-clock calls of
        run(), their outputs equal; returns the first output and the calls."""
        first, pows = record_pow_calls(run)
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not same(out, first):
                raise AssertionError(f"time_hash: calls of {name} disagree")
        log("time_hash_entry", repo=repr(repo), name=name, n=n,
            seconds=[round(x, 4) for x in secs], **{f"{unit}_per_s": f"{n / min(secs):.1f}"},
            card=repr(smi))
        return first, pows

    be = BatchEngine(spec, dev)
    base = g1.scalar_mul(g1.gen, g1.encode_scalars(
        [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(N_BASE)]))
    base_aff = g1.decode_points(base)
    ks = [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(N_BASE)]
    got, pows = calls("BatchEngine.g1_scalar_mul", lambda: be.g1_scalar_mul(base_aff, ks),
                      lambda x, y: x == y, N_BASE, "points")
    if got != [eng.g1.mul(P, k) for P, k in zip(base_aff, ks)]:
        raise AssertionError("time_hash: g1_scalar_mul disagrees with the host engine")
    if len(pows) != 1:
        raise AssertionError(f"g1_scalar_mul ran fp_pow {len(pows)} times, not once")
    time_fp_pow(fp_cuda, *pows[0], "BLS12-381, batch_inv", pdesign, smi)
    del pows

    sample = sorted(int(i) for i in rng.choice(N_HASH, N_HASH_SAMPLED, replace=False))
    msgs = [rng.bytes(32) for _ in range(N_HASH)]
    out, _ = calls("hash_to_g1_batch (word path)", lambda: be.hash_to_g1_batch(msgs, HASH_DST),
                   torch.equal, N_HASH, "hashes")
    host = [hasher.hash_to_g1(msgs[i], HASH_DST) for i in sample]
    if g1.decode_points(out[..., sample]) != host:
        raise AssertionError("time_hash: hash_to_g1_batch differs from the host hasher")
    stages, pts, _ = hash_g1_stages(ctx, msgs, dev)
    if [pts[i] for i in sample] != host:
        raise AssertionError("time_hash: the stage run of hash_to_g1_batch differs")
    log("hash_stages", repo=repr(repo), design=hdesign, **stages, card=repr(smi))

    ctx2 = get_hash_g2_ctx(spec, dev)
    out, pows = calls("hash_to_g2_batch (word path)",
                      lambda: hash_to_g2_batch(spec, msgs, HASH_G2_DST, device=dev), torch.equal,
                      N_HASH, "hashes")
    host = [hasher.hash_to_g2(msgs[i], HASH_G2_DST) for i in sample]
    if ctx2.g2.decode_points(out[..., sample]) != host:
        raise AssertionError("time_hash: hash_to_g2_batch differs from the host hasher")
    time_g2_map_pows(fp_cuda, pows, pdesign, smi)
    del pows
    stages, pts = hash_g2_stages(ctx2, msgs, dev)
    if [pts[i] for i in sample] != host:
        raise AssertionError("time_hash: the stage run of hash_to_g2_batch differs")
    log("g2_hash_stages", repo=repr(repo), design=pdesign, **stages, card=repr(smi))
    time_mont_mul(fp_cuda, ctx.fp, mont_design(build), shapes=MONT_SHAPES[:1])
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-msm", metavar="REPO",
                    help="only time phase 5's MSM with the checkout at REPO")
    ap.add_argument("--time-pairing", metavar="REPO",
                    help="only time the pairing paths' Miller kernels and calls with the "
                         "checkout at REPO")
    ap.add_argument("--time-batch", metavar="REPO",
                    help="only time BLS12-381 pairing_batch and its stages with the checkout "
                         "at REPO")
    ap.add_argument("--time-g2", metavar="REPO",
                    help="only time the G2 add, doubling and ladders and g2_scalar_mul with the "
                         "checkout at REPO")
    ap.add_argument("--time-hash", metavar="REPO",
                    help="only time hash_g1, fp_pow, mont_mul and the hash and G1 entry points "
                         "with the checkout at REPO")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one 2^20 MSM and time add on BLS12-381 vs BN254")
    args = ap.parse_args()
    if args.time_msm:
        return time_msm(args.time_msm)
    if args.time_pairing:
        return time_pairing(args.time_pairing)
    if args.time_batch:
        return time_batch(args.time_batch)
    if args.time_g2:
        return time_g2(args.time_g2)
    if args.time_hash:
        return time_hash(args.time_hash)
    t_start = time.perf_counter()

    import numpy as np
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mathlib_tpu_torch
    from mathlib_tpu_torch import get_spec
    from mathlib_tpu_torch.host import get_engine

    if not os.path.abspath(mathlib_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError("mathlib_tpu_torch was not imported from this checkout")
    from mathlib_tpu_torch.ops import msm as M
    from mathlib_tpu_torch.ops.g1 import G1Ctx
    from mathlib_tpu_torch.ops.kernels import build, fp_cuda, g1_cuda, gather_cuda, pairing_cuda

    dev = mathlib_tpu_torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log("device", kind=repr(kind), count=count, smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load()  # builds here unless an up-to-date library is already there
    log("build", seconds=f"{time.perf_counter() - t0:.1f}", log=build.BUILD_LOG,
        nvcc_seconds=build.SECONDS,
        wall_source=max(build.SECONDS, key=build.SECONDS.get) if build.SECONDS else None)
    for entry in ptxas_entries(build.BUILD_LOG):
        print("  ptxas:", entry)

    spec = get_spec("BLS12_381")
    eng = get_engine(spec)
    g1 = G1Ctx(spec, dev)
    F = g1.F
    rng = np.random.default_rng(0)

    def rand_ints(count):
        """count uniform scalars in [0, r), as bench.py draws them."""
        return [int.from_bytes(rng.bytes(32), "big") % spec.r for _ in range(count)]

    # ---- 3. kernels vs plain versions on the card (exact)
    t_phase = time.perf_counter()
    pool = [eng.g1.mul(eng.gen_g1, k) for k in rand_ints(257)]
    n = N_CHECK
    ia, ib = rng.integers(0, len(pool), n), rng.integers(0, len(pool), n)
    A = [pool[i] for i in ia]
    B = [pool[i] for i in ib]
    for i in range(0, n, 7):
        B[i] = A[i]  # P == Q
    for i in range(3, n, 17):
        B[i] = eng.g1.neg(A[i])  # P == -Q
    for i in range(5, n, 11):
        A[i] = None
    for i in range(6, n, 13):
        B[i] = None
    P, Q = g1.encode_points(A), g1.encode_points(B)
    sel = torch.from_numpy(rng.random(n) < 15 / 16).to(dev)
    results = {}

    def check(name, got, want):
        return check_equal(results, name, got, want)

    S1 = check("add", g1_cuda.add(F, P, Q), g1_cuda.add_plain(F, P, Q))  # relaxed outputs
    # double on 1, 16, 33 and 4,097 lanes (ragged blocks of 32): the relaxed
    # sums (P = Q and P = -Q lanes among them), P with its infinity lanes, -P
    for a in (S1, P, g1.neg(P)):
        for m in (1, 16, 33, n):
            b = a[..., :m].contiguous()
            check("double", g1_cuda.double(F, b), g1_cuda.double_plain(F, b))
    check("addsel", g1_cuda.addsel(F, S1, Q, sel), g1_cuda.addsel_plain(F, S1, Q, sel))
    ks = rand_ints(N_SMUL)
    ks[:3] = [0, 1, spec.r - 1]
    Ks = g1.encode_scalars(ks)
    check("smul", g1_cuda.smul(F, S1[..., :N_SMUL], Ks, g1.nbits),
          g1_cuda.smul_plain(F, S1[..., :N_SMUL], Ks, g1.nbits))
    log("kernels_vs_plain", lanes=n, smul_lanes=N_SMUL, equal=True,
        max_abs_err={k: v["max_abs_err"] for k, v in results.items()})

    # the same check again at the main path's shapes, each kernel timed
    # beside its plain version: addsel on W*C lanes per scan step,
    # add/double on 2^20 lanes, smul on the 8,192 base points
    WC = M.n_windows(g1, C) * (N_MAIN // K)
    lanes_b = max(N_MAIN, WC)
    reps = -(-lanes_b // n)
    Pb = S1.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    Qb = Q.repeat(1, 1, reps)[..., :lanes_b].contiguous()
    selb = torch.from_numpy(rng.random(WC) < 15 / 16).to(dev)
    Pw, Qw = Pb[..., :WC].contiguous(), Qb[..., :WC].contiguous()  # as a scan step's operands
    Kb_ints = rand_ints(N_BASE)
    Kb = g1.encode_scalars(Kb_ints)
    P16 = Pb[..., :16].contiguous()  # the MSM's windows, as the wrapper gets them there
    shapes = {
        "add": (N_MAIN, lambda: g1_cuda.add(F, Pb[..., :N_MAIN], Qb[..., :N_MAIN]),
                lambda: chunked(lambda a, b: g1_cuda.add_plain(F, a, b), N_MAIN,
                                Pb[..., :N_MAIN], Qb[..., :N_MAIN])),
        "double": (N_MAIN, lambda: g1_cuda.double(F, Pb[..., :N_MAIN]),
                   lambda: chunked(lambda a: g1_cuda.double_plain(F, a), N_MAIN,
                                   Pb[..., :N_MAIN])),
        "double_16": (16, lambda: g1_cuda.double(F, P16), lambda: g1_cuda.double_plain(F, P16)),
        "addsel": (WC, lambda: g1_cuda.addsel(F, Pw, Qw, selb),
                   lambda: chunked(lambda a, b, s: g1_cuda.addsel_plain(F, a, b, s), WC,
                                   Pw, Qw, selb)),
        "smul": (N_BASE, lambda: g1_cuda.smul(F, Pb[..., :N_BASE], Kb, g1.nbits),
                 lambda: g1_cuda.smul_plain(F, Pb[..., :N_BASE], Kb, g1.nbits)),
    }
    # bytes each kernel must move (int32 limb tensors) and the field
    # products its inputs need (RCB add 12, double 8; addsel adds only on
    # selected lanes; the ladder doubles at every bit and adds at one-bits)
    pt_bytes = 3 * g1.fp.L * 4
    ones = sum(bin(k).count("1") for k in Kb_ints)
    work = {
        "add": (3 * pt_bytes * N_MAIN, 12 * N_MAIN),
        "double": (2 * pt_bytes * N_MAIN, 8 * N_MAIN),
        "double_16": (2 * pt_bytes * 16, 8 * 16),
        "addsel": ((3 * pt_bytes + 1) * WC, 12 * int(selb.sum())),
        "smul": ((2 * pt_bytes + 4 * Kb.shape[-2]) * N_BASE, 8 * g1.nbits * N_BASE + 12 * ones),
    }
    # the JSON line keeps each kernel at its main-path shape: double at the
    # 16 lanes the MSM launches it at (2^20 lanes logged beside it)
    for name, (lanes, kern, plain) in shapes.items():
        ms, got = cuda_ms(kern, reps=200 if lanes <= 4096 else 5)
        plain_ms, want = cuda_ms(plain, reps=1)
        kernel = name.split("_16")[0]
        check(kernel, got, want)
        if kernel == "smul":
            smul_want = want
        del got, want
        nbytes, fp_muls = work[name]
        b = bound(nbytes, wide_mads(fp_muls, g1.fp.L))
        if name != "double":
            results[kernel].update(ms=ms, plain_ms=plain_ms, lanes=lanes, **b)
        log("time", kernel=kernel, lanes=lanes, equal=True, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", speedup=f"{plain_ms / ms:.1f}x",
            bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
    # the ladder at bls_sign_batch's 4,096 lanes and below, each against the
    # plain version's first lanes; the doubling at its shapes
    time_smul(g1_cuda, F, Pb[..., :N_BASE], Kb, smul_design(build), g1.nbits,
              lanes=SMUL_LANES[1:], want=smul_want)
    del smul_want
    time_double(g1_cuda, F, Pb, double_design(build))
    # the six-warp add kernels at their three shapes, and their ptxas lines:
    # no stack, no spill, at most 128 registers a thread
    sel_t = np.random.default_rng(6).random(N_MAIN) < 15 / 16  # leaves rng's draws as they were
    time_g1_adds(g1_cuda, F, Pb, Qb, torch.from_numpy(sel_t).to(dev), split_design(build))
    for entry in split_ptxas(build.BUILD_LOG):
        log("ptxas_g1_add", entry=repr(entry))
        regs = int(entry.split(": ")[1].split()[0])
        if regs > 128 or not entry.endswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
            raise AssertionError(f"split G1 kernel over its register budget: {entry}")
    # at 8 and 12 words; the ladder twice (smul, and smul_static: STATIC)
    if len(split_ptxas(build.BUILD_LOG)) != 2 * (len(SPLIT_KERNELS) + 1):
        raise AssertionError("the split G1 kernels' ptxas lines are missing from the build log")
    for entry in mont_ptxas(build.BUILD_LOG):
        log("ptxas_mont_mul", entry=repr(entry))
    del Pb, Qb, selb, Pw, Qw

    log("phase3", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 4. the n=512 gates
    t_phase = time.perf_counter()
    pts0 = g1.scalar_mul(g1.gen, g1.encode_scalars(rand_ints(N_GATE)))
    ks0 = rand_ints(N_GATE)
    scs0 = g1.encode_scalars(ks0)
    want = g1.decode_point(M.msm_naive(g1, pts0, scs0))
    host = eng.g1.msm(g1.decode_points(pts0), ks0)
    got_h = M.horner_host(g1, M.msm_totals(g1, pts0, scs0, c=C, K=K, capture="dense"), C)
    split = M.bucket_table(g1, pts0, scs0, c=C, K=K, _limit=1 << 20)
    got_split = M.horner_host(g1, M.window_totals(g1, split, C), C)
    if not (want == host == got_h == got_split):
        raise AssertionError("n=512 gate failed: msm_totals/split/msm_naive/host disagree")
    log("gates", n=N_GATE, msm_totals_eq_naive=True, split_eq_naive=True, naive_eq_host=True)

    # ---- 5. the main path at 2^20 points
    for mod in (g1_cuda, fp_cuda, pairing_cuda, gather_cuda):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base_ks = rand_ints(N_BASE)
    base = g1.scalar_mul(g1.gen, g1.encode_scalars(base_ks))
    base_aff = g1.decode_points(base)
    if base_aff != [eng.g1.mul(eng.gen_g1, k) for k in base_ks]:
        raise AssertionError("base points from scalar_mul disagree with the host engine")
    points = base.repeat(1, 1, N_MAIN // N_BASE).contiguous()
    ks_main = rand_ints(N_MAIN)
    scalars = g1.encode_scalars(ks_main)

    def run():
        return M.horner_host(g1, M.msm_totals(g1, points, scalars, c=C, K=K, capture="dense"), C)

    got = run()  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if out != got:
            raise AssertionError("main-path MSM is not deterministic across runs")
    launches = {k: v for k, v in {**g1_cuda.launches(), **gather_cuda.launches()}.items()
                if k in MAIN_G1}
    peak = torch.cuda.max_memory_allocated()
    folded = [sum(ks_main[j::N_BASE]) % spec.r for j in range(N_BASE)]
    if got != eng.g1.msm(base_aff, folded):
        raise AssertionError("2^20 MSM disagrees with the folded host oracle")
    pps = N_MAIN / min(times)
    log("main_path", n=N_MAIN, c=C, K=K, capture="dense", equals_folded_host_oracle=True,
        seconds=[round(t, 4) for t in times], points_per_s=f"{pps:.1f}",
        peak_mem_GB=f"{peak / 1e9:.2f}", card=repr(smi))
    log("launches", **launches)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # stage breakdown of one more run (host clock, synchronised between stages)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = M.bucket_table(g1, points, scalars, c=C, K=K, capture="dense")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    totals = M.window_totals(g1, table, C)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    M.horner_host(g1, totals, C)
    t3 = time.perf_counter()
    log("stages", bucket_table_s=f"{t1 - t0:.4f}", window_totals_s=f"{t2 - t1:.4f}",
        horner_host_s=f"{t3 - t2:.4f}")
    # the device time of one msm_totals (CUDA events, gaps included) beside
    # PERF.md section 5's 117.710 device ms (profiler sum of the kernels'
    # time, before the scan's gather was a kernel)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    gather_cuda.reset_launches()
    ev[0].record()
    M.msm_totals(g1, points, scalars, c=C, K=K, capture="dense")
    ev[1].record()
    torch.cuda.synchronize()
    log("main_path_device", msm_totals_device_ms=f"{ev[0].elapsed_time(ev[1]):.3f}",
        perf_md_device_ms_before="117.710 (profiler sum of kernel time)", **gather_cuda.launches())
    if args.profile:
        profile_run(run)
        add_ms_by_curve(dev, rng)

    log("phase4_5", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 6 and 7. the pairing-product check
    t_phase = time.perf_counter()
    pair_launches, checks = pairing_phases(dev, smi, results, args.profile)
    launches.update(pair_launches)
    log("phase6_7", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 8 and 9. pairing_batch and the device final exp; mont_mul runs on
    # both pairing paths and reports its pairing_batch count
    t_phase = time.perf_counter()
    launches.update(pairing_batch_phases(dev, smi, results, checks))
    log("phase8_9", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 10 and 11. the G1 MSM options, the bridge and BatchEngine's G1 entry points
    launches.update(g1_option_phases(dev, smi, results, {
        "g1": g1, "eng": eng, "spec": spec, "base": base, "base_aff": base_aff,
        "points": points, "scalars": scalars, "result": got, "seconds": times}))

    # ---- 12 and 13. hash-to-G1 and BatchEngine's hash and BLS entry points
    hash_main = {"spec": spec, "eng": eng}  # phase 13 leaves its verify inputs here
    launches.update(hash_phases(dev, smi, results, hash_main))

    # ---- 14 and 15. G2's group law, BatchEngine.g2_scalar_mul and hash-to-G2
    launches.update(g2_phases(dev, smi, results))
    missing = [k for k in KERNEL_INFO if k.startswith("g2_") and launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"G2 kernels not launched on their paths: {missing}")

    # ---- 16. the row gathers and the one-launch pairing check
    launches.update(gather_check_phase(dev, smi, results, hash_main, checks))

    # ---- 17. the public API (MultiScalarMul, the codec) and the Gt helpers
    launches.update(api_phase(dev, smi, results))
    missing = [k for k in KERNEL_INFO if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their paths: {missing}")

    designs = {"add": split_design(build), "addsel": split_design(build),
               "double": double_design(build), "addselneg": combiner_design(build),
               "maddsel": combiner_design(build), "maddselneg": combiner_design(build),
               "smul": smul_design(build), "mont_mul": mont_design(build),
               "hash_g1": hash_design(build), "fp_pow": pow_design(build),
               "smul_static": static_design(build), "pairing_check": check_design(build),
               "g2_add": g2_step_design(build), "g2_double": g2_step_design(build),
               "dbladd": dbladd_design(build), "g2_dblsel": dblsel_design(build),
               "g2_addsel": addsel_design(build)}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         **({"design": designs[name]} if name in designs else {}),
         "launches": launches.get(name, 0), "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         # no single PyTorch call computes any of the others
         "library_ms": results[name].get("library_ms")}
        for name, (src, replaces) in KERNEL_INFO.items()
    ]
    log("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
