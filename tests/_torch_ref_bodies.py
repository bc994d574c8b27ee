"""The reference's G1 Pallas kernel bodies on numpy rows, for the port's
tests.

The bodies (``mathlib_tpu/ops/kernels/g1_pallas.py``) are trace-time Python
over uint32 rows; with ``jnp`` swapped for numpy they run the same integer
computation with no XLA program to compile (as ``tests/test_pallas_kernels.py``
runs them).  ``BodyG1`` puts them behind the reference ``G1Ctx``'s point
methods, so the reference's own MSM code runs on them -- inside its jitted
scans too, through ``jax.pure_callback``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import mathlib_tpu.ops.kernels.fp_rows as fp_rows_mod
import mathlib_tpu.ops.kernels.g1_pallas as g1p_mod
from mathlib_tpu.ops.kernels.fp_rows import RowCtx
from test_hash_pallas import _FakeJax, _FakePl


class Ref:
    """A numpy array standing in for a Pallas ref."""

    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, idx):
        return self.arr[idx]

    def __setitem__(self, idx, val):
        self.arr[idx] = val


@contextlib.contextmanager
def numpy_kernel_bodies(*modules):
    """Whole Pallas kernel bodies of ``modules`` (and of the row arithmetic
    they build on) on numpy rows: ``jnp`` is numpy, ``_mm_stacked`` stacks
    every product of a step into one (its chunk is a VMEM knob of the TPU;
    the values are the serial products'), ``pl.when`` and
    ``jax.lax.fori_loop`` run eagerly (the stand-ins of
    ``tests/test_hash_pallas.py``, shared here)."""
    # _mm_stacked's chunk of 12 products is a VMEM knob: on numpy one chunk
    # per step (the same values, far fewer numpy calls)
    swaps = [(fp_rows_mod, "jnp", np), (g1p_mod, "_STACK_CHUNK", 1 << 12)]
    for mod in modules:
        swaps += [(mod, "jnp", np), (mod, "pl", _FakePl), (mod, "jax", _FakeJax)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, val in swaps:
        setattr(mod, name, val)
    try:
        yield
    finally:
        for mod, name, val in reversed(saved):
            setattr(mod, name, val)


@contextlib.contextmanager
def numpy_bodies():
    """The reference's kernel bodies on numpy rows: the same uint32 integer
    computation, no XLA program to compile."""
    saved = fp_rows_mod.jnp, g1p_mod.jnp, g1p_mod._STACK_CHUNK
    fp_rows_mod.jnp = g1p_mod.jnp = np
    g1p_mod._STACK_CHUNK = 1 << 12  # one stacked product a step (see above)
    try:
        yield
    finally:
        fp_rows_mod.jnp, g1p_mod.jnp, g1p_mod._STACK_CHUNK = saved


# the reference's kernel bodies that take lane masks (sel, then neg), and
# those that take the limbs of R mod p (the mixed adds' lift)
_MASKS = {g1p_mod._addsel_kernel: 1, g1p_mod._addselneg_kernel: 2, g1p_mod._maddsel_kernel: 1,
          g1p_mod._maddselneg_kernel: 2}
_LIFTS = (g1p_mod._maddsel_kernel, g1p_mod._maddselneg_kernel)


class BodyG1:
    """The reference G1Ctx with ``add``, ``double`` and the scan combiners
    ``add_select``, ``add_select_neg``, ``madd_select`` and
    ``madd_select_neg`` run as the reference's Pallas kernel bodies
    (``_add_kernel``, ``_double_kernel``, ``_addsel_kernel``,
    ``_addselneg_kernel``, ``_maddsel_kernel``, ``_maddselneg_kernel``) on
    numpy rows, through ``jax.pure_callback`` so that they also run inside
    the reference's jitted scans: the RCB formulas in the XLA path's
    operation order (the mixed add: ``_madd_rows``, the kernels' own), so
    limb for limb the kernels' points, with no point arithmetic for XLA to
    compile.  The bodies stack each level's products (``_mm_stacked``, the
    same values as one product at a time), the faster form on numpy."""

    def __init__(self, g1):
        self._g1 = g1
        self._rows = RowCtx(g1.spec.p, g1.fp.L)
        R = 1 << (16 * g1.fp.L)
        self._one = tuple(((R % g1.spec.p) >> (16 * k)) & 0xFFFF for k in range(g1.fp.L))

    def __getattr__(self, name):
        return getattr(self._g1, name)

    def host(self, kernel, *arrs):
        """kernel on numpy (..., 3, L, B) points P, Q (Q affine (..., 2, L, B)
        for the mixed adds; of P's lanes) and its (..., B) masks last,
        eagerly: a numpy array of P's shape out."""
        arrs = [np.asarray(a) for a in arrs]
        shape = arrs[0].shape
        pts = arrs[: len(arrs) - _MASKS.get(kernel, 0)]
        flat = [np.moveaxis(a, (-3, -2), (0, 1)).reshape(a.shape[-3], shape[-2], 1, -1)
                for a in pts]
        flat += [a.reshape(1, 1, -1).astype(np.uint32) for a in arrs[len(pts) :]]
        out = Ref(np.zeros_like(flat[0]))
        lift = (self._one,) if kernel in _LIFTS else ()
        with numpy_bodies():
            kernel(self._rows, self._g1.F.b3, *lift, *[Ref(f) for f in flat], out,
                   mm=g1p_mod._mm_stacked)
        out = out.arr.reshape(shape[-3:-1] + shape[:-3] + shape[-1:])
        return np.moveaxis(out, (0, 1), (-3, -2))

    def _run(self, kernel, *arrays):
        """kernel on (..., 3, L, B) points (and its (..., B) masks last)."""
        return jax.pure_callback(lambda *a: self.host(kernel, *a),
                                 jax.ShapeDtypeStruct(arrays[0].shape, jnp.uint32), *arrays)

    def _masks(self, P, *masks):
        return [jnp.broadcast_to(m, P.shape[:-3] + P.shape[-1:]) for m in masks]

    def add(self, P, Q):
        return self._run(g1p_mod._add_kernel, *jnp.broadcast_arrays(P, Q))

    def double(self, P):
        return self._run(g1p_mod._double_kernel, P)

    def add_select(self, P, Q, sel):
        P, Q = jnp.broadcast_arrays(P, Q)
        return self._run(g1p_mod._addsel_kernel, P, Q, *self._masks(P, sel))

    def add_select_neg(self, P, Q, sel, neg):
        P, Q = jnp.broadcast_arrays(P, Q)
        return self._run(g1p_mod._addselneg_kernel, P, Q, *self._masks(P, sel, neg))

    def _affine(self, P, Q):
        return jnp.broadcast_to(Q, P.shape[:-3] + (2,) + P.shape[-2:])

    def madd_select(self, P, Q, sel):
        return self._run(g1p_mod._maddsel_kernel, P, self._affine(P, Q), *self._masks(P, sel))

    def madd_select_neg(self, P, Q, sel, neg):
        return self._run(g1p_mod._maddselneg_kernel, P, self._affine(P, Q),
                         *self._masks(P, sel, neg))
