"""mathlib-tpu on PyTorch and CUDA: the port of ``mathlib_tpu`` to an NVIDIA H100.

The JAX package ``mathlib_tpu`` stays the reference.  This package keeps its
tensor contract at every public function -- ``(..., L, B)`` arrays of 16-bit
limbs in Montgomery form, values relaxed to ``[0, 2p)``, points stacked as
``(..., 3, L, B)`` -- held here as ``torch.int32`` tensors carrying the same
bits as the reference's ``uint32`` arrays.  Plain tensor code is PyTorch; the
group-law kernels are CUDA C++ under ``csrc/``, built with ``nvcc`` at first
use (``ops/kernels/build.py``).

The port keeps its own copies of what it needs from the reference's modules
that do not use JAX: ``curves/params.py`` (curve constants) and ``host/``
(the exact host tower and engine, and the C++ engine that finishes MSMs and
pairing checks on the host).  Nothing here imports ``jax`` or
``mathlib_tpu``.  Every entry point runs on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from .curves.params import CurveSpec, get_spec  # noqa: F401


def device(kind=None) -> torch.device:
    """The device to run on: ``None`` (the default of every entry point) or
    ``"cuda"`` needs a visible card; ``"cpu"`` must be asked for by name.  A
    ``torch.device`` is what a context hands the contexts it builds, once
    resolved here, and is taken as it is.  Raises instead of handing back
    another device."""
    index = None
    if isinstance(kind, torch.device):
        kind, index = kind.type, kind.index
    kind = "cuda" if kind is None else kind
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r} (want 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    return torch.device("cuda", torch.cuda.current_device() if index is None else index)
