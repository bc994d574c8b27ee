"""mathlib-tpu on PyTorch and CUDA: the port of ``mathlib_tpu`` to an NVIDIA H100.

The JAX package ``mathlib_tpu`` stays the reference.  This package keeps its
tensor contract at every public function -- ``(..., L, B)`` arrays of 16-bit
limbs in Montgomery form, values relaxed to ``[0, 2p)``, points stacked as
``(..., 3, L, B)`` -- held here as ``torch.int32`` tensors carrying the same
bits as the reference's ``uint32`` arrays.  Plain tensor code is PyTorch; the
group-law kernels are CUDA C++ under ``csrc/``, built with ``nvcc`` at first
use (``ops/kernels/build.py``).

The jax-free parts of the reference are shared, not forked:
``mathlib_tpu.curves.params`` (curve constants) and ``mathlib_tpu.host``
(the exact host engine: oracle and Horner finisher).  Nothing here imports
``jax``.
"""

from __future__ import annotations

import torch

from mathlib_tpu.curves.params import CurveSpec, get_spec  # noqa: F401


def device(kind: str = "cuda") -> torch.device:
    """The device to run on: ``"cuda"`` needs a visible card, ``"cpu"`` must
    be asked for by name.  Raises instead of handing back another device."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r} (want 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch")
    return torch.device("cuda", torch.cuda.current_device())
