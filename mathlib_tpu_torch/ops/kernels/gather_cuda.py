"""Row gathers for Hopper (port of ``mathlib_tpu/ops/kernels/gather_pallas.py``).

CUDA C++ in ``csrc/gather_kernels.cu``, each kernel behind a wrapper here:

=================  ==================================  ===============================
wrapper            computes                            replaces (TPU kernel)
=================  ==================================  ===============================
``gather_rows``    ``table[idx]``: (N, Wr) x (M,)      ``gather_rows_pallas`` (``_build``)
                   -> (M, Wr)
``gather_rows_t``  ``table[idx].T``, contiguous:       ``gather_rows_t_pallas``
                   (N, Wr) x (M,) -> (Wr, M)           (``_build_t``)
=================  ==================================  ===============================

``gather_rows_t`` is the MSM scan's gather (``ops/msm.py``): one (N, RP)
point-major row a point in, the (RP, M) lane-major operand of the scan's
combiner out, in one pass.  ``gather_rows`` has no caller in the library (the
reference's has none either); ``chip_smoke.py`` drives it.

The table holds 32-bit words (int32 limbs in the port), the indices are
int32 or int64, M is any count (the reference pads M to its block; nothing
here needs that).  On a CPU tensor a wrapper returns its plain PyTorch
version (``*_plain``).  On a CUDA tensor it launches its kernel on the current
stream, adds one to its ``launches`` count per launch, and raises if a launch
fails; it never falls back.  The kernels do not bounds-check the indices.
"""

from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor


def gather_rows_plain(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx]: (N, Wr) x (M,) -> (M, Wr)."""
    return table[idx]


def gather_rows_t_plain(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx].T, contiguous: (N, Wr) x (M,) -> (Wr, M)."""
    return table[idx].T.contiguous()


def _check(table: Tensor, idx: Tensor) -> None:
    """Refuse what the kernels do not take."""
    if idx.device != table.device:
        raise ValueError(f"idx must be on the table's device {table.device}, got {idx.device}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be a 1-d int32 or int64 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if table.dim() != 2 or table.element_size() != 4 or not table.is_contiguous():
        raise ValueError("the table must be a contiguous (N, Wr) tensor of 32-bit words")
    if table.device.type != "cuda":
        raise ValueError(f"the gathers run on CPU (plain) or CUDA tensors, got {table.device}")


def _launch(name: str, table: Tensor, idx: Tensor, out: Tensor) -> None:
    idx = idx.contiguous()
    with torch.cuda.device(table.device):
        build.launch(name, table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
                     out.data_ptr(), idx.shape[0], table.shape[1], build.stream(table))


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx]: (N, Wr) x (M,) -> (M, Wr); on the card one warp a row."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _check(table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if out.numel():
        _launch("mlt_gather_rows", table, idx, out)
        gather_rows.launches += 1
    return out


def gather_rows_t(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx].T, contiguous: (N, Wr) x (M,) -> (Wr, M); on the card a
    block a tile of 32 indices, through shared memory."""
    if table.device.type == "cpu":
        return gather_rows_t_plain(table, idx)
    _check(table, idx)
    out = torch.empty((table.shape[1], idx.shape[0]), dtype=table.dtype, device=table.device)
    if out.numel():
        _launch("mlt_gather_rows_t", table, idx, out)
        gather_rows_t.launches += 1
    return out


KERNELS = (gather_rows, gather_rows_t)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launches()
