"""Kernel B2 wrapper: feature-row gather ``table[idx]`` on the card.

Replaces ``quiver_tpu/ops/pallas/gather_kernel.py::gather_rows``.  The CUDA
source, ``csrc/gather_rows.cu``, says what bounds it on the H100 (memory
bandwidth) and what its design does about that (one warp per row, vector
units as wide as the row's size and alignment allow).  Its plain version
is :func:`gather_rows_plain`, ``table.index_select(0, idx)``.

:func:`gather_rows` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a kernel that does not build or launch
raises.  ``gather_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["gather_rows", "gather_rows_plain", "vector_bytes", "SOURCE",
           "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/gather_rows.cu"
REPLACES = "quiver_tpu/ops/pallas/gather_kernel.py:63"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = (_P, _P, _P, _I64, _I64, ctypes.c_int, _P)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` in plain PyTorch: the reference for kernel B2."""
    return table.index_select(0, idx)


def vector_bytes(row_bytes: int, *addresses: int) -> int:
    """Widest copy unit (16, 8, 4, 2 or 1 bytes) dividing the row size and
    every base address."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(a % v == 0 for a in addresses):
            return v
    return 1


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``table[idx]`` for a 2-D ``table [N, D]`` and int32 ``idx [M]``
    of any length; every ``idx`` must lie in ``[0, N)``."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous 2-D tensor")
    if (idx.dtype != torch.int32 or idx.dim() != 1
            or idx.device != table.device):
        raise ValueError("gather_rows: idx must be a 1-D int32 tensor on "
                         "the table's device")
    idx = idx.contiguous()
    M, D = idx.shape[0], table.shape[1]
    out = torch.empty((M, D), dtype=table.dtype, device=table.device)
    row_bytes = D * table.element_size()
    vec = vector_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    build.launch(build.load("gather_rows", "gather_rows", _ARGTYPES),
                 table.device, table.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), M, row_bytes, vec)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
