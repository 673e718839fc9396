"""Kernel B2 wrapper: feature-row gather on the card.

``gather_rows(table, idx, order=None)`` is ``table[order[clamp(idx)]]``:
ids clamped to the table's rows, mapped through a row order when one is
given, each row copied, all in one call of ``csrc/gather_rows.cu``.  It
replaces ``quiver_tpu/ops/pallas/gather_kernel.py::gather_rows`` and the
clip and order takes of ``quiver_tpu/feature.py::lookup_device``.  The
source says what bounds it on the H100 (device memory) and what its design
does about that.  Its plain version is :func:`gather_rows_plain`.

The kernel has two routes, picked by :func:`route` from the call's shapes
alone: the direct route copies each position's row; the grouped route
groups the positions by row first (a counting sort on the card), so that
the copies of one row run side by side and read it from device memory
once.  Either copies 16-byte chunks where rows are 16-byte multiples in a
16-byte-aligned table, and the widest unit the row allows elsewhere.

:func:`gather_rows` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a kernel that does not build or launch
raises.  ``gather_rows.launches`` counts calls of the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled

__all__ = ["gather_rows", "gather_rows_plain", "gather_rows_route", "route",
           "vector_bytes", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/gather_rows.cu"
REPLACES = "quiver_tpu/ops/pallas/gather_kernel.py:63"

L2_BYTES = 50 * 10**6  # the H100's L2 cache
_SCAN_TILE = 4096      # counts a block scans (csrc: TILE)
# route's edges, each between two shapes timed on the H100 (PERF.md)
GROUPED_MIN_IDS_A_ROW = 1.25  # grouped lost at 0.9 ids a row, won at 1.26
GROUPED_MIN_ROW_BYTES = 808   # lost at 600-byte rows, won at 808

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = (_P, _I64, _P, _INT, _P, _P, _I64, _I64, _INT, _INT, _P, _P)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[order[clamp(idx, 0, N - 1)]]`` in plain PyTorch (without
    ``order``: ``table[clamp(idx, 0, N - 1)]``): the reference for B2."""
    pos = idx.clamp(0, max(table.shape[0] - 1, 0))
    if order is not None:
        pos = order.index_select(0, pos)
    return table.index_select(0, pos)


def vector_bytes(row_bytes: int, *addresses: int) -> int:
    """Widest copy unit (16, 8, 4, 2 or 1 bytes) dividing the row size and
    every base address."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(a % v == 0 for a in addresses):
            return v
    return 1


def route(m: int, n: int, row_bytes: int) -> str:
    """The route for ``m`` ids into an ``[n, row_bytes]`` table:
    ``"grouped"`` where the table is more than twice the L2 (so a row
    drawn again is mostly read from device memory again), there are at
    least 1.25 ids a row (so most rows drawn are drawn again) and rows are
    at least 808 bytes (so a row read once saves more than its scattered
    write costs); ``"direct"`` elsewhere.  Each edge lies between two
    shapes timed on the H100 (``b2_sweep.py``; ``PERF.md`` gives the
    times), each moved on its own from Reddit's fp32 lookup (585,728 ids,
    232,965 rows of 2,408 bytes, where grouped wins): grouped lost at 0.9
    ids a row and won at 1.26; lost at 600-byte rows (a 140 MB table) and
    won at 808; lost at a 96 MB table and won at 193 MB.  It lost at
    ogbn-products' lookup (0.44 ids a row), at MAG240M's papers and
    authors (0.21) and at its institutions (a 79 MB table)."""
    if (max(m, n) < 2**31 and n * row_bytes > 2 * L2_BYTES
            and m >= GROUPED_MIN_IDS_A_ROW * n
            and row_bytes >= GROUPED_MIN_ROW_BYTES):
        return "grouped"
    return "direct"


@profiled("kernel")
def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``table[order[clamp(idx, 0, N - 1)]]`` of a 2-D ``table
    [N, D]`` for int32 or int64 ``idx [M]`` of any length and values, with
    ``order`` an int32 ``[N]`` map onto the table's rows or ``None``."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, order)
    n, row_bytes = _check(table, idx, order)
    return _launch(table, idx, order, route(idx.shape[0], n, row_bytes))


def gather_rows_route(table: torch.Tensor, idx: torch.Tensor,
                      order: Optional[torch.Tensor], which: str
                      ) -> torch.Tensor:
    """:func:`gather_rows` on the card through the named route (``"direct"``
    or ``"grouped"``) whatever :func:`route` would pick: both routes timed
    on one call's inputs."""
    n, _ = _check(table, idx, order)
    if which not in ("direct", "grouped"):
        raise KernelArgumentError(f"gather_rows: unknown route {which!r}")
    if which == "grouped" and max(idx.shape[0], n) >= 2**31:
        raise KernelArgumentError(
            "gather_rows: the grouped route takes under 2**31 "
            "ids and rows")
    return _launch(table, idx, order, which)


def _check(table, idx, order):
    if table.device.type != "cuda":
        raise KernelArgumentError(
            f"gather_rows: unsupported device {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise KernelArgumentError(
            "gather_rows: table must be a contiguous 2-D tensor")
    if (idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1
            or idx.device != table.device):
        raise KernelArgumentError(
            "gather_rows: idx must be a 1-D int32 or int64 "
            "tensor on the table's device")
    n = table.shape[0]
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (n,)
                              or order.device != table.device):
        raise KernelArgumentError(
            "gather_rows: order must be an int32 [N] tensor on "
            "the table's device")
    if n == 0 and idx.shape[0]:
        raise KernelArgumentError("gather_rows: ids into a table with no rows")
    return n, table.shape[1] * table.element_size()


def _launch(table, idx, order, which):
    idx = idx.contiguous()
    order = None if order is None else order.contiguous()
    m, n = idx.shape[0], table.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    out = torch.empty((m, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    grouped = which == "grouped"
    scratch = None
    if grouped and m and row_bytes:
        # counts, tile sums, then the grouped rows and positions
        scratch = torch.empty(n + -(-n // _SCAN_TILE) + 2 * m,
                              dtype=torch.int32, device=table.device)
    unit = vector_bytes(row_bytes, table.data_ptr())
    build.launch(build.load("gather_rows", "gather_rows", _ARGTYPES),
                 table.device, table.data_ptr(), n, idx.data_ptr(),
                 int(idx.dtype == torch.int64),
                 None if order is None else order.data_ptr(), out.data_ptr(),
                 m, row_bytes, unit, int(grouped),
                 None if scratch is None else scratch.data_ptr())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
