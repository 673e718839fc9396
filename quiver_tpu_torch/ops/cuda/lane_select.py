"""Kernel B4 wrapper: lane select on the card.

Replaces ``quiver_tpu/ops/pallas/element_gather_kernel.py::lane_select``,
the lane half of ``ops/fastgather.py::element_gather(fused=True)`` (the
sampler's ``gather_mode="lanes_fused"``).  Two entries of one kernel
library:

- :func:`lane_select_rows` ``(table2d, row, lane)`` reads
  ``table2d[row[i], lane[i]]`` straight from the ``[R, 128]`` table: the
  row gather is fused in, so the ``[M, 128]`` rows never land in device
  memory, as on the TPU, where the ``jnp.take`` in front of the kernel
  streams through VMEM.  ``element_gather(fused=True)`` calls it.
- :func:`lane_select` ``(rows, lanes)`` selects from rows already gathered
  (row ``i`` of ``rows``): the TPU kernel's own interface, kept for the
  two-step path and for parity with the Pallas kernel.

The CUDA source, ``csrc/lane_select.cu`` with the device code it shares
with B3 (``csrc/element_gather.cuh``), says what bounds it on the H100
(one scattered read per element, fetched 64 bytes at a time) and what its
design does about that (B3's walk: four ids a thread per step, every load
in flight before any is used, one wave of 128-thread blocks).  Its plain version is :func:`lane_select_plain`.

Both entries run the plain version for tensors on the CPU and the kernel
for tensors on the card; a kernel that does not build or launch raises.
``lane_select.launches`` counts the kernel launches of both entries.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled

__all__ = ["lane_select", "lane_select_rows", "lane_select_plain",
           "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/lane_select.cu"
REPLACES = "quiver_tpu/ops/pallas/element_gather_kernel.py:43"

LANES = 128
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I64, _INT, _P)
_ROWS_ARGTYPES = (_P, _I64, _P, _P, _P, _I64, _INT, _P)
_DTYPES = (torch.int32, torch.float32)


def lane_select_plain(rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``rows[i, lanes[i]]``, 0 where a lane is outside ``[0, 128)``, in
    plain PyTorch: the reference for kernel B4.  Floats get ``+ 0.0``, as
    the TPU kernel's one-hot lane sum adds zeros (``-0.0`` becomes
    ``+0.0``)."""
    lanes = lanes.to(torch.int64)
    valid = (lanes >= 0) & (lanes < rows.shape[1])
    got = rows.gather(1, lanes.clamp(0, rows.shape[1] - 1)[:, None])[:, 0]
    out = torch.where(valid, got, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))
    return out + 0.0 if out.is_floating_point() else out


def _check_table(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise KernelArgumentError(f"{what}: unsupported device {t.device}")
    if (t.dtype not in _DTYPES or t.dim() != 2 or t.shape[1] != LANES
            or not t.is_contiguous()):
        raise KernelArgumentError(
            f"{what}: the table must be a contiguous [R, 128] "
            f"int32 or float32 tensor, got {t.dtype} "
            f"{tuple(t.shape)}")


def _check_ids(what: str, t: torch.Tensor, m: int, dev) -> None:
    if (t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != m
            or t.device != dev):
        raise KernelArgumentError(
            f"{what}: ids must be 1-D int32 tensors of one "
            "length, on the table's device")


@profiled("kernel")
def lane_select(rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """One lane of each row of contiguous ``rows [M, 128]`` (int32 or fp32
    on the card) at int32 ``lanes [M]``, for any ``M``."""
    if rows.device.type == "cpu":
        return lane_select_plain(rows, lanes)
    _check_table("lane_select", rows)
    M = rows.shape[0]
    _check_ids("lane_select", lanes, M, rows.device)
    lanes = lanes.contiguous()
    out = torch.empty((M,), dtype=rows.dtype, device=rows.device)
    build.launch(build.load("lane_select", "lane_select", _ARGTYPES),
                 rows.device, rows.data_ptr(), lanes.data_ptr(),
                 out.data_ptr(), M, int(rows.dtype == torch.float32))
    lane_select.launches += 1
    return out


@profiled("kernel")
def lane_select_rows(table2d: torch.Tensor, row: torch.Tensor,
                     lane: torch.Tensor) -> torch.Tensor:
    """``table2d[row[i], lane[i]]`` for int32 ``row [M]`` and ``lane [M]``
    over the contiguous ``[R, 128]`` table (int32 or fp32 on the card),
    0 where a lane is outside ``[0, 128)``, without gathering the rows.

    On the card a row outside ``[0, R)`` is clamped into it; the plain
    version, ``lane_select_plain(table2d.index_select(0, row), lane)``,
    raises for one instead.  The sampler clamps its ids first
    (``ops/sample.py::_gather``), so its rows are always in range."""
    if table2d.device.type == "cpu":
        return lane_select_plain(table2d.index_select(0, row), lane)
    _check_table("lane_select_rows", table2d)
    M = row.shape[0] if row.dim() == 1 else -1
    _check_ids("lane_select_rows", row, M, table2d.device)
    _check_ids("lane_select_rows", lane, M, table2d.device)
    row, lane = row.contiguous(), lane.contiguous()
    out = torch.empty((M,), dtype=table2d.dtype, device=table2d.device)
    build.launch(build.load("lane_select", "lane_select_rows",
                            _ROWS_ARGTYPES),
                 table2d.device, table2d.data_ptr(), table2d.shape[0],
                 row.data_ptr(), lane.data_ptr(), out.data_ptr(), M,
                 int(table2d.dtype == torch.float32))
    lane_select.launches += 1
    return out


lane_select.launches = 0
