"""Kernel B4 wrapper: lane select ``out[i] = rows[i, lanes[i]]`` on the card.

Replaces ``quiver_tpu/ops/pallas/element_gather_kernel.py::lane_select``,
the lane half of ``ops/fastgather.py::element_gather(fused=True)`` (the
sampler's ``gather_mode="lanes_fused"``).  The CUDA source,
``csrc/lane_select.cu``, says what bounds it on the H100 (latency of one
32-byte sector per row) and what its design does about that (one thread
per row reads the selected element only).  Its plain version is
:func:`lane_select_plain`.

:func:`lane_select` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a kernel that does not build or launch
raises.  ``lane_select.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["lane_select", "lane_select_plain", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/lane_select.cu"
REPLACES = "quiver_tpu/ops/pallas/element_gather_kernel.py:43"

LANES = 128
_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, ctypes.c_int64, ctypes.c_int, _P)
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


def lane_select(rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """One lane of each row of contiguous ``rows [M, 128]`` (int32 or fp32
    on the card) at int32 ``lanes [M]``, for any ``M``."""
    if rows.device.type == "cpu":
        return lane_select_plain(rows, lanes)
    if rows.device.type != "cuda":
        raise ValueError(f"lane_select: unsupported device {rows.device}")
    if (rows.dtype not in _DTYPES or rows.dim() != 2
            or rows.shape[1] != LANES or not rows.is_contiguous()):
        raise ValueError("lane_select: rows must be a contiguous [M, 128] "
                         "int32 or float32 tensor, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if (lanes.dtype != torch.int32 or lanes.dim() != 1
            or lanes.shape[0] != rows.shape[0]
            or lanes.device != rows.device):
        raise ValueError("lane_select: lanes must be a 1-D int32 tensor of "
                         "one entry per row, on the rows' device")
    lanes = lanes.contiguous()
    M = rows.shape[0]
    out = torch.empty((M,), dtype=rows.dtype, device=rows.device)
    fn = build.load("lane_select", "lane_select", _ARGTYPES)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = fn(rows.data_ptr(), lanes.data_ptr(), out.data_ptr(), M,
                int(rows.dtype == torch.float32), stream)
    build.check(rc, "lane_select launch")
    lane_select.launches += 1
    return out


lane_select.launches = 0
