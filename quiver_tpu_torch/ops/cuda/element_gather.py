"""Kernel B3 wrapper: element gather ``table2d.reshape(-1)[idx]`` on the card.

Replaces ``quiver_tpu/ops/pallas/sample_gather_kernel.py::
pallas_element_gather``, the sampler's ``gather_mode="pallas"`` read of
``indptr`` and ``indices``.  The CUDA source, ``csrc/element_gather.cu``,
says what bounds it on the H100 (latency of one random 32-byte sector per
element) and what its design does about that (one thread per element
reads that element only).  Its plain version is
:func:`element_gather_plain`.

:func:`element_gather` runs the plain version for tensors on the CPU and
the kernel for tensors on the card; a kernel that does not build or
launch raises.  ``element_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["element_gather", "element_gather_plain", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/element_gather.cu"
REPLACES = "quiver_tpu/ops/pallas/sample_gather_kernel.py:73"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = (_P, _I64, _P, _P, _I64, ctypes.c_int, _P)
_DTYPES = (torch.int32, torch.float32)


def element_gather_plain(table2d: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """``flat[clamp(idx, 0, n-1)]`` in plain PyTorch: the reference for
    kernel B3.  Floats get ``+ 0.0``, as the TPU kernel's lane sum adds
    zeros (``-0.0`` becomes ``+0.0``)."""
    flat = table2d.reshape(-1)
    out = flat[idx.to(torch.int64).clamp(0, flat.shape[0] - 1)]
    return out + 0.0 if out.is_floating_point() else out


def element_gather(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Elements of the flattened contiguous ``table2d`` (int32 or fp32 on
    the card) at int32 ``idx`` of any shape, each clamped into the table;
    the result has ``idx``'s shape."""
    if table2d.device.type == "cpu":
        return element_gather_plain(table2d, idx)
    if table2d.device.type != "cuda":
        raise ValueError(f"element_gather: unsupported device "
                         f"{table2d.device}")
    if (table2d.dtype not in _DTYPES or table2d.dim() != 2
            or not table2d.is_contiguous() or table2d.numel() == 0):
        raise ValueError("element_gather: table2d must be a non-empty "
                         "contiguous 2-D int32 or float32 tensor, got "
                         f"{table2d.dtype} {tuple(table2d.shape)}")
    if idx.dtype != torch.int32 or idx.device != table2d.device:
        raise ValueError("element_gather: idx must be an int32 tensor on the "
                         "table's device")
    flat = idx.contiguous().reshape(-1)
    out = torch.empty(idx.shape, dtype=table2d.dtype, device=table2d.device)
    fn = build.load("element_gather", "element_gather", _ARGTYPES)
    with torch.cuda.device(table2d.device):
        stream = torch.cuda.current_stream(table2d.device).cuda_stream
        rc = fn(table2d.data_ptr(), table2d.numel(), flat.data_ptr(),
                out.data_ptr(), flat.shape[0],
                int(table2d.dtype == torch.float32), stream)
    build.check(rc, "element_gather launch")
    element_gather.launches += 1
    return out


element_gather.launches = 0
