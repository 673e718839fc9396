"""Kernel B3 wrapper: element gather ``table2d.reshape(-1)[idx]`` on the card.

Replaces ``quiver_tpu/ops/pallas/sample_gather_kernel.py::
pallas_element_gather``, the sampler's ``gather_mode="pallas"`` read of
``indptr`` and ``indices``.  Two entries of one kernel library:
:func:`element_gather` reads one element per id (a hop's draws from
``indices``), :func:`element_gather_pair` reads the elements at ``idx`` and
``idx + 1`` in one launch (a hop's start and end from ``indptr``).

The CUDA source, ``csrc/element_gather.cu`` with the device code it shares
with B4 (``csrc/element_gather.cuh``), says what bounds it on the H100
(scattered reads, fetched 64 bytes at a time) and what its design does about
that: four ids a thread per step with 16-byte id loads and stores, every
element load in flight before any is used, one wave of 128-thread blocks
sized from the SM count and the occupancy.  That walk was picked by
``walk_sweep.py`` at the products hops' shapes (``PERF.md``).  The plain
versions are
:func:`element_gather_plain` and :func:`element_gather_pair_plain`.

Both entries run the plain version for tensors on the CPU and the kernel
for tensors on the card; a kernel that does not build or launch raises.
``element_gather.launches`` counts the kernel launches of both entries.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled

__all__ = ["element_gather", "element_gather_pair", "element_gather_plain",
           "element_gather_pair_plain", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/element_gather.cu"
REPLACES = "quiver_tpu/ops/pallas/sample_gather_kernel.py:73"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = (_P, _I64, _P, _P, _I64, _INT, _P)
_PAIR_ARGTYPES = (_P, _I64, _P, _P, _P, _I64, _INT, _P)
_DTYPES = (torch.int32, torch.float32)


def element_gather_plain(table2d: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """``flat[clamp(idx, 0, n-1)]`` in plain PyTorch: the reference for
    kernel B3.  Floats get ``+ 0.0``, as the TPU kernel's lane sum adds
    zeros (``-0.0`` becomes ``+0.0``)."""
    flat = table2d.reshape(-1)
    out = flat[idx.to(torch.int64).clamp(0, flat.shape[0] - 1)]
    return out + 0.0 if out.is_floating_point() else out


def element_gather_pair_plain(table2d: torch.Tensor, idx: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flat[clamp(idx)], flat[clamp(idx + 1)])`` in plain PyTorch, with
    ``idx + 1`` in 64 bits: the reference for the pair entry."""
    return (element_gather_plain(table2d, idx),
            element_gather_plain(table2d, idx.to(torch.int64) + 1))


def _check(what: str, table2d: torch.Tensor, idx: torch.Tensor) -> None:
    if table2d.device.type != "cuda":
        raise KernelArgumentError(
            f"{what}: unsupported device {table2d.device}")
    if (table2d.dtype not in _DTYPES or table2d.dim() != 2
            or not table2d.is_contiguous() or table2d.numel() == 0):
        raise KernelArgumentError(
            f"{what}: table2d must be a non-empty contiguous "
            "2-D int32 or float32 tensor, got "
            f"{table2d.dtype} {tuple(table2d.shape)}")
    if idx.dtype != torch.int32 or idx.device != table2d.device:
        raise KernelArgumentError(
            f"{what}: idx must be an int32 tensor on the "
            "table's device")


@profiled("kernel")
def element_gather(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Elements of the flattened contiguous ``table2d`` (int32 or fp32 on
    the card) at int32 ``idx`` of any shape, each clamped into the table;
    the result has ``idx``'s shape."""
    if table2d.device.type == "cpu":
        return element_gather_plain(table2d, idx)
    _check("element_gather", table2d, idx)
    flat = idx.contiguous()
    out = torch.empty(idx.shape, dtype=table2d.dtype, device=table2d.device)
    build.launch(build.load("element_gather", "element_gather", _ARGTYPES),
                 table2d.device, table2d.data_ptr(), table2d.numel(),
                 flat.data_ptr(), out.data_ptr(), flat.numel(),
                 int(table2d.dtype == torch.float32))
    element_gather.launches += 1
    return out


@profiled("kernel")
def element_gather_pair(table2d: torch.Tensor, idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flat[clamp(idx)], flat[clamp(idx + 1)])`` over the flattened
    contiguous ``table2d`` at int32 ``idx`` of any shape, in one launch;
    ``idx + 1`` is taken in 64 bits, so no id wraps.  Both results have
    ``idx``'s shape (two views of one allocation)."""
    if table2d.device.type == "cpu":
        return element_gather_pair_plain(table2d, idx)
    _check("element_gather_pair", table2d, idx)
    flat = idx.contiguous()
    lo, hi = torch.empty((2, *idx.shape), dtype=table2d.dtype,
                         device=table2d.device).unbind(0)
    build.launch(build.load("element_gather", "element_gather_pair",
                            _PAIR_ARGTYPES),
                 table2d.device, table2d.data_ptr(), table2d.numel(),
                 flat.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 flat.numel(), int(table2d.dtype == torch.float32))
    element_gather.launches += 1
    return lo, hi


element_gather.launches = 0
