"""Kernel B5 wrapper: the paged store's ragged page gather on the card.

Replaces ``quiver_tpu/ops/pallas/page_gather_kernel.py::page_gather``
together with the rank take that ``quiver_tpu/feature.py::_paged_fn``
fuses behind it, so one launch writes each output row once, in the
caller's order:

    out[i] = frames[blk_pages[(rank[i] // block) * ppb + row_lp[rank[i]]],
                    row_off[rank[i]], :]          for i < len(rank)

The CUDA source, ``csrc/page_gather.cu``, says what bounds it on the H100
(memory bandwidth) and why it copies rows directly instead of staging
pages as the TPU kernel does.  Its plain version is
:func:`page_gather_plain`: the padded page gather of the plan, then
``index_select(0, rank)``.

:func:`page_gather` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a kernel that does not build or launch
raises.  ``page_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled
from .gather_rows import vector_bytes

__all__ = ["page_gather", "page_gather_plain", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/page_gather.cu"
REPLACES = "quiver_tpu/ops/pallas/page_gather_kernel.py:95"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
             ctypes.c_int, _P)


def page_gather_plain(frames: torch.Tensor, blk_pages: torch.Tensor,
                      row_lp: torch.Tensor, row_off: torch.Tensor,
                      rank: torch.Tensor, block: int,
                      ppb: int) -> torch.Tensor:
    """The reference for kernel B5 in plain PyTorch: every padded plan row
    ``i`` reads ``frames[blk_pages[(i // block) * ppb + row_lp[i]],
    row_off[i]]``, then ``rank`` picks the rows in the caller's order."""
    i = torch.arange(row_lp.shape[0], device=frames.device)
    src = blk_pages.long()[(i // block) * ppb + row_lp.long()]
    padded = frames[src, row_off.long()]
    return padded.index_select(0, rank.long())


@profiled("kernel")
def page_gather(frames: torch.Tensor, blk_pages: torch.Tensor,
                row_lp: torch.Tensor, row_off: torch.Tensor,
                rank: torch.Tensor, block: int, ppb: int) -> torch.Tensor:
    """Rows ``[len(rank), D]`` gathered from ``frames [F, R, D]`` by a
    block plan of ``ops/paged.py``; every index is int32 and 1-D, and the
    plan must address frames that exist."""
    if frames.device.type == "cpu":
        return page_gather_plain(frames, blk_pages, row_lp, row_off, rank,
                                 block, ppb)
    if frames.device.type != "cuda":
        raise KernelArgumentError(
            f"page_gather: unsupported device {frames.device}")
    if frames.dim() != 3 or not frames.is_contiguous():
        raise KernelArgumentError(
            "page_gather: frames must be a contiguous 3-D "
            "tensor [F, R, D]")
    if block < 1 or ppb < 1:
        raise KernelArgumentError(
            f"page_gather: block {block} and ppb {ppb} must be "
            ">= 1")
    for name, t in (("blk_pages", blk_pages), ("row_lp", row_lp),
                    ("row_off", row_off), ("rank", rank)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise KernelArgumentError(
                f"page_gather: {name} must be a contiguous 1-D "
                f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != frames.device:
            raise KernelArgumentError(
                f"page_gather: {name} on {t.device}, frames on "
                f"{frames.device}")
    if row_off.shape != row_lp.shape:
        raise KernelArgumentError(
            "page_gather: row_lp and row_off differ in length")
    B = rank.shape[0]
    _, R, D = frames.shape
    out = torch.empty((B, D), dtype=frames.dtype, device=frames.device)
    row_bytes = D * frames.element_size()
    vec = vector_bytes(row_bytes, frames.data_ptr(), out.data_ptr())
    build.launch(build.load("page_gather", "page_gather", _ARGTYPES),
                 frames.device, frames.data_ptr(), blk_pages.data_ptr(),
                 row_lp.data_ptr(), row_off.data_ptr(), rank.data_ptr(),
                 out.data_ptr(), B, R, row_bytes, block, ppb, vec)
    page_gather.launches += 1
    return out


page_gather.launches = 0
