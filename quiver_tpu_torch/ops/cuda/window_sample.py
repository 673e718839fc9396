"""Kernel B1 wrapper: one fused sampling hop on the card.

Replaces ``quiver_tpu/ops/pallas/window_sample_kernel.py::pallas_window_sample``.
The CUDA source, ``csrc/window_sample.cu``, says what bounds it on the H100
(its scattered reads of ``indices``) and what its design does (32 draws a
warp, each seed's window read once and shared by warp shuffles, 32-bit
index math, one wave of blocks, and a pipeline entry that makes a hop one
launch).

Two entries of one kernel:

- :func:`window_sample`, the literal hop ``(nbrs, mask, counts, eid)``,
  for ``sample_neighbors``/``run_hop``; its plain version is
  :func:`~quiver_tpu_torch.ops.sample.sample_hop_plain`.
- :func:`window_sample_frontier`, the hop of the positional multi-hop
  pipeline (``sampler.py``): over the first ``t`` ids of a frontier buffer
  it also writes the hop's frontier tail, mask tail and local ids, which
  the pipeline would otherwise build with a chain of small ops; its plain
  version is :func:`window_sample_frontier_plain`.

Both run the plain version for tensors on the CPU and the kernel for
tensors on the card; a kernel that does not build or launch raises.
``window_sample.launches`` counts the kernel launches of both entries.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled
from ..sample import SampleOut, sample_hop_plain

__all__ = ["window_sample", "window_sample_plain", "window_sample_frontier",
           "window_sample_frontier_plain", "FrontierHop", "div_magic",
           "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/window_sample.cu"
REPLACES = "quiver_tpu/ops/pallas/window_sample_kernel.py:146"

window_sample_plain = sample_hop_plain

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_ARGTYPES = (_P, _I64, _P, _I64, _P, _P, _I64, ctypes.c_int, _U32, _U32,
             _U32, _U32, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int32, _P)
_MAX_K = 2**20
_INT32_MAX = 2**31 - 1


class FrontierHop(NamedTuple):
    """One pipeline hop over ``frontier[:t]``: the ``LayerBlock`` fields.
    The hop's neighbours and mask are in the frontier buffers' tail."""

    nbr_local: torch.Tensor  # [t, k] int32: t + b*k + j, 0 where ~mask
    mask: torch.Tensor       # [t, k] bool, a view of fmask[t : t + t*k]
    counts: torch.Tensor     # [t] int32 = min(degree, k), 0 where masked
    eid: Optional[torch.Tensor] = None  # [t, k] int32 (-1 pad) if asked


def div_magic(k: int) -> Tuple[int, int]:
    """``(mul, shift)`` with ``n // k == (((n * mul) >> 32) + n) >> shift``
    for every ``0 <= n < 2**31``: the kernel's 32-bit ``t / k`` as a
    multiply-high (Granlund and Montgomery's round-up method), where
    ``(n * mul) >> 32 + n`` stays below ``2**32``."""
    shift = (k - 1).bit_length()  # ceil(log2 k)
    return ((1 << 32) * ((1 << shift) - k)) // k + 1, shift


def _check_tables(what: str, indptr: torch.Tensor, indices: torch.Tensor,
                  seeds: torch.Tensor) -> None:
    if seeds.device.type != "cuda":
        raise KernelArgumentError(f"{what}: unsupported device {seeds.device}")
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("seeds", seeds)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise KernelArgumentError(
                f"{what}: {name} must be a contiguous 1-D int32 "
                f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != seeds.device:
            raise KernelArgumentError(
                f"{what}: {name} on {t.device}, seeds on "
                f"{seeds.device}")


def _launch(indptr, indices, seeds, seed_mask, n_seeds, k, k0, k1, *,
            nbrs=None, mask=None, counts=None, eid=None, frontier=None,
            fmask=None, nbr_local=None, t0=0) -> None:
    """One launch of the kernel on the tables' device; ``seeds``,
    ``seed_mask`` and each output are device addresses or ``None`` (an
    output that is ``None`` is not written)."""
    mul, shift = div_magic(k)
    build.launch(build.load("window_sample", "window_sample", _ARGTYPES),
                 indptr.device, indptr.data_ptr(), indptr.shape[0],
                 indices.data_ptr(), indices.shape[0], seeds, seed_mask,
                 n_seeds, k, mul, shift, k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF,
                 nbrs, mask, counts, eid, frontier, fmask, nbr_local, t0)
    window_sample.launches += 1


@profiled("kernel")
def window_sample(indptr: torch.Tensor, indices: torch.Tensor,
                  seeds: torch.Tensor, k: int, k0: int, k1: int,
                  seed_mask: Optional[torch.Tensor] = None) -> SampleOut:
    """One hop: ``(nbrs, mask, counts, eid)`` for ``seeds`` at fanout ``k``
    under key words ``(k0, k1)``.  All tensors on one device."""
    if seeds.device.type == "cpu":
        return sample_hop_plain(indptr, indices, seeds, k, k0, k1, seed_mask)
    if not 1 <= k <= _MAX_K:
        raise KernelArgumentError(f"window_sample: fanout {k} out of range")
    _check_tables("window_sample", indptr, indices, seeds)
    if seeds.shape[0] * k > _INT32_MAX:
        raise KernelArgumentError(
            f"window_sample: {seeds.shape[0]} seeds x fanout "
            f"{k} draws reach 2**31 (the kernel's index math "
            "is 32-bit)")
    if seed_mask is not None:
        if (seed_mask.dtype != torch.bool or seed_mask.shape != seeds.shape
                or seed_mask.device != seeds.device):
            raise KernelArgumentError(
                "window_sample: seed_mask must be a bool tensor "
                "shaped and placed like seeds")
        seed_mask = seed_mask.contiguous()
    B = seeds.shape[0]
    dev = seeds.device
    nbrs = torch.empty((B, k), dtype=torch.int32, device=dev)
    mask = torch.empty((B, k), dtype=torch.bool, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    eid = torch.empty((B, k), dtype=torch.int32, device=dev)
    _launch(indptr, indices, seeds.data_ptr(),
            seed_mask.data_ptr() if seed_mask is not None else None, B, k,
            k0, k1, nbrs=nbrs.data_ptr(), mask=mask.data_ptr(),
            counts=counts.data_ptr(), eid=eid.data_ptr())
    return SampleOut(nbrs=nbrs, mask=mask, counts=counts, eid=eid)


window_sample.launches = 0


def _check_frontier(frontier: torch.Tensor, fmask: torch.Tensor, t: int,
                    k: int) -> None:
    if not 1 <= k <= _MAX_K:
        raise KernelArgumentError(
            f"window_sample_frontier: fanout {k} out of range")
    if (frontier.dtype != torch.int32 or frontier.dim() != 1
            or not frontier.is_contiguous()):
        raise KernelArgumentError(
            "window_sample_frontier: frontier must be a "
            "contiguous 1-D int32 tensor, got "
            f"{frontier.dtype} {tuple(frontier.shape)}")
    if (fmask.dtype != torch.bool or fmask.shape != frontier.shape
            or not fmask.is_contiguous() or fmask.device != frontier.device):
        raise KernelArgumentError(
            "window_sample_frontier: fmask must be a contiguous "
            "bool tensor shaped and placed like frontier")
    if not 0 <= t <= frontier.shape[0]:
        raise KernelArgumentError(
            f"window_sample_frontier: t={t} outside the "
            f"frontier of {frontier.shape[0]}")
    if t * (k + 1) > _INT32_MAX:
        raise KernelArgumentError(
            f"window_sample_frontier: a frontier of {t} + "
            f"{t} x {k} ids reaches 2**31 (local ids are int32)")
    if frontier.shape[0] < t * (k + 1):
        raise KernelArgumentError(
            f"window_sample_frontier: buffers of "
            f"{frontier.shape[0]} are too short for {t} + {t} "
            f"x {k} ids")


def window_sample_frontier_plain(indptr: torch.Tensor, indices: torch.Tensor,
                                 frontier: torch.Tensor, fmask: torch.Tensor,
                                 t: int, k: int, k0: int, k1: int,
                                 return_eid: bool = False) -> FrontierHop:
    """The pipeline entry in plain PyTorch: :func:`sample_hop_plain` over
    ``frontier[:t]`` (masked by ``fmask[:t]``), then the positional
    pipeline's epilogue written into ``frontier[t : t + t*k]`` (neighbours,
    0 where masked) and ``fmask[t : t + t*k]``."""
    _check_frontier(frontier, fmask, t, k)
    out = sample_hop_plain(indptr, indices, frontier[:t], k, k0, k1,
                           fmask[:t])
    n = t * k
    dev = frontier.device
    frontier[t:t + n] = torch.where(out.mask, out.nbrs,
                                    torch.zeros_like(out.nbrs)).reshape(-1)
    fmask[t:t + n] = out.mask.reshape(-1)
    pos = (t + torch.arange(t, dtype=torch.int32, device=dev)[:, None] * k
           + torch.arange(k, dtype=torch.int32, device=dev)[None, :])
    return FrontierHop(
        nbr_local=torch.where(out.mask, pos, torch.zeros_like(pos)),
        mask=fmask[t:t + n].view(t, k), counts=out.counts,
        eid=out.eid if return_eid else None)


@profiled("kernel")
def window_sample_frontier(indptr: torch.Tensor, indices: torch.Tensor,
                           frontier: torch.Tensor, fmask: torch.Tensor,
                           t: int, k: int, k0: int, k1: int,
                           return_eid: bool = False) -> FrontierHop:
    """One hop of the positional pipeline over ``frontier[:t]`` (seeds
    masked by ``fmask[:t]``) at fanout ``k`` under key words ``(k0, k1)``,
    in one launch: writes ``frontier[t + b*k + j]`` (the neighbour, 0 where
    masked), ``fmask[t + b*k + j]`` and returns the block's local ids,
    mask (a view of ``fmask``), counts and, if asked, edge ids.  The
    buffers hold at least ``t * (1 + k)`` ids; all tensors on one
    device."""
    if frontier.device.type == "cpu":
        return window_sample_frontier_plain(indptr, indices, frontier, fmask,
                                            t, k, k0, k1, return_eid)
    _check_frontier(frontier, fmask, t, k)
    _check_tables("window_sample_frontier", indptr, indices, frontier)
    dev = frontier.device
    nbr_local = torch.empty((t, k), dtype=torch.int32, device=dev)
    counts = torch.empty((t,), dtype=torch.int32, device=dev)
    eid = (torch.empty((t, k), dtype=torch.int32, device=dev)
           if return_eid else None)
    _launch(indptr, indices, frontier.data_ptr(), fmask.data_ptr(), t, k,
            k0, k1, counts=counts.data_ptr(),
            eid=eid.data_ptr() if return_eid else None,
            frontier=frontier.data_ptr() + 4 * t,
            fmask=fmask.data_ptr() + t, nbr_local=nbr_local.data_ptr(),
            t0=t)
    return FrontierHop(nbr_local=nbr_local,
                       mask=fmask[t:t + t * k].view(t, k), counts=counts,
                       eid=eid)
