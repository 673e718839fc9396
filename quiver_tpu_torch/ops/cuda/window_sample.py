"""Kernel B1 wrapper: one fused sampling hop on the card.

Replaces ``quiver_tpu/ops/pallas/window_sample_kernel.py::pallas_window_sample``.
The CUDA source, ``csrc/window_sample.cu``, says what bounds it on the H100
(latency of two dependent scattered loads per draw) and what its design
does about that (one thread per draw, no window).  Its plain version is
:func:`~quiver_tpu_torch.ops.sample.sample_hop_plain`.

:func:`window_sample` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; a kernel that does not build or launch
raises.  ``window_sample.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from ..sample import SampleOut, sample_hop_plain

__all__ = ["window_sample", "window_sample_plain", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/window_sample.cu"
REPLACES = "quiver_tpu/ops/pallas/window_sample_kernel.py:146"

window_sample_plain = sample_hop_plain

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = (_P, _I64, _P, _I64, _P, _P, _I64, ctypes.c_int,
             ctypes.c_uint32, ctypes.c_uint32, _P, _P, _P, _P, _P)


def window_sample(indptr: torch.Tensor, indices: torch.Tensor,
                  seeds: torch.Tensor, k: int, k0: int, k1: int,
                  seed_mask: Optional[torch.Tensor] = None) -> SampleOut:
    """One hop: ``(nbrs, mask, counts, eid)`` for ``seeds`` at fanout ``k``
    under key words ``(k0, k1)``.  All tensors on one device."""
    if seeds.device.type == "cpu":
        return sample_hop_plain(indptr, indices, seeds, k, k0, k1, seed_mask)
    if seeds.device.type != "cuda":
        raise ValueError(f"window_sample: unsupported device {seeds.device}")
    if not 1 <= k <= 2**20:
        raise ValueError(f"window_sample: fanout {k} out of range")
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("seeds", seeds)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"window_sample: {name} must be a contiguous "
                             f"1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != seeds.device:
            raise ValueError(f"window_sample: {name} on {t.device}, seeds "
                             f"on {seeds.device}")
    if seed_mask is not None:
        if (seed_mask.dtype != torch.bool or seed_mask.shape != seeds.shape
                or seed_mask.device != seeds.device):
            raise ValueError("window_sample: seed_mask must be a bool tensor "
                             "shaped and placed like seeds")
        seed_mask = seed_mask.contiguous()
    B = seeds.shape[0]
    dev = seeds.device
    nbrs = torch.empty((B, k), dtype=torch.int32, device=dev)
    mask = torch.empty((B, k), dtype=torch.bool, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    eid = torch.empty((B, k), dtype=torch.int32, device=dev)
    build.launch(build.load("window_sample", "window_sample", _ARGTYPES), dev,
                 indptr.data_ptr(), indptr.shape[0], indices.data_ptr(),
                 indices.shape[0], seeds.data_ptr(),
                 seed_mask.data_ptr() if seed_mask is not None else None,
                 B, k, k0 & 0xFFFFFFFF, k1 & 0xFFFFFFFF, nbrs.data_ptr(),
                 mask.data_ptr(), counts.data_ptr(), eid.data_ptr())
    window_sample.launches += 1
    return SampleOut(nbrs=nbrs, mask=mask, counts=counts, eid=eid)


window_sample.launches = 0
