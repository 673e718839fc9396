"""Per-node expanded-neighbourhood size, the load signal of serving's
CPU/device routing (counterpart of ``quiver_tpu/neighbour_num.py``).

``mode="sampled"`` samples each node's neighbourhood once on the host with
the native sampler (``qt_neighbour_num``); ``mode="expected"`` computes
the expected frontier sizes from the reverse degree recurrence on the
device in plain PyTorch (the JAX package computes it outside any Pallas
kernel too).  Its sums go through ``index_add_``, which adds in no fixed
order on the card, and the float32 result is truncated to int64, so a node
whose expectation lies within rounding of an integer may differ by 1
between runs on different devices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .cpp.native import neighbour_num_native
from .utils.device import resolve_device
from .utils.topology import CSRTopo

__all__ = ["generate_neighbour_num", "expected_counts"]


def expected_counts(indptr: torch.Tensor, indices: torch.Tensor, n: int,
                    sizes: Sequence[int]) -> torch.Tensor:
    """``[n]`` float32 on the tables' device: ``g_L = 0``, ``g_l[v] =
    min(k_l, deg v) * (1 + mean over v's neighbours u of g_{l+1}[u])``,
    returns ``g_1``.  ``indptr`` is ``[n + 1]``, ``indices`` ``[E]``."""
    deg_i = (indptr[1:] - indptr[:-1]).long()
    deg = deg_i.to(torch.float32)
    row_of_edge = torch.repeat_interleave(
        torch.arange(n, device=indptr.device), deg_i,
        output_size=indices.shape[0])
    nbr = indices.long()
    g = torch.zeros(n, dtype=torch.float32, device=indptr.device)
    for k in reversed(list(sizes)):
        branch = torch.clamp(deg, max=float(k))
        s = torch.zeros_like(g).index_add_(0, row_of_edge, g[nbr])
        g = branch * (1.0 + s / torch.clamp(deg, min=1.0))
    return g


def generate_neighbour_num(csr_topo: CSRTopo, sizes: Sequence[int],
                           mode: str = "expected", n_threads: int = 0,
                           seed: int = 7, path: str = None,
                           device=None) -> np.ndarray:
    """``[N]`` int64 numpy: each node's expected (``"expected"``, on
    ``device``, the card by default) or sampled (``"sampled"``, the host
    sampler) total neighbourhood size over the fanouts ``sizes``.  Saved
    to ``path`` (.npy) when given."""
    if mode == "sampled":
        out = neighbour_num_native(csr_topo.indptr, csr_topo.indices,
                                   list(sizes), n_threads=n_threads,
                                   seed=seed)
    elif mode == "expected":
        dev = resolve_device(device)
        indptr, indices = csr_topo.to_device(dev)
        n, e = csr_topo.node_count, csr_topo.edge_count
        g = expected_counts(indptr[: n + 1], indices[:e], n, sizes)
        out = g.cpu().numpy().astype(np.int64)
    else:
        raise ValueError(f"mode must be 'expected' or 'sampled', got "
                         f"{mode!r}")
    if path is not None:
        np.save(path, out)
    return out
