"""Feature-access probability (counterpart of ``quiver_tpu/ops/prob.py``).

The expected number of times each node enters a sampled batch, layer by
layer: the reference's ``cal_next`` kernel (``cuda_random.cu.hpp:72-104``)
behind ``sample_prob``.  It orders the hot-cache split and the
partitioner.  Node ``u`` with probability ``p[u]`` adds
``p[u] * min(1, k / deg(u))`` to each of its neighbours: one scatter-add
over the edges, here ``index_add_``.  Its summation order is not that of
JAX's ``segment_sum``, so results agree within fp32 rounding, not bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["cal_neighbor_prob", "sample_prob"]


def cal_neighbor_prob(indptr: torch.Tensor, indices: torch.Tensor,
                      last_prob: torch.Tensor, k: int,
                      num_edges: Optional[int] = None) -> torch.Tensor:
    """One layer of the recurrence.  ``last_prob`` is ``[N]`` fp32;
    ``indptr``/``indices`` may be padded beyond ``N + 1``/``num_edges``
    (``CSRTopo.to_device``)."""
    n = last_prob.shape[0]
    e = indices.shape[0] if num_edges is None else num_edges
    indptr, indices = indptr[: n + 1], indices[:e]
    deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
    # k over a tensor divides; a Python numerator would be a reciprocal
    kf = torch.full((), float(k), dtype=torch.float32, device=deg.device)
    w = last_prob * torch.clamp_max(kf / torch.clamp_min(deg, 1.0), 1.0)
    row_of_edge = torch.searchsorted(
        indptr, torch.arange(e, dtype=indptr.dtype, device=indptr.device),
        right=True) - 1
    return torch.zeros_like(last_prob).index_add_(
        0, indices.to(torch.int64), w[row_of_edge])


def sample_prob(indptr: torch.Tensor, indices: torch.Tensor, train_idx,
                total_node_count: int, sizes: Sequence[int],
                num_edges: Optional[int] = None) -> torch.Tensor:
    """The last layer's probability vector, fp32 ``[N]``, from 1.0 at
    ``train_idx`` through one :func:`cal_neighbor_prob` per fanout."""
    last = torch.zeros((total_node_count,), dtype=torch.float32,
                       device=indptr.device)
    last[torch.as_tensor(train_idx, dtype=torch.int64,
                         device=indptr.device)] = 1.0
    for k in sizes:
        last = cal_neighbor_prob(indptr, indices, last, k, num_edges)
    return last
