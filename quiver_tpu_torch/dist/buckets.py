"""Fixed-capacity request buckets, the static-shape form of a ragged
exchange (the JAX package's ``_bucket``/``_scatter_ids`` in
``dist/hier.py``, inlined in ``dist/feature.py`` and ``dist/sampler.py``).

Each shard slots its queries into one bucket of ``cap`` slots per
destination, in query order; a query past its bucket's capacity
overflows and is counted, never silently dropped."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["bucket", "pack_ids"]


def bucket(owner: torch.Tensor, valid: torch.Tensor, n_dest: int,
           cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dest, overflow)``: each valid query's flat slot
    ``owner * cap + rank`` in ``[0, n_dest * cap)`` (``n_dest * cap``
    for an invalid or overflowed query) and its overflow flag."""
    owner = torch.where(valid, owner.to(torch.int64),
                        torch.full_like(owner, n_dest, dtype=torch.int64))
    onehot = owner[:, None] == torch.arange(n_dest, device=owner.device)
    rank_in = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    slot = torch.where(onehot, rank_in, torch.zeros_like(rank_in)).sum(1)
    overflow = valid & (slot >= cap)
    dest = torch.where(valid & ~overflow, owner * cap + slot,
                       torch.full_like(slot, n_dest * cap))
    return dest, overflow


def pack_ids(ids: torch.Tensor, dest: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """``int32 [n_slots]`` with ``id + 1`` at each query's slot and 0 in
    empty slots; queries at ``dest == n_slots`` are dropped."""
    buf = torch.zeros(n_slots + 1, dtype=torch.int32, device=ids.device)
    buf.index_add_(0, dest, (ids + 1).to(torch.int32))
    return buf[:n_slots]
