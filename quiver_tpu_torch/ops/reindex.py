"""Frontier dedup and relabel (counterpart of ``quiver_tpu/ops/reindex.py``).

Given a hop's seeds and their sampled neighbours, returns ``n_id``, the
frontier without duplicates, seeds first (``n_id[:B] == seeds``), and the
neighbours relabelled to positions in it: the contract of the reference's
ordered hash table (``reindex.cu.hpp``).  As in the JAX package it is a
sort, a search and a compacting scatter, so the non-seed nodes come out
sorted by id, and every output is bitwise equal to JAX's.

Shapes are static and nothing is read back to the host: the frontier is
padded to ``B + B*k`` with a count of its valid prefix.  So there is no
``torch.unique``, ``nonzero`` or ``masked_select`` here, each of which
returns a size that depends on the data and waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["reindex", "ReindexOut"]

_SENTINEL = 2**31 - 1


class ReindexOut(NamedTuple):
    n_id: torch.Tensor        # [B + B*k] int32, 0 beyond num_nodes
    num_nodes: torch.Tensor   # scalar int32: valid entries of n_id
    n_id_mask: torch.Tensor   # [B + B*k] bool
    local_nbrs: torch.Tensor  # [B, k] int32 positions in n_id (0 where ~mask)
    mask: torch.Tensor        # [B, k] bool, the sample's mask


def reindex(seeds: torch.Tensor, nbrs: torch.Tensor, mask: torch.Tensor,
            seed_mask: Optional[torch.Tensor] = None) -> ReindexOut:
    """Dedup ``seeds`` and ``nbrs`` together and relabel ``nbrs`` to
    positions in the frontier.

    Args:
      seeds: ``[B]`` int32.  Seeds where ``seed_mask`` is False keep their
        slot in ``n_id`` (as 0), so local ids stay aligned across layers,
        and match no neighbour.
      nbrs: ``[B, k]`` int32 (a hop's ``SampleOut.nbrs``).
      mask: ``[B, k]`` bool.

    A neighbour equal to several seeds (a padded batch repeats its first
    id) takes the first of them: the sort of the seeds is stable.
    """
    seeds = seeds.to(torch.int32)
    dev = seeds.device
    B, k = nbrs.shape
    flatn = nbrs.reshape(-1).to(torch.int32)
    flatm = mask.reshape(-1)
    if seed_mask is None:
        seed_mask = torch.ones((B,), dtype=torch.bool, device=dev)
    sent = torch.full((), _SENTINEL, dtype=torch.int32, device=dev)

    # membership of each neighbour in the seeds, by binary search over the
    # sorted seeds; masked seeds sort last, as the sentinel, and match none
    seed_key = torch.where(seed_mask, seeds, sent)
    order = torch.argsort(seed_key, stable=True)
    seeds_sorted = seed_key[order]
    locc = torch.clamp_max(torch.searchsorted(seeds_sorted, flatn), B - 1)
    in_seeds = (seeds_sorted[locc] == flatn) & flatm
    seed_local = order[locc].to(torch.int32)

    # the distinct non-seed neighbours, sorted, compacted into a [B*k]
    # buffer padded with the sentinel (slot B*k takes the dropped writes)
    rest = torch.where(flatm & ~in_seeds, flatn, sent)
    rest_sorted = torch.sort(rest).values
    is_first = torch.ones_like(flatm)
    is_first[1:] = rest_sorted[1:] != rest_sorted[:-1]
    is_first &= rest_sorted != sent
    rank = torch.cumsum(is_first, 0) - 1
    num_rest = is_first.sum()
    uniq = torch.full((B * k + 1,), _SENTINEL, dtype=torch.int32, device=dev)
    uniq.scatter_(0, torch.where(is_first, rank, torch.full_like(rank, B * k)),
                  rest_sorted)
    uniq = uniq[: B * k]

    rest_local = B + torch.searchsorted(uniq, flatn).to(torch.int32)
    local = torch.where(in_seeds, seed_local, rest_local)
    local = torch.where(flatm, local, torch.zeros_like(local)).reshape(B, k)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_id = torch.cat([torch.where(seed_mask, seeds, zero),
                      torch.where(uniq == sent, zero, uniq)])
    n_id_mask = torch.cat([seed_mask, torch.arange(
        B * k, device=dev) < num_rest])
    return ReindexOut(n_id=n_id, num_nodes=n_id_mask.sum().to(torch.int32),
                      n_id_mask=n_id_mask, local_nbrs=local, mask=mask)
