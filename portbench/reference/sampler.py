"""Plain reference of the positional k-hop sampler under the counter hash.

A frozen copy of the arithmetic the port documents for
``sample_rng="hash"`` with ``dedup="none"``: slot ``j`` of seed ``b``
draws from stratum ``[floor(j*deg/k), floor((j+1)*deg/k))`` with the
counter-hash uniform at counter ``b*k + j`` of the hop's two key words,
fp32 stratum bounds, and the positional relabel (neighbour ``j`` of
target ``b`` of a hop over ``t`` targets lands at ``t + b*k + j``).
Plain torch on any device; imports nothing of the program.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

PHI = 0x9E3779B9
MUL1 = 0x85EBCA6B
MUL2 = 0xC2B2AE35
M32 = 0xFFFFFFFF


class Hop(NamedTuple):
    """One hop over ``t`` targets at fanout ``k``."""

    t: int
    k: int
    live: torch.Tensor       # [t] bool: the targets' own mask
    mask: torch.Tensor       # [t, k] bool: valid slots
    nbr_local: torch.Tensor  # [t, k] int32, 0 where ~mask
    eid: torch.Tensor        # [t, k] int64 edge positions, -1 where ~mask


class Sampled(NamedTuple):
    n_id: torch.Tensor        # [P] int32, 0 where ~n_mask
    n_mask: torch.Tensor      # [P] bool
    hops: List[Hop]           # innermost (seeds) first


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # low 32 bits of x * c for x in [0, 2**32) held in int64, by 16-bit
    # halves of c so that no partial product passes 2**63
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x ^ (x >> 16), MUL1)
    x = _mul32(x ^ (x >> 13), MUL2)
    return x ^ (x >> 16)


def hash_uniform(k0: int, k1: int, n: int, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) at counters 0 .. n-1."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = _mul32(x, PHI)
    x = _fmix32(x ^ (int(k0) & M32))
    x = _fmix32(x ^ (int(k1) & M32))
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hop(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
        live: torch.Tensor, k: int, k0: int, k1: int):
    """``(mask, nbrs, eid)`` of one hop: ``[t, k]`` each, ``nbrs`` 0 and
    ``eid`` -1 where a slot is not valid."""
    dev = seeds.device
    s = seeds.to(torch.int64)
    start = indptr[s].to(torch.int64)
    deg = torch.where(live, indptr[s + 1].to(torch.int64) - start,
                      torch.zeros_like(start))
    t = seeds.shape[0]
    j = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    u = hash_uniform(k0, k1, t * k, dev).view(t, k)
    degf = deg.to(torch.float32)[:, None]
    # the divisor is a device tensor: true division, correctly rounded
    kf = torch.full((), float(k), dtype=torch.float32, device=dev)
    lo = torch.floor(j.to(torch.float32) * degf / kf)
    hi = torch.floor((j + 1).to(torch.float32) * degf / kf)
    strat = (lo + torch.floor(u * torch.clamp_min(hi - lo, 1.0))).to(
        torch.int64)
    pos = torch.where(deg[:, None] <= k, j, strat)
    pos = torch.minimum(pos, torch.clamp_min(deg[:, None] - 1, 0))
    mask = j < torch.clamp_max(deg, k)[:, None]
    eid = torch.where(mask, start[:, None] + pos, torch.full_like(pos, -1))
    nbrs = torch.where(mask, indices[eid.clamp_min(0)].to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=dev))
    return mask, nbrs, eid


def sample(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
           fanouts, key_words) -> Sampled:
    """The positional pipeline from ``seeds`` under per-hop ``key_words``
    (``[L, 2]`` uint32 words)."""
    dev = seeds.device
    frontier = seeds.to(torch.int32)
    fmask = torch.ones(frontier.shape, dtype=torch.bool, device=dev)
    hops = []
    for (k0, k1), k in zip(key_words, fanouts):
        t = frontier.shape[0]
        mask, nbrs, eid = hop(indptr, indices, frontier, fmask, k, int(k0),
                              int(k1))
        pos = (t + torch.arange(t, dtype=torch.int32, device=dev)[:, None] * k
               + torch.arange(k, dtype=torch.int32, device=dev)[None, :])
        hops.append(Hop(t=t, k=k, live=fmask, mask=mask,
                        nbr_local=torch.where(mask, pos, torch.zeros_like(pos)),
                        eid=eid))
        frontier = torch.cat([frontier, nbrs.reshape(-1)])
        fmask = torch.cat([fmask, mask.reshape(-1)])
    return Sampled(n_id=frontier, n_mask=fmask, hops=hops)
