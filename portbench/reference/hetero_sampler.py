"""Plain reference of the heterogeneous positional sampler under the
counter hash, built from :func:`sampler.hop`.

Each node type keeps one positional frontier, the seeds first in the seed
type's.  At the start of a hop every type's frontier length is
snapshotted; then each relation ``(src, name, dst)`` of the hop, in the
order given, whose DST snapshot is not empty samples ``k`` SRC neighbours
for each DST entry of the snapshot (one :func:`sampler.hop` under the next
pair of key words, a dead entry counting as degree 0) and appends them, 0
where masked, to the SRC frontier.  A relation whose DST snapshot is empty
is skipped and takes no key words.  Neighbour ``j`` of target ``b`` lands
at ``base + b*k + j``, ``base`` being the SRC frontier's length before the
block.  Plain torch on any device; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .sampler import Hop, hop

Relation = Tuple[str, str, str]


class Block(NamedTuple):
    """One sampled (relation, hop) block; ``hop.nbr_local`` holds positions
    in the SRC frontier."""

    relation: Relation
    hop: Hop


class HeteroSampled(NamedTuple):
    n_id: Dict[str, torch.Tensor]    # per type: [P_t] int32, 0 where masked
    n_mask: Dict[str, torch.Tensor]  # per type: [P_t] bool
    hops: List[List[Block]]          # innermost (seeds) first
    batch_size: int
    seed_type: str


def sample(csr: Dict[Relation, Tuple[torch.Tensor, torch.Tensor]],
           node_types: Sequence[str], seed_type: str, seeds: torch.Tensor,
           sizes: Sequence[Sequence[Tuple[Relation, int]]],
           key_words) -> HeteroSampled:
    """The pipeline from ``seeds`` (``seed_type`` ids): ``csr`` maps each
    relation to its ``(indptr, indices)`` (DST rows, SRC neighbours);
    ``sizes`` holds one list of ``(relation, k)`` a hop, innermost first;
    ``key_words`` one uint32 pair a sampled block, in block order."""
    dev = seeds.device
    ids = {t: [] for t in node_types}
    masks = {t: [] for t in node_types}
    lens = {t: 0 for t in node_types}
    ids[seed_type].append(seeds.to(torch.int32))
    masks[seed_type].append(torch.ones(seeds.shape, dtype=torch.bool,
                                       device=dev))
    lens[seed_type] = int(seeds.shape[0])
    hops, i = [], 0
    for hop_sizes in sizes:
        snap = dict(lens)
        blocks = []
        for rel, k in hop_sizes:
            s_t, _, d_t = rel
            t = snap[d_t]
            if t == 0:
                continue
            frontier = torch.cat(ids[d_t])[:t]
            live = torch.cat(masks[d_t])[:t]
            indptr, indices = csr[rel]
            k0, k1 = (int(w) for w in key_words[i])
            i += 1
            mask, nbrs, eid = hop(indptr, indices, frontier, live, k, k0, k1)
            pos = (lens[s_t]
                   + torch.arange(t, dtype=torch.int32, device=dev)[:, None]
                   * k + torch.arange(k, dtype=torch.int32, device=dev)[None])
            blocks.append(Block(rel, Hop(
                t=t, k=k, live=live, mask=mask,
                nbr_local=torch.where(mask, pos, torch.zeros_like(pos)),
                eid=eid)))
            ids[s_t].append(nbrs.reshape(-1))
            masks[s_t].append(mask.reshape(-1))
            lens[s_t] += t * k
        hops.append(blocks)
    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
    empty_b = torch.zeros(0, dtype=torch.bool, device=dev)
    return HeteroSampled(
        n_id={t: torch.cat(ids[t]) if ids[t] else empty_i
              for t in node_types},
        n_mask={t: torch.cat(masks[t]) if masks[t] else empty_b
                for t in node_types},
        hops=hops, batch_size=int(seeds.shape[0]), seed_type=seed_type)
