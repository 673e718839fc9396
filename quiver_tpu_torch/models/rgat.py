"""Relational GAT over heterogeneous sampled batches (counterpart of
``quiver_tpu/models/rgat.py``).

Per layer, each relation's block attends from its SRC type's frontier into
its DST targets (GAT-style, no self loop); the relations into a type are
summed, zero-padded to the longest target prefix, on top of a per-type
self transform; types with an incoming relation then take ReLU and
dropout, and the others keep their rows untouched.

Flax creates parameters as the layers first run; PyTorch needs them up
front, so the module is told which relations each layer has
(``HeteroGraphSageSampler.layer_relations()``).  The submodules keep the
Flax names (``proj_{t}``, ``self_{l}_{t}``, ``rel_{l}_{src}__{name}__{dst}``,
``classifier``) as keys of one ``nn.ModuleDict``, so parameters convert
both ways by name (``convert.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import _dropout, masked_softmax

__all__ = ["RGAT"]

Relation = Tuple[str, str, str]


def rel_name(layer: int, rel: Relation) -> str:
    s_t, name, d_t = rel
    return f"rel_{layer}_{s_t}__{name}__{d_t}"


class _RelAttention(nn.Module):
    """One relation's multi-head attention over a dense block."""

    def __init__(self, dim: int, heads: int, device):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.w_src = nn.Linear(dim, dim, bias=False, device=device)
        self.w_dst = nn.Linear(dim, dim, bias=False, device=device)
        self.att_src = nn.Parameter(torch.empty(heads, self.head_dim,
                                                device=device))
        self.att_dst = nn.Parameter(torch.empty(heads, self.head_dim,
                                                device=device))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor,
                block) -> torch.Tensor:
        h, f = self.heads, self.head_dim
        t, k = block.nbr_local.shape
        w_src = self.w_src(x_src).view(-1, h, f)
        w_dst = self.w_dst(x_dst[:t]).view(t, h, f)
        nbr = w_src.index_select(0, block.nbr_local.reshape(-1))
        nbr = nbr.view(t, k, h, f)                          # [T, k, H, F]
        e = F.leaky_relu((nbr * self.att_src).sum(-1)
                         + (w_dst * self.att_dst).sum(-1)[:, None], 0.2)
        # a target with every slot masked (no employer sampled) gets 0
        alpha = masked_softmax(e, block.mask[..., None])    # [T, k, H]
        return (alpha[..., None] * nbr).sum(dim=1).reshape(t, h * f)


class RGAT(nn.Module):
    """Hetero R-GAT.

    Args:
      in_dims: feature width per node type (every type gets a projection).
      hidden: width of every layer (``heads * head_dim``).
      out_dim: classifier width, applied to the seed type's first
        ``batch_size`` rows.
      num_layers: the sampler's hop count.
      layer_relations: per layer, outermost first, the relations whose
        blocks that layer receives
        (``HeteroGraphSageSampler.layer_relations()``).
      heads: attention heads.
      dropout: dropout after each layer's ReLU.
      device: where the parameters live (``None``: the card).
    """

    def __init__(self, in_dims: Dict[str, int], hidden: int, out_dim: int,
                 num_layers: int,
                 layer_relations: Sequence[Sequence[Relation]],
                 heads: int = 4, dropout: float = 0.5, device=None):
        super().__init__()
        if len(layer_relations) != num_layers:
            raise ValueError(f"{len(layer_relations)} layers of relations "
                             f"for {num_layers} layers")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of {heads} "
                             "heads")
        dev = resolve_device(device)
        self.num_layers, self.dropout = num_layers, dropout
        self.layer_relations = tuple(tuple(map(tuple, rels))
                                     for rels in layer_relations)
        mods = {f"proj_{t}": nn.Linear(d, hidden, device=dev)
                for t, d in in_dims.items()}
        for l, rels in enumerate(self.layer_relations):
            for rel in rels:
                mods.setdefault(f"self_{l}_{rel[2]}",
                                nn.Linear(hidden, hidden, device=dev))
            for rel in rels:
                mods[rel_name(l, rel)] = _RelAttention(hidden, heads, dev)
        mods["classifier"] = nn.Linear(hidden, out_dim, device=dev)
        bad = [n for n in mods if "." in n]
        if bad:
            raise ValueError(f"node type and relation names may not hold "
                             f"'.': {bad}")
        self.mods = nn.ModuleDict(mods)

    def forward(self, xs: Dict[str, torch.Tensor], batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``xs``: rows of every type's frontier (``HeteroFeature.lookup``);
        ``batch``: the :class:`HeteroSampledBatch`.  In training, dropout
        masks come from ``generator``."""
        if len(batch.layers) != self.num_layers:
            raise ValueError(
                f"{len(batch.layers)} layers for {self.num_layers}")
        h = {t: self.mods[f"proj_{t}"](x) for t, x in xs.items()}
        for l, hop_blocks in enumerate(batch.layers):
            tgt_len: Dict[str, int] = {}
            for blk in hop_blocks:
                d_t = blk.relation[2]
                tgt_len[d_t] = max(tgt_len.get(d_t, 0),
                                   blk.nbr_local.shape[0])
            new_h = {t: self.mods[f"self_{l}_{t}"](h[t][:n])
                     for t, n in tgt_len.items()}
            for blk in hop_blocks:
                s_t, _, d_t = blk.relation
                name = rel_name(l, blk.relation)
                if name not in self.mods:
                    raise ValueError(f"layer {l} has no relation "
                                     f"{blk.relation!r}")
                agg = self.mods[name](h[s_t], h[d_t], blk)
                pad = tgt_len[d_t] - agg.shape[0]
                if pad:
                    agg = F.pad(agg, (0, 0, 0, pad))
                new_h[d_t] = new_h[d_t] + agg
            for t in h:
                if t in new_h:
                    new_h[t] = _dropout(F.relu(new_h[t]), self.dropout,
                                        self.training, generator)
                else:
                    new_h[t] = h[t]
            h = new_h
        return self.mods["classifier"](h[batch.seed_type][:batch.batch_size])
