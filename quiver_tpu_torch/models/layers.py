"""Dense-block GNN layers (counterpart of ``quiver_tpu/models/layers.py``).

Layers consume the sampler's dense ``[T, k]`` neighbour blocks: aggregation
is an index, a masked sum and a divide by ``max(count, 1)``, in plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["SAGEConv"]


class SAGEConv(nn.Module):
    """GraphSAGE mean aggregator: ``W_self x + W_nbr mean(x_N(v))``.

    With ``edge_feat [T, k, De]`` (rows of an edge-feature table gathered by
    ``LayerBlock.eid``) the neighbour half becomes
    ``W_nbr concat(mean x_N(v), mean e)``; the two means are taken apart, so
    no ``[T, k, D + De]`` tensor is built.  ``edge_dim`` sizes ``lin_nbr``
    for that concat.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, edge_dim: int = 0):
        super().__init__()
        self.lin_self = nn.Linear(in_features, out_features, bias=bias)
        self.lin_nbr = nn.Linear(in_features + edge_dim, out_features,
                                 bias=False)

    def forward(self, x: torch.Tensor, block,
                edge_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        t, k = block.nbr_local.shape
        x_src = x.index_select(0, block.nbr_local.reshape(-1))
        x_src = x_src.reshape(t, k, x.shape[1])              # [T, k, D]
        m = block.mask[..., None].to(x.dtype)
        cnt = torch.clamp_min(m.sum(dim=1), 1.0)             # [T, 1]
        mean_nbr = (x_src * m).sum(dim=1) / cnt              # [T, D]
        if edge_feat is not None:
            mean_e = (edge_feat.to(x.dtype) * m).sum(dim=1) / cnt
            mean_nbr = torch.cat([mean_nbr, mean_e], dim=-1)
        return self.lin_self(x[:t]) + self.lin_nbr(mean_nbr)
