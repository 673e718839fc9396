"""GCN over sampled dense blocks (counterpart of
``quiver_tpu/models/gcn.py``).

Under neighbour sampling the symmetric normalisation is taken per block
from the sampled counts, as the JAX package does: each target's masked
neighbour sum and its own row are scaled by ``1/sqrt(deg_sampled + 1)``,
the sum before the self row is added and the total after.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import _dropout, dense

__all__ = ["GCNConv", "GCN"]


class GCNConv(nn.Module):
    """``norm * (norm * sum_{masked} W x_u + W x_v)`` with ``W`` biased and
    ``norm = 1/sqrt(deg_sampled + 1)``; parameters on ``device`` (``None``:
    the card), ``dtype`` the compute dtype of ``W``."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.lin = nn.Linear(in_features, out_features, bias=True,
                             device=resolve_device(device))

    def forward(self, x: torch.Tensor, block) -> torch.Tensor:
        t, k = block.nbr_local.shape
        w = dense(self.lin, x, self.dtype)
        w_src = w.index_select(0, block.nbr_local.reshape(-1))
        w_src = w_src.view(t, k, w.shape[1])                # [T, k, F]
        m = block.mask.to(x.dtype)[..., None]
        deg = block.mask.sum(dim=1).to(x.dtype)             # [T]
        norm = (1.0 / torch.sqrt(deg + 1.0))[:, None]
        agg = (w_src * m).sum(dim=1) * norm
        return (agg + w[:t]) * norm


class GCN(nn.Module):
    """``num_layers`` GCNConvs with ReLU and dropout between them;
    ``in_dim`` is the input width, parameters on ``device`` (``None``: the
    card), ``dtype`` the layers' compute dtype."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.5, device=None,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers, self.dropout = num_layers, dropout
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], device=dev, dtype=dtype)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor, blocks: Sequence,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``blocks`` outermost first; dropout masks in training come from
        ``generator``."""
        if len(blocks) != self.num_layers:
            raise ValueError(
                f"{len(blocks)} blocks for {self.num_layers} layers")
        for i, blk in enumerate(blocks):
            x = self.convs[i](x, blk)
            if i != self.num_layers - 1:
                x = _dropout(F.relu(x), self.dropout, self.training,
                             generator)
        return x
