"""GAT over sampled dense blocks (counterpart of
``quiver_tpu/models/gat.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import GATConv, _dropout

__all__ = ["GAT"]


class GAT(nn.Module):
    """``num_layers`` GATConvs: hidden layers with ``heads`` heads,
    concatenated (``heads * hidden`` wide), then ELU and dropout; the last
    layer one head, averaged, ``out_dim`` wide.  ``in_dim`` is the input
    width (the JAX module infers it); parameters live on ``device``
    (``None``: the card), ``dtype`` is the layers' compute dtype."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, heads: int = 4, dropout: float = 0.5,
                 device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers, self.heads, self.dropout = num_layers, heads, dropout
        convs, d = [], in_dim
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(GATConv(d, out_dim if last else hidden,
                                 heads=1 if last else heads,
                                 concat=not last, device=dev, dtype=dtype))
            d = hidden * heads
        self.convs = nn.ModuleList(convs)

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
                x = _dropout(F.elu(x), self.dropout, self.training,
                             generator)
        return x
