"""Dense-block GNN layers (counterpart of ``quiver_tpu/models/layers.py``).

Layers consume the sampler's dense ``[T, k]`` neighbour blocks: aggregation
is an index, a masked sum (a mean or an attention-weighted sum) in plain
PyTorch, as the JAX package leaves it to XLA.

``dtype=`` (e.g. ``torch.bfloat16``) casts as Flax's ``nn.Dense(dtype=)``
does: at each dense layer the input, weight and bias go to ``dtype`` and
the product and bias add run in it; parameters stay fp32, and masks,
means and attention keep the dtypes PyTorch's promotion gives them, as
JAX's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["SAGEConv", "GATConv", "masked_softmax", "dense"]


def dense(lin: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``lin(x)``, or with ``dtype`` Flax's ``nn.Dense(dtype=)``: input,
    weight and bias cast to ``dtype``, the product rounded to it, then the
    bias added in it."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(dtype)
    return y


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from ``generator``
    (``F.dropout`` takes none)."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class SAGEConv(nn.Module):
    """GraphSAGE mean aggregator: ``W_self x + W_nbr mean(x_N(v))``.

    With ``edge_feat [T, k, De]`` (rows of an edge-feature table gathered by
    ``LayerBlock.eid``) the neighbour half becomes
    ``W_nbr concat(mean x_N(v), mean e)``; the two means are taken apart, so
    no ``[T, k, D + De]`` tensor is built.  ``edge_dim`` sizes ``lin_nbr``
    for that concat.  Parameters live on ``device`` (``None``: the card);
    ``dtype`` is the compute dtype of the two dense layers.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, edge_dim: int = 0, device=None,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.lin_self = nn.Linear(in_features, out_features, bias=bias,
                                  device=dev)
        self.lin_nbr = nn.Linear(in_features + edge_dim, out_features,
                                 bias=False, device=dev)

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
        return (dense(self.lin_self, x[:t], self.dtype)
                + dense(self.lin_nbr, mean_nbr, self.dtype))


def masked_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over dim 1 of ``e`` where ``mask``, 0 elsewhere.  A row with
    no valid slot is all ``-inf`` before the softmax and NaN after it, as
    in JAX; the ``where`` on the forward value makes it 0, and its
    backward sends 0, not NaN, to every slot of such a row (a
    ``masked_fill`` of the gradient-carrying value would not)."""
    alpha = torch.softmax(torch.where(mask, e, float("-inf")), dim=1)
    return torch.where(mask, alpha, torch.zeros_like(alpha))


class GATConv(nn.Module):
    """Multi-head graph attention over a dense ``[T, k]`` block, with the
    self loop joined as slot ``k`` (PyG's ``GATConv(add_self_loops=True)``
    under neighbour sampling).

    The self loop's score uses ``att_src`` on the node's own row plus the
    target term, as in ``quiver_tpu/models/layers.py:98``.  Output
    ``[T, heads * out_features]`` (``concat``) or the mean over heads
    ``[T, out_features]``.  Parameters live on ``device`` (``None``: the
    card); ``dtype`` is the compute dtype of ``lin`` (the attention
    vectors stay fp32, so the scores promote to fp32, as in JAX).
    """

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.heads, self.out_features = heads, out_features
        self.concat, self.negative_slope = concat, negative_slope
        self.lin = nn.Linear(in_features, heads * out_features, bias=False,
                             device=dev)
        self.att_src = nn.Parameter(torch.empty(heads, out_features,
                                                device=dev))
        self.att_tgt = nn.Parameter(torch.empty(heads, out_features,
                                                device=dev))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_tgt)

    def forward(self, x: torch.Tensor, block) -> torch.Tensor:
        h, f = self.heads, self.out_features
        t, k = block.nbr_local.shape
        w = dense(self.lin, x, self.dtype).view(x.shape[0], h, f)
        w_src = w.index_select(0, block.nbr_local.reshape(-1))
        w_src = w_src.view(t, k, h, f)                      # [T, k, H, F]
        w_tgt = w[:t]                                       # [T, H, F]
        e_tgt = (w_tgt * self.att_tgt).sum(-1)              # [T, H]
        e_src = (w_src * self.att_src).sum(-1)              # [T, k, H]
        e_self = (w_tgt * self.att_src).sum(-1) + e_tgt     # [T, H]
        e = F.leaky_relu(torch.cat([e_src + e_tgt[:, None],
                                    e_self[:, None]], dim=1),
                         self.negative_slope)               # [T, k+1, H]
        mask = torch.cat([block.mask, torch.ones_like(block.mask[:, :1])],
                         dim=1)[..., None]
        alpha = masked_softmax(e, mask)
        # the neighbours' sum and the self loop's term apart: no
        # [T, k+1, H, F] concat of the values
        out = ((alpha[:, :k, :, None] * w_src).sum(dim=1)
               + alpha[:, k, :, None] * w_tgt)              # [T, H, F]
        if self.concat:
            return out.reshape(t, h * f)
        return out.mean(dim=1)
