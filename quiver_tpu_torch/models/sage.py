"""GraphSAGE over sampled dense blocks (counterpart of
``quiver_tpu/models/sage.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import SAGEConv, _dropout

__all__ = ["GraphSAGE", "full_graph_inference"]


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConvs with ReLU and dropout between them.

    PyTorch needs the input width up front (``in_dim``); the JAX module
    infers it.  ``edge_dim`` > 0 sizes every layer for an edge-feature
    table passed to :meth:`forward`.  Parameters live on ``device``
    (``None``: the card); ``dtype`` (e.g. ``torch.bfloat16``) is the
    layers' compute dtype, parameters staying fp32.
    """

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 3, dropout: float = 0.5,
                 edge_dim: int = 0, device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], edge_dim=edge_dim, device=dev,
                     dtype=dtype)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor, blocks: Sequence,
                edge_feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``blocks`` outermost first; ``edge_feat_table [E, De]`` turns
        every layer edge-featured (sample with ``return_eid=True``).
        In training, dropout masks are drawn from ``generator`` (the train
        steps hold one; ``None`` is the global generator)."""
        if len(blocks) != self.num_layers:
            raise ValueError(
                f"{len(blocks)} blocks for {self.num_layers} layers")
        for i, blk in enumerate(blocks):
            efeat = None
            if edge_feat_table is not None:
                if blk.eid is None:
                    raise ValueError("edge_feat_table needs eid blocks: "
                                     "sample with return_eid=True")
                eid = torch.clamp_min(blk.eid, 0).to(torch.int64)
                efeat = edge_feat_table[eid]
            x = self.convs[i](x, blk, efeat)
            if i != self.num_layers - 1:
                x = F.relu(x)
                x = _dropout(x, self.dropout, self.training, generator)
        return x


def full_graph_inference(params, x, indptr, indices, num_layers: int,
                         edge_chunk: int = 4_000_000, device=None
                         ) -> torch.Tensor:
    """Exact layer-wise full-graph SAGE inference (legacy entry point).

    Delegates to :func:`quiver_tpu_torch.models.inference.
    full_graph_inference`, which also handles GCN/GAT layouts; kept so
    call sites of the form ``full_graph_inference(params, x, ip, ix, L)``
    keep working.  ``params`` is a GraphSAGE ``state_dict`` or module;
    ``device`` is where it runs (``None``: the card).
    """
    from .inference import full_graph_inference as _gi

    return _gi(params, x, indptr, indices, num_layers,
               edge_chunk=edge_chunk, device=device)
