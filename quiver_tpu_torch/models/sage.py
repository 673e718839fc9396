"""GraphSAGE over sampled dense blocks (counterpart of
``quiver_tpu/models/sage.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.sage_act import SageAct
from ..ops.cuda.sage_act_mean import SageActMean
from ..utils.device import resolve_device
from .layers import SAGEConv, _dropout

__all__ = ["GraphSAGE", "full_graph_inference"]


def _act_kernel_takes(x: torch.Tensor) -> bool:
    """Whether ``sage_act``'s kernel runs on the device of ``x`` (the
    model's input, where every addend lies): the card's."""
    return x.is_cuda


def _fuses(block, a: torch.Tensor, edge_feat_table) -> bool:
    """Whether the activation of ``a`` (a hidden layer's addend) takes the
    next layer's neighbour mean with it: ``block``, the next layer's,
    declares the positional layout (its producer's word, never inferred
    from shapes: a deduped frontier may have the same length), carries
    no edge features, and ``a`` has its ``T * (1 + k)`` rows."""
    if not getattr(block, "positional", False) or edge_feat_table is not None:
        return False
    t, k = block.mask.shape
    return a.shape[0] == t * (1 + k)


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConvs with ReLU and dropout between them.

    In training with dropout on the card, a hidden layer's add, ReLU and
    dropout are one ``sage_act`` kernel forward and one backward
    (:class:`~quiver_tpu_torch.ops.cuda.sage_act.SageAct`), bitwise the op
    chain that runs everywhere else (evaluation, ``dropout=0``, the CPU).
    Where the next layer's block is positional (the no-dedup pipelines')
    and no edge features are given, the activation and the next layer's
    neighbour mean are one kernel each way instead
    (:class:`~quiver_tpu_torch.ops.cuda.sage_act_mean.SageActMean`), so
    the hidden activation and its gradient are never written; bitwise the
    same.  On these routes the hidden convs' :meth:`SAGEConv.addends` runs
    in place of their ``forward``, so their forward hooks do not fire.

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
        last = self.num_layers - 1
        kernel = self.training and self.dropout > 0 and _act_kernel_takes(x)
        agg = None  # layer i's (mean, self rows), where layer i - 1 took them
        for i, blk in enumerate(blocks):
            efeat = None
            if edge_feat_table is not None:
                if blk.eid is None:
                    raise ValueError("edge_feat_table needs eid blocks: "
                                     "sample with return_eid=True")
                eid = torch.clamp_min(blk.eid, 0).to(torch.int64)
                efeat = edge_feat_table[eid]
            if i != last and kernel:
                # the keep mask drawn as _dropout draws it, then the add,
                # ReLU and dropout as one kernel and its backward as one,
                # with the next layer's mean where its block allows
                a, b = self.convs[i].addends(x, blk, efeat, agg)
                keep = torch.empty_like(a).bernoulli_(1.0 - self.dropout,
                                                      generator=generator)
                if _fuses(blocks[i + 1], a, edge_feat_table):
                    agg = SageActMean.apply(a, b, keep, self.dropout,
                                            blocks[i + 1].mask.contiguous())
                else:
                    x, agg = SageAct.apply(a, b, keep, self.dropout), None
                continue
            x = self.convs[i](x, blk, efeat, agg)
            if i != last:
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
