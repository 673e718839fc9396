"""Exact full-graph layer-wise inference (counterpart of
``quiver_tpu/models/inference.py``) for :class:`GraphSAGE`, :class:`GCN`
and :class:`GAT`.

Every layer aggregates over ALL neighbours, the evaluation pass of PyG's
layer-wise ``inference()``.  The CSR's edges are streamed in chunks of
``edge_chunk``, so a graph whose ``[E, D]`` gather would not fit still
runs: segment sums are ``index_add_``, and GAT's softmax is the
numerically stable two-pass stream with a segment max
(``scatter_reduce(..., "amax")``) first.  The row of every edge is built
once on the host and copied to the device a chunk at a time.

CUDA's ``index_add_`` adds in no fixed order, so results agree with the
JAX package's and with a CPU run within a float tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["full_graph_inference"]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _edge_stream(indptr_np: np.ndarray, edge_chunk: int, dev):
    """A re-iterable stream of ``(lo, hi, rows)`` over the edges, ``rows``
    the CSR row of each edge of the chunk on ``dev``; the row expansion is
    built once (for 10^8 edges, a 400 MB host array)."""
    n = indptr_np.shape[0] - 1
    row_of_edge = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr_np))

    def stream():
        for lo in range(0, row_of_edge.shape[0], edge_chunk):
            hi = min(lo + edge_chunk, row_of_edge.shape[0])
            yield lo, hi, torch.from_numpy(row_of_edge[lo:hi]).to(dev)

    return stream


def _sage(p, num_layers, x, stream, cols, deg):
    for i in range(num_layers):
        pre = f"convs.{i}"
        acc = torch.zeros_like(x)
        for lo, hi, rows in stream():
            acc.index_add_(0, rows, x.index_select(0, cols[lo:hi]))
        mean_nbr = acc / torch.clamp_min(deg, 1.0)[:, None]
        x = (F.linear(x, p[f"{pre}.lin_self.weight"],
                      p.get(f"{pre}.lin_self.bias"))
             + F.linear(mean_nbr, p[f"{pre}.lin_nbr.weight"]))
        if i != num_layers - 1:
            x = F.relu(x)
    return x


def _gcn(p, num_layers, x, stream, cols, deg):
    # the symmetric normalisation with self loops that the sampled GCNConv
    # approximates: out_v = sum_{u in N(v) + v} w_u / sqrt((d_u+1)(d_v+1))
    norm = (1.0 / torch.sqrt(deg + 1.0))[:, None]
    for i in range(num_layers):
        pre = f"convs.{i}.lin"
        wn = F.linear(x, p[f"{pre}.weight"], p[f"{pre}.bias"]) * norm
        acc = torch.zeros_like(wn)
        for lo, hi, rows in stream():
            acc.index_add_(0, rows, wn.index_select(0, cols[lo:hi]))
        x = (acc + wn) * norm
        if i != num_layers - 1:
            x = F.relu(x)
    return x


def _gat(p, num_layers, heads, x, stream, cols):
    n, slope = x.shape[0], 0.2
    for i in range(num_layers):
        last = i == num_layers - 1
        pre = f"convs.{i}"
        h = 1 if last else heads
        wk = p[f"{pre}.lin.weight"]
        f = wk.shape[0] // h
        w = F.linear(x, wk).view(n, h, f)
        e_src = (w * p[f"{pre}.att_src"]).sum(-1)         # [N, H]
        e_tgt = (w * p[f"{pre}.att_tgt"]).sum(-1)         # [N, H]
        e_self = F.leaky_relu(e_src + e_tgt, slope)
        # pass 1: the segment max of the scores, self loop included
        m = e_self.clone()
        for lo, hi, rows in stream():
            e = F.leaky_relu(e_src.index_select(0, cols[lo:hi])
                             + e_tgt.index_select(0, rows), slope)
            m.scatter_reduce_(0, rows.to(torch.int64)[:, None].expand_as(e),
                              e, "amax", include_self=True)
        # pass 2: exp(e - m_v) * w_u and the denominator
        a_self = torch.exp(e_self - m)
        num = a_self[..., None] * w
        den = a_self
        for lo, hi, rows in stream():
            c = cols[lo:hi]
            e = F.leaky_relu(e_src.index_select(0, c)
                             + e_tgt.index_select(0, rows), slope)
            a = torch.exp(e - m.index_select(0, rows))
            num.index_add_(0, rows, a[..., None] * w.index_select(0, c))
            den.index_add_(0, rows, a)
        out = num / den[..., None]                        # [N, H, F]
        x = out.mean(dim=1) if last else F.elu(out.reshape(n, h * f))
    return x


def full_graph_inference(model, params=None, x=None, indptr=None,
                         indices=None, num_layers: int = None,
                         edge_chunk: int = 4_000_000, device=None
                         ) -> torch.Tensor:
    """Exact (no-sampling) logits ``[N, out_dim]`` of a trained model.

    Args:
      model: a :class:`GraphSAGE`, :class:`GCN` or :class:`GAT` (its type
        picks the layer math).  The legacy SAGE form
        ``full_graph_inference(params, x, indptr, indices, num_layers)``
        takes a GraphSAGE ``state_dict`` or module as ``params``.
      params: a ``state_dict`` of ``model``'s layout, or ``None`` for the
        module's own parameters.
      x: ``[N, D]`` features (host or device).
      indptr / indices: the CSR (host arrays; the edges are streamed).
      num_layers: the legacy form's layer count.
      edge_chunk: edges per chunk; bounds the ``[chunk, D]`` gathers.
      device: where it runs (``None``: the card).
    """
    from .gat import GAT
    from .gcn import GCN
    from .sage import GraphSAGE

    if not isinstance(model, nn.Module) or not (
            params is None or isinstance(params, Mapping)):
        # legacy: (params, x, indptr, indices, num_layers)
        state = model
        num_layers = indices if num_layers is None else num_layers
        x, indptr, indices = params, x, indptr
        if num_layers is None:
            raise ValueError("the legacy form needs num_layers")
        if isinstance(state, nn.Module):
            if not isinstance(state, GraphSAGE):
                raise TypeError("the legacy form is GraphSAGE's; pass "
                                f"{type(state).__name__} as the model")
            state = state.state_dict()
        kind = "sage"
    else:
        kinds = ((GraphSAGE, "sage"), (GCN, "gcn"), (GAT, "gat"))
        kind = next((k for cls, k in kinds if isinstance(model, cls)), None)
        if kind is None:
            raise TypeError(f"unsupported model type {type(model).__name__}")
        state = model.state_dict() if params is None else params
        num_layers = model.num_layers

    dev = resolve_device(device)
    with torch.no_grad():
        p = {k: v.detach().to(dev) for k, v in state.items()}
        n = int(x.shape[0])
        indptr_np = _host(indptr)[: n + 1].astype(np.int64)
        cols = torch.from_numpy(
            _host(indices)[: int(indptr_np[-1])].astype(np.int32)).to(dev)
        deg = torch.from_numpy(np.diff(indptr_np).astype(np.float32)).to(dev)
        x = torch.as_tensor(x).to(dev, torch.float32)
        stream = _edge_stream(indptr_np, edge_chunk, dev)
        if kind == "sage":
            return _sage(p, num_layers, x, stream, cols, deg)
        if kind == "gcn":
            return _gcn(p, num_layers, x, stream, cols, deg)
        return _gat(p, num_layers, model.heads, x, stream, cols)
