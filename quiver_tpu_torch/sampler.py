"""Multi-hop GraphSAGE sampler (counterpart of ``quiver_tpu/sampler.py``).

Returns a :class:`SampledBatch` of dense ``[T, k]`` blocks with the
positional relabel of the JAX package's ``dedup="none"`` pipeline: the
hop-l frontier is ``concat(prev_frontier, sampled_nbrs.flat)`` and
neighbour j of target b sits at position ``P_prev + b*k + j``.  No sort, no
hash table; duplicate nodes stay duplicated.

Key words: the JAX pipeline splits one key per hop and folds each into two
uint32 words.  The port takes those words directly, ``[L, 2]`` uint32, one
pair per hop, so the same words give the same batch in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import resolve_gather_mode
from .ops.sample import key_words_pair, run_hop
from .ops.cuda.window_sample import window_sample_frontier
from .utils.device import resolve_device
from .utils.topology import CSRTopo

__all__ = ["GraphSageSampler", "SampledBatch", "LayerBlock", "run_pipeline"]


class LayerBlock(NamedTuple):
    """One message-passing layer's bipartite block, dense form.  Targets
    are the first ``num_targets`` entries of the previous (inner) frontier;
    ``nbr_local[b, j]`` indexes this layer's frontier."""

    nbr_local: torch.Tensor    # [T, k] int32 indices into this layer's n_id
    mask: torch.Tensor         # [T, k] bool
    num_targets: torch.Tensor  # scalar int32 (valid targets; T is the pad)
    eid: Optional[torch.Tensor] = None  # [T, k] int32 edge ids (-1 pad)


class SampledBatch(NamedTuple):
    n_id: torch.Tensor       # [P] int32 outermost frontier, padded
    n_id_mask: torch.Tensor  # [P] bool
    num_nodes: torch.Tensor  # scalar int32
    batch_size: int          # number of seed nodes
    layers: Tuple[LayerBlock, ...]  # outermost first (PyG adjs order)
    drops: Optional[torch.Tensor] = None  # [L] frontier-cap drops (all 0)

    def to_pyg_adjs(self):
        """Ragged ``(n_id, batch_size, [Adj])`` view on the host, each Adj
        ``(edge_index[2, e], e_id[e], (n_src, n_dst))``.  Sizes are the
        padded frontier lengths: each hop's targets are a prefix of its
        sources, so PyG's ``x = x[:size[1]]`` loop slices exactly."""
        adjs = []
        n_src = int(self.n_id.shape[0])
        for blk in self.layers:
            m = blk.mask.cpu().numpy()
            nbr = blk.nbr_local.cpu().numpy()
            t, k = m.shape
            row = np.repeat(np.arange(t, dtype=np.int64), k).reshape(t, k)
            col = nbr.astype(np.int64)
            e = m.reshape(-1)
            edge_index = np.stack([col.reshape(-1)[e], row.reshape(-1)[e]])
            e_id = (blk.eid.cpu().numpy().reshape(-1)[e]
                    if blk.eid is not None else np.empty(0, np.int64))
            adjs.append((edge_index, e_id, (n_src, t)))
            n_src = t
        return self.n_id.cpu().numpy(), self.batch_size, adjs


def _sample_pipeline_nodedup(indptr, indices, seeds, key_words, sizes,
                             return_eid, gather_mode):
    """Multi-hop pipeline without dedup; one hop per layer.  Under
    ``"pwindow"`` each hop is one launch of kernel B1's pipeline entry,
    which also writes the hop's frontier tail, mask tail and local ids
    (:func:`_pwindow_pipeline`); every other mode runs the hop's element
    gathers (``ops/sample.py::sample_hop``) and builds those with torch
    ops, as the JAX pipeline does."""
    if gather_mode.startswith("pwindow"):
        return _pwindow_pipeline(indptr, indices, seeds, key_words, sizes,
                                 return_eid)
    dev = indptr.device
    B = seeds.shape[0]
    frontier = seeds.to(dev, torch.int32)
    fmask = torch.ones((B,), dtype=torch.bool, device=dev)
    blocks = []
    for l, k in enumerate(sizes):
        out = run_hop(indptr, indices, frontier, k,
                      *key_words_pair(key_words[l]), fmask, gather_mode)
        t = frontier.shape[0]
        pos = (t + torch.arange(t, dtype=torch.int32, device=dev)[:, None] * k
               + torch.arange(k, dtype=torch.int32, device=dev)[None, :])
        blocks.append(LayerBlock(
            nbr_local=torch.where(out.mask, pos, torch.zeros_like(pos)),
            mask=out.mask,
            num_targets=fmask.sum().to(torch.int32),
            eid=out.eid if return_eid else None,
        ))
        # masked slots enter the frontier as node 0 (nbrs holds -1 there)
        frontier = torch.cat(
            [frontier, torch.where(out.mask, out.nbrs,
                                   torch.zeros_like(out.nbrs)).reshape(-1)])
        fmask = torch.cat([fmask, out.mask.reshape(-1)])
    num_nodes = fmask.sum().to(torch.int32)
    drops = torch.zeros((len(sizes),), dtype=torch.int32, device=dev)
    return frontier, fmask, num_nodes, tuple(blocks[::-1]), drops


def _pwindow_pipeline(indptr, indices, seeds, key_words, sizes, return_eid):
    """The positional pipeline through B1's pipeline entry: the frontier
    and its mask are allocated once at their final length ``B * prod(1 +
    k)``, the seeds copied in, and hop l reads ``frontier[:t]`` and writes
    ``frontier[t : t + t*k]`` and its mask in its one launch.  Each block's
    mask is a view of the frontier mask, which nothing writes again; the
    target counts are views of one running count of that mask, taken after
    the last hop, so a hop launches nothing but B1."""
    dev = indptr.device
    t = seeds.shape[0]
    total = t
    for k in sizes:
        total *= 1 + k
    frontier = torch.empty((total,), dtype=torch.int32, device=dev)
    fmask = torch.empty((total,), dtype=torch.bool, device=dev)
    frontier[:t].copy_(seeds)
    fmask[:t] = True
    hops, starts = [], []
    for l, k in enumerate(sizes):
        hops.append(window_sample_frontier(indptr, indices, frontier, fmask,
                                           t, k,
                                           *key_words_pair(key_words[l]),
                                           return_eid))
        starts.append(t)
        t += t * k
    # live[i]: valid ids in frontier[:i]
    live = torch.empty((total + 1,), dtype=torch.int32, device=dev)
    live[:1] = 0  # a fill: a 0-d store would copy from pageable memory
    torch.cumsum(fmask, 0, dtype=torch.int32, out=live[1:])
    blocks = [LayerBlock(nbr_local=h.nbr_local, mask=h.mask,
                         num_targets=live[s], eid=h.eid)
              for h, s in zip(hops, starts)]
    drops = torch.zeros((len(sizes),), dtype=torch.int32, device=dev)
    return frontier, fmask, live[total], tuple(blocks[::-1]), drops


def run_pipeline(dedup, indptr, indices, seeds, key_words, sizes,
                 return_eid=False, gather_mode="auto"):
    """Multi-hop sampling; ``key_words`` is ``[L, 2]`` uint32 and
    ``gather_mode`` is resolved here (``config.resolve_gather_mode``).
    Only the positional ``dedup="none"`` pipeline is ported."""
    if dedup != "none":
        raise NotImplementedError(
            f"dedup={dedup!r} is not ported yet (ROADMAP A7); use 'none'")
    key_words = np.asarray(key_words, dtype=np.uint32).reshape(-1, 2)
    if key_words.shape[0] != len(sizes):
        raise ValueError(f"{key_words.shape[0]} key-word pairs for "
                         f"{len(sizes)} hops")
    return _sample_pipeline_nodedup(indptr, indices, seeds, key_words,
                                    sizes, return_eid,
                                    resolve_gather_mode(gather_mode))


class GraphSageSampler:
    """K-hop neighbour sampler over a CSR graph on the card.

    Args:
      csr_topo: :class:`CSRTopo`.
      sizes: fanout per layer, outward order, e.g. ``[25, 10]``.
      device: where the topology lives and hops run (``None``: the card).
      mode: ``"GPU"``, the reference's name for the device mode.  The host
        sampler (``"CPU"``) is not ported yet.
      return_eid: fill ``LayerBlock.eid`` with global edge positions.
      seed: seed of the generator that draws key words when a call gives
        none.
      gather_mode: how each hop reads ``indptr`` and ``indices``
        (``config.resolve_gather_mode``): ``"auto"``/``"pwindow"`` is the
        fused hop of kernel B1, ``"pallas"`` kernel B3, ``"lanes_fused"``
        kernel B4 (its fused entry, with no row gather), ``"lanes"`` and
        ``"xla"`` plain PyTorch.  Every mode samples the same neighbours.
    """

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int], device=None,
                 mode: str = "GPU", return_eid: bool = False, seed: int = 0,
                 gather_mode: str = "auto"):
        if mode != "GPU":
            raise NotImplementedError(
                f"mode={mode!r}: only the device mode 'GPU' is ported "
                "(the host sampler is ROADMAP A10)")
        self.device = resolve_device(device)
        self.gather_mode = resolve_gather_mode(gather_mode)
        self.csr_topo = csr_topo
        self.sizes = list(sizes)
        self.mode = mode
        self.dedup = "none"
        self.return_eid = return_eid
        self._rng = np.random.default_rng(seed)
        csr_topo.to_device(self.device)

    def draw_key_words(self) -> np.ndarray:
        """``[L, 2]`` uint32 key words from the sampler's own generator."""
        return self._rng.integers(0, 2**32, size=(len(self.sizes), 2),
                                  dtype=np.uint32)

    def seed_tensor(self, input_nodes) -> torch.Tensor:
        if isinstance(input_nodes, torch.Tensor):
            return input_nodes.to(self.device, torch.int32)
        ids = np.asarray(input_nodes)
        n = self.csr_topo.node_count
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"node ids must lie in [0, {n})")
        return torch.from_numpy(ids.astype(np.int32)).to(self.device)

    def sample(self, input_nodes, key_words=None) -> SampledBatch:
        """Sample the k-hop neighbourhood of ``input_nodes`` under per-hop
        ``key_words`` (``[L, 2]`` uint32; drawn here when ``None``)."""
        if key_words is None:
            key_words = self.draw_key_words()
        seeds = self.seed_tensor(input_nodes)
        indptr, indices = self.csr_topo.to_device(self.device)
        n_id, n_mask, num_nodes, blocks, drops = run_pipeline(
            self.dedup, indptr, indices, seeds, key_words, self.sizes,
            return_eid=self.return_eid, gather_mode=self.gather_mode)
        return SampledBatch(n_id=n_id, n_id_mask=n_mask, num_nodes=num_nodes,
                            batch_size=int(seeds.shape[0]), layers=blocks,
                            drops=drops)

    def __repr__(self):
        return (f"GraphSageSampler(sizes={self.sizes}, mode={self.mode!r}, "
                f"gather={self.gather_mode!r}, device={self.device}, "
                f"graph={self.csr_topo!r})")
