"""Multi-hop GraphSAGE sampler (counterpart of ``quiver_tpu/sampler.py``).

Returns a :class:`SampledBatch` of dense ``[T, k]`` blocks under one of
the JAX package's two frontier rules (``dedup``):

- ``"none"`` (what ``"auto"`` resolves to): the positional relabel.  The
  hop-l frontier is ``concat(prev_frontier, sampled_nbrs.flat)`` and
  neighbour j of target b sits at position ``P_prev + b*k + j``.  No
  sort, no hash table; duplicate nodes stay duplicated.
- ``"hop"``: the reference's exact dedup every hop (``ops/reindex.py``),
  the frontier padded to ``T + T*k`` or cut to a ``frontier_caps`` entry;
  a cut masks the edges to the nodes it drops and counts them in
  ``SampledBatch.drops``.

With ``edge_weights`` every hop draws weight-proportionally
(``ops/sample.py::sample_neighbors_weighted``).

Keys: the JAX pipeline splits its batch key into one key per hop
(``jax.random.split(key, L)``).  ``sample(..., key=)`` takes that batch key
(two uint32 words: ``utils.rng.key(seed)``, or JAX's ``key_data``) and
splits it the same way, so one seed gives the neighbours JAX draws.  The
pipeline itself takes per-hop words, ``[L, 2]`` uint32
(``ops/sample.py::hop_key_words``): under ``sample_rng="hash"`` each hop
key folded into the counter hash's two words, under ``"key"`` the hop
key's raw data, whose threefry uniforms are JAX's.  ``key_words=`` passes
such words directly.

Two more modes sample on the host, as in the JAX package:

- ``mode="CPU"``: the native host sampler (``cpp/native.py``), exact dedup
  every hop, its RNG seeded from the sampler's own call counter (key words
  are not read).  The batch is copied to ``device``.
- ``mode="UVA"`` with a ``uva_budget``: the hot/cold split of ``uva.py``.
  Each hop's hot rows are sampled on the device from a compacted sub-CSR
  (kernel B1's literal entry under ``"auto"``), its cold rows by the
  native sampler meanwhile; the hop's key words drive the device tier and
  a third word per hop seeds the host tier (JAX seeds it with the last
  word of the hop's split key).

A :class:`~quiver_tpu_torch.stream.graph.StreamingGraph` in place of the
``CSRTopo`` samples through its current snapshot: the positional pipeline
with each hop drawn by ``ops/sample.py::sample_neighbors_overlay`` (base
CSR + delta CSR + tombstones, optional time windows), uniformly, on the
device.  Every path that samples the sampler's graph (``sample``, the
fused serving lane and the fused train step through :meth:`pipeline`)
reads the snapshot current when it starts; ``SampledBatch.version`` is its
graph version.

A streaming sampler keeps one pipeline entry a batch size and snapshot
shape (its relabel positions, made once) in a ``recovery.registry``
program cache under JAX's key, ``("stream", B, epad, delta_bucket,
has_ts, windowed)``: mutations within one delta bucket build nothing.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import resolve_dedup, resolve_sampling
from .cpp.native import CPUSampler
from .interop import to_torch_adjs
from .ops.cuda.window_sample import window_sample_frontier
from .ops.fastgather import pad_table_128
from .ops.prob import sample_prob
from .ops.reindex import ReindexOut, reindex
from .ops.sample import (SampleOut, hop_key_words, key_words_pair,
                         row_cumsum_weights, run_hop,
                         sample_neighbors_overlay, sample_neighbors_weighted)
from . import telemetry
from .recovery.registry import program_cache
from .utils import rng as _rng
from .utils.device import resolve_device
from .utils.staging import upload
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
    drops: Optional[torch.Tensor] = None  # [L] nodes frontier caps dropped
    version: Optional[int] = None  # a streaming graph's snapshot version

    def to_pyg_adjs(self):
        """Ragged ``(n_id, batch_size, [Adj])`` view on the host, each Adj
        ``(edge_index[2, e], e_id[e], (n_src, n_dst))``: the host copy of
        :func:`~quiver_tpu_torch.interop.to_torch_adjs`, with ``n_id`` in
        the batch's int32.  Sizes are the padded frontier lengths: each
        hop's targets are a prefix of its sources, so PyG's ``x =
        x[:size[1]]`` loop slices exactly."""
        _, bs, adjs = to_torch_adjs(self)
        # quiverlint: ignore[QT001] -- to_pyg_adjs is the host copy of a batch
        # by contract
        return self.n_id.cpu().numpy(), bs, [
            # quiverlint: ignore[QT001] -- to_pyg_adjs is the host copy of a
            # batch by contract
            (edge_index.cpu().numpy(), e_id.cpu().numpy(), size)
            for edge_index, e_id, size in adjs]


def _hop(indptr, indices, frontier, k, key_words, fmask, gather_mode,
         cum_weights, sample_rng) -> SampleOut:
    """One hop of the generic loop: weighted when ``cum_weights`` is
    given, else uniform (``run_hop``: B1's literal entry under
    ``"pwindow"``, and its keyed instance under ``"blocked[:U]"`` with
    ``"key"``)."""
    if cum_weights is not None:
        return sample_neighbors_weighted(indptr, indices, cum_weights,
                                         frontier, k, key_words, fmask,
                                         gather_mode, sample_rng=sample_rng)
    return run_hop(indptr, indices, frontier, k, *key_words_pair(key_words),
                   fmask, gather_mode, sample_rng)


def _sample_pipeline_nodedup(indptr, indices, seeds, key_words, sizes,
                             return_eid, gather_mode, cum_weights,
                             sample_rng):
    """Multi-hop pipeline without dedup; one hop per layer.  A uniform
    pipeline that kernel B1 draws (``"pwindow"`` under the hash,
    ``"blocked[:U]"`` under the key) runs each hop as one launch of B1's
    pipeline entry, which also writes the hop's frontier tail, mask tail
    and local ids (:func:`_pwindow_pipeline`); every other pipeline runs
    :func:`_hop` and builds those with torch ops, as the JAX pipeline
    does.  The two give the same batch: the entry's counter ``b*k + j``
    runs over ``frontier[:t]``, masked slots included, as the loop's
    ``[t, k]`` draw does."""
    fused = "blocked" if sample_rng == "key" else "pwindow"
    if cum_weights is None and gather_mode.startswith(fused):
        return _pwindow_pipeline(indptr, indices, seeds, key_words, sizes,
                                 return_eid, sample_rng)
    dev = indptr.device
    B = seeds.shape[0]
    frontier = seeds.to(dev, torch.int32)
    fmask = torch.ones((B,), dtype=torch.bool, device=dev)
    blocks = []
    for l, k in enumerate(sizes):
        out = _hop(indptr, indices, frontier, k, key_words[l], fmask,
                   gather_mode, cum_weights, sample_rng)
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


def _pwindow_pipeline(indptr, indices, seeds, key_words, sizes, return_eid,
                      sample_rng="hash"):
    """The positional pipeline through B1's pipeline entry, drawing by
    ``sample_rng`` (the hash's folded words or the key's raw words in
    ``key_words``): the frontier and its mask are allocated once at their
    final length ``B * prod(1 + k)``, the seeds copied in, and hop l reads
    ``frontier[:t]`` and writes ``frontier[t : t + t*k]`` and its mask in
    its one launch.  Each block's mask is a view of the frontier mask,
    which nothing writes again; the target counts are views of one running
    count of that mask, taken after the last hop, so a hop launches
    nothing but B1."""
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
                                           return_eid, sample_rng))
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


def _relabel_positions(B: int, sizes, dev) -> list:
    """Per hop, the positional relabel ``t + b*k + j`` of a pipeline from
    ``B`` seeds: where neighbour j of target b lands in the next
    frontier."""
    out, t = [], B
    for k in sizes:
        out.append(t + torch.arange(t, dtype=torch.int32, device=dev)[:, None]
                   * k + torch.arange(k, dtype=torch.int32,
                                      device=dev)[None, :])
        t += t * k
    return out


def _sample_pipeline_overlay(indptr, indices, overlay, seeds, key_words,
                             sizes, return_eid, gather_mode, sample_rng,
                             relabel=None):
    """The positional pipeline over base CSR + delta overlay
    (``quiver_tpu/sampler.py:155-190``): the generic loop of
    :func:`_sample_pipeline_nodedup` with each hop drawn by
    :func:`sample_neighbors_overlay`, so with an empty delta and no
    tombstones its outputs equal the frozen positional pipeline's.
    ``relabel`` is :func:`_relabel_positions` of this batch size (made
    here when not given)."""
    dev = indptr.device
    B = seeds.shape[0]
    if relabel is None:
        relabel = _relabel_positions(B, sizes, dev)
    window = None
    if overlay.get("windowed", False):
        window = (overlay["window_lo"], overlay["window_hi"])
    frontier = seeds.to(dev, torch.int32)
    fmask = torch.ones((B,), dtype=torch.bool, device=dev)
    blocks = []
    for l, k in enumerate(sizes):
        out = sample_neighbors_overlay(
            indptr, indices, overlay["tomb"], overlay["d_indptr"],
            overlay["d_indices"], frontier, k,
            *key_words_pair(key_words[l]), fmask,
            overlay.get("base_ts"), overlay.get("d_ts"), window,
            gather_mode, sample_rng)
        pos = relabel[l]
        blocks.append(LayerBlock(
            nbr_local=torch.where(out.mask, pos, torch.zeros_like(pos)),
            mask=out.mask,
            num_targets=fmask.sum().to(torch.int32),
            eid=out.eid if return_eid else None,
        ))
        frontier = torch.cat(
            [frontier, torch.where(out.mask, out.nbrs,
                                   torch.zeros_like(out.nbrs)).reshape(-1)])
        fmask = torch.cat([fmask, out.mask.reshape(-1)])
    num_nodes = fmask.sum().to(torch.int32)
    drops = torch.zeros((len(sizes),), dtype=torch.int32, device=dev)
    return frontier, fmask, num_nodes, tuple(blocks[::-1]), drops


def _sample_pipeline(indptr, indices, seeds, key_words, sizes, caps,
                     return_eid, gather_mode, cum_weights, sample_rng):
    """Multi-hop pipeline with exact dedup every hop
    (``quiver_tpu/sampler.py:201-248``): sample, :func:`reindex`, block.

    A cap below the deduped frontier's padded length keeps its prefix
    (the previous frontier, whole: a cap must be at least it), masks the
    edges to the nodes past it out of the hop's block (``eid`` -1 there)
    and counts those nodes in ``drops``, which stays on the device."""
    dev = indptr.device
    frontier = seeds.to(dev, torch.int32)
    fmask = torch.ones((frontier.shape[0],), dtype=torch.bool, device=dev)
    blocks, drops = [], []
    for l, (k, cap) in enumerate(zip(sizes, caps)):
        out = _hop(indptr, indices, frontier, k, key_words[l], fmask,
                   gather_mode, cum_weights, sample_rng)
        r = reindex(frontier, out.nbrs, out.mask, fmask)
        blk = LayerBlock(nbr_local=r.local_nbrs, mask=r.mask,
                         num_targets=fmask.sum().to(torch.int32),
                         eid=out.eid if return_eid else None)
        n_id, n_mask = r.n_id, r.n_id_mask
        drop = torch.zeros((), dtype=torch.int32, device=dev)
        if cap is not None and n_id.shape[0] > cap:
            drop = n_mask[cap:].sum().to(torch.int32)
            n_id, n_mask = n_id[:cap], n_mask[:cap]
            keep = blk.nbr_local < cap
            blk = blk._replace(
                mask=blk.mask & keep,
                nbr_local=torch.where(keep, blk.nbr_local,
                                      torch.zeros_like(blk.nbr_local)),
                eid=(torch.where(keep, blk.eid, torch.full_like(blk.eid, -1))
                     if blk.eid is not None else None))
        blocks.append(blk)
        drops.append(drop)
        frontier, fmask = n_id, n_mask
    num_nodes = fmask.sum().to(torch.int32)
    return frontier, fmask, num_nodes, tuple(blocks[::-1]), torch.stack(drops)


def _is_stream_graph(obj) -> bool:
    """A streaming graph (``stream.StreamingGraph``), told by its
    ``snapshot()`` and ``base``, as JAX tells it."""
    return hasattr(obj, "snapshot") and hasattr(obj, "base")


def run_pipeline(dedup, indptr, indices, seeds, key_words, sizes, caps=None,
                 return_eid=False, gather_mode="auto", cum_weights=None,
                 overlay=None, sample_rng="auto"):
    """Multi-hop sampling under ``dedup`` ``"none"`` or ``"hop"``.

    ``key_words`` is ``[L, 2]`` uint32, one pair a hop
    (``ops/sample.py::hop_key_words``); ``caps`` one frontier cap (or
    ``None``) per hop, read under ``"hop"`` only; ``gather_mode`` and
    ``sample_rng`` are resolved here (``config.resolve_sampling``; a
    uniform hop under ``"pwindow"`` with
    ``"key"`` raises, as in JAX); ``cum_weights`` (the 128-padded
    ``row_cumsum_weights`` on the device) makes every hop weighted.
    Returns ``(n_id, n_id_mask, num_nodes, blocks, drops)``.

    ``overlay`` (JAX's dict: ``tomb``, ``d_indptr``, ``d_indices``, and
    ``base_ts``, ``d_ts``, ``window_lo``, ``window_hi`` with ``windowed``
    true) samples a streaming snapshot over ``indptr``/``indices``: the
    positional pipeline only, uniform only, as in JAX."""
    if dedup not in ("none", "hop"):
        raise ValueError(f"dedup must be 'none' or 'hop', got {dedup!r}")
    key_words = np.asarray(key_words, dtype=np.uint32).reshape(-1, 2)
    if key_words.shape[0] != len(sizes):
        raise ValueError(f"{key_words.shape[0]} key-word pairs for "
                         f"{len(sizes)} hops")
    gather_mode, sample_rng = resolve_sampling(gather_mode, sample_rng)
    if overlay is not None:
        if dedup != "none":
            raise ValueError(
                "overlay sampling rides the positional pipeline only "
                f"(dedup='none'); got dedup={dedup!r}")
        if cum_weights is not None:
            raise ValueError("overlay sampling is uniform-only")
        return _sample_pipeline_overlay(indptr, indices, overlay, seeds,
                                        key_words, sizes, return_eid,
                                        gather_mode, sample_rng)
    if dedup == "none":
        return _sample_pipeline_nodedup(indptr, indices, seeds, key_words,
                                        sizes, return_eid, gather_mode,
                                        cum_weights, sample_rng)
    caps = [None] * len(sizes) if caps is None else list(caps)
    if len(caps) != len(sizes):
        raise ValueError(f"{len(caps)} frontier caps for {len(sizes)} hops")
    return _sample_pipeline(indptr, indices, seeds, key_words, sizes, caps,
                            return_eid, gather_mode, cum_weights, sample_rng)


class GraphSageSampler:
    """K-hop neighbour sampler over a CSR graph on the card.

    Args:
      csr_topo: :class:`CSRTopo`, or a ``stream.StreamingGraph``, sampled
        through its overlay (device mode, ``dedup="none"``, uniform:
        ``"CPU"``, ``"UVA"``, ``dedup="hop"`` and ``edge_weights`` raise).
      sizes: fanout per layer, outward order, e.g. ``[25, 10]``.
      device: where the topology lives and hops run (``None``: the card).
      mode: ``"GPU"`` (the device mode; JAX's ``"TPU"`` is an alias),
        ``"CPU"`` (the native host sampler, batches copied to ``device``)
        or ``"UVA"`` (the hot/cold split under ``uva_budget``; without a
        budget the device mode).
      return_eid: fill ``LayerBlock.eid`` with global edge positions.
      seed: seed of the generator that draws key words when a call gives
        neither ``key`` nor ``key_words``.
      gather_mode: how each hop reads ``indptr`` and ``indices``
        (``config.resolve_gather_mode``): ``"auto"``/``"pwindow"`` is the
        fused hop of kernel B1, ``"pallas"`` kernel B3, ``"lanes_fused"``
        kernel B4 (its fused entry, with no row gather), ``"blocked[:U]"``
        kernel B3 as well (``ops/blockgather.py``) under the hash and B1's
        keyed instance under the key, ``"lanes"`` and ``"xla"`` plain
        PyTorch.  Every mode samples the same neighbours.  Under
        ``sample_rng="key"``, ``"auto"`` is ``"blocked"``.
      dedup: ``"none"`` (the positional pipeline), ``"hop"`` (exact dedup
        every hop, ``ops/reindex.py``) or ``"auto"``
        (``config.resolve_dedup``).
      frontier_caps: per hop, a cap on the padded frontier or ``None``;
        read under ``dedup="hop"``.  Nodes past a cap are dropped and
        counted (:meth:`overflow_stats`).
      edge_weights: ``[E]`` weights; every hop then draws
        weight-proportionally, with replacement.
      sample_rng: ``"hash"`` (the counter hash), ``"key"`` (JAX's threefry
        uniforms of each hop key: drawn inside kernel B1 on a uniform
        ``"blocked[:U]"`` hop, what ``"auto"`` resolves to, else one
        launch of the threefry kernel a hop on the card) or ``"auto"``
        (``config.resolve_sample_rng``: the hash unless
        ``QUIVER_TPU_SAMPLE_RNG`` pins ``"key"``).  It reaches
        every device path: the pipeline, the overlay, ``sample_layer``,
        UVA's device tier, the fused steps and both serving lanes.
      uva_budget: device bytes for the hot rows' edge lists in UVA mode
        (``parse_size``).  UVA mode takes the positional pipeline only
        (``dedup="auto"`` resolves to ``"none"``) and refuses
        ``dedup="hop"``, ``edge_weights`` and ``return_eid``, as JAX does.
      uva_overlap: ``False`` waits for the device tier before the host
        tier runs (the serialized baseline).
      uva_timings: a dict that accumulates the host tier's seconds under
        ``"host_s"``.
    """

    def __init__(self, csr_topo: CSRTopo, sizes: Sequence[int], device=None,
                 mode: str = "GPU", return_eid: bool = False, seed: int = 0,
                 gather_mode: str = "auto", dedup: str = "auto",
                 frontier_caps: Optional[Sequence[Optional[int]]] = None,
                 edge_weights=None, sample_rng: str = "auto",
                 uva_budget: Union[int, str, None] = None,
                 uva_overlap: bool = True,
                 uva_timings: Optional[dict] = None):
        if mode not in ("GPU", "TPU", "CPU", "UVA"):
            raise ValueError(f"mode must be 'GPU', 'TPU', 'CPU' or 'UVA', "
                             f"got {mode!r}")
        if mode == "TPU":  # the JAX package's name for the device mode
            mode = "GPU"
        is_stream = _is_stream_graph(csr_topo)
        if is_stream:
            if mode != "GPU":
                raise ValueError(
                    f"StreamingGraph samples in the device mode only, got "
                    f"{mode!r} (compact to a frozen CSRTopo for CPU/UVA "
                    "sampling)")
            if dedup == "auto":
                dedup = "none"
        if mode == "UVA" and uva_budget is None:
            mode = "GPU"  # the whole graph fits the (unbounded) budget
        if mode == "UVA" and dedup == "auto":
            dedup = "none"
        self.sizes = list(sizes)
        self.frontier_caps = (list(frontier_caps) if frontier_caps is not None
                              else [None] * len(self.sizes))
        if len(self.frontier_caps) != len(self.sizes):
            raise ValueError(f"{len(self.frontier_caps)} frontier caps for "
                             f"{len(self.sizes)} hops")
        self.device = resolve_device(device)
        self.gather_mode, self.sample_rng = resolve_sampling(gather_mode,
                                                             sample_rng)
        self.dedup = resolve_dedup(dedup)
        if mode == "UVA" and (self.dedup != "none" or edge_weights is not None
                              or return_eid):
            raise ValueError(
                "UVA mode samples the positional pipeline, uniformly, "
                "without edge ids (hot-tier positions are sub-CSR local): "
                "dedup='hop', edge_weights and return_eid are refused")
        if is_stream and (self.dedup != "none" or edge_weights is not None):
            raise ValueError(
                "StreamingGraph: the positional pipeline (dedup='none') "
                "with uniform draws only; dedup='hop' and edge_weights are "
                "refused")
        # the serving loops and their caller sample from one sampler: this
        # guards the base/stream pair, the drops pair and the UVA graph
        # built at first use
        self._state_lock = threading.Lock()
        self.csr_topo = csr_topo  # the setter tells streaming from frozen
        self.mode = mode
        self.return_eid = return_eid
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._fanout_frac = 1.0
        self._edge_weights = edge_weights
        self.uva_budget = uva_budget
        self.uva_overlap = uva_overlap
        self.uva_timings = uva_timings
        self._uva = None
        self._cpu = (CPUSampler(csr_topo.indptr, csr_topo.indices,
                                edge_weights=edge_weights)
                     if mode == "CPU" else None)
        self._cum_weights = None
        if edge_weights is not None and mode == "GPU":
            cw = row_cumsum_weights(csr_topo.indptr, edge_weights)
            # the last value fills the pad: a clipped read past E is harmless
            # quiverlint: ignore[QT001] -- construction: the cumulative
            # weights are placed once
            self._cum_weights = torch.from_numpy(pad_table_128(
                cw, fill=float(cw[-1]) if len(cw) else None)).to(self.device)
        self.last_drops: Optional[torch.Tensor] = None
        self._drops_recorded = True
        # overlay pipeline entries, keyed as JAX keys its executables
        self._programs = program_cache("sampler", owner=self)
        if mode == "GPU":
            if self._stream is not None:
                self._stream.snapshot(self.device)  # warm the device view
            else:
                csr_topo.to_device(self.device)

    @property
    def csr_topo(self) -> CSRTopo:
        """The live base CSR.  For a streaming graph it follows the
        compactor's swaps; the single-hop helpers (``sample_layer``,
        ``sample_prob``) read it and so see the base without the pending
        overlay, as in JAX."""
        if self._stream is not None:
            return self._stream.base
        return self._csr_topo

    @csr_topo.setter
    def csr_topo(self, value) -> None:
        with self._state_lock:
            if _is_stream_graph(value):
                self._stream, self._csr_topo = value, None
            else:
                self._stream, self._csr_topo = None, value

    def draw_key_words(self) -> np.ndarray:
        """Key words from the sampler's own generator: ``[L, 2]`` uint32,
        or ``[L, 3]`` in UVA mode (the third word seeds each hop's host
        tier)."""
        width = 3 if self.mode == "UVA" else 2
        return self._rng.integers(0, 2**32, size=(len(self.sizes), width),
                                  dtype=np.uint32)

    def words_of_key(self, key) -> np.ndarray:
        """The per-hop words JAX's pipeline derives from the batch ``key``
        (two uint32 words): ``split(key, L)``, each hop key folded under
        ``"hash"`` or taken raw under ``"key"``; ``[L, 2]`` uint32, or
        ``[L, 3]`` in UVA mode, whose third word (each hop's host-tier
        seed) is the hop key's last word, as JAX seeds it
        (``quiver_tpu/uva.py:133-152``)."""
        keys = _rng.split(_rng.key_data(key), len(self.sizes))
        words = hop_key_words(keys, self.sample_rng)
        if self.mode == "UVA":
            return np.concatenate([words, keys[:, -1:]], axis=1)
        return words

    def seed_tensor(self, input_nodes) -> torch.Tensor:
        if isinstance(input_nodes, torch.Tensor):
            return input_nodes.to(self.device, torch.int32)
        return upload(self._host_seeds(input_nodes).astype(np.int32),
                      self.device)

    def _stream_entry(self, B: int):
        """The overlay pipeline of ``B`` seeds, its relabel positions made
        once.  Snapshot tensors are arguments, not bound: they change with
        every graph version, and the entry serves every version of one
        shape."""
        sizes, gm, ret_eid = self.sizes, self.gather_mode, self.return_eid
        srng = self.sample_rng
        relabel = _relabel_positions(B, sizes, self.device)

        def fn(indptr, indices, seeds, key_words, overlay):
            words = np.asarray(key_words, dtype=np.uint32).reshape(
                len(sizes), 2)
            return _sample_pipeline_overlay(indptr, indices, overlay, seeds,
                                            words, sizes, ret_eid, gm, srng,
                                            relabel)

        return fn

    def pipeline(self, seeds: torch.Tensor, key_words, weighted: bool = True,
                 snapshot=None, time_window=None):
        """``run_pipeline`` over this sampler's graph, fanouts, dedup,
        caps, gather mode, RNG and (when ``weighted``) edge weights, from
        ``seeds`` on the device under per-hop ``key_words``; returns its
        five outputs.

        A streaming sampler samples ``snapshot`` (the graph's current one
        when ``None``) through the overlay, restricted to ``time_window
        = (lo, hi)`` when given (the graph needs ``edge_ts``)."""
        if self._stream is None:
            if time_window is not None:
                raise ValueError(
                    "time_window requires a StreamingGraph with per-edge "
                    "timestamps (quiver_tpu_torch.stream)")
            B = int(seeds.shape[0])
            if B not in self._programs:
                # JAX's key: one entry a batch size (nothing is compiled;
                # the build guard and the registry count it as JAX does)
                # quiverlint: ignore[QT008, QT014] -- raw B is the
                # sampler's contract, as in JAX; one True per size, and
                # dict assignment is atomic
                self._programs[B] = True
            indptr, indices = self.csr_topo.to_device(self.device)
            return run_pipeline(
                self.dedup, indptr, indices, seeds, key_words, self.sizes,
                self.frontier_caps, return_eid=self.return_eid,
                gather_mode=self.gather_mode,
                cum_weights=self._cum_weights if weighted else None,
                sample_rng=self.sample_rng)
        B = int(seeds.shape[0])
        snap = (snapshot if snapshot is not None
                else self._stream.snapshot(self.device))
        windowed = time_window is not None
        if windowed and not snap.has_ts:
            raise ValueError("time_window needs a StreamingGraph "
                             "constructed with edge_ts")
        overlay = dict(tomb=snap.tomb, d_indptr=snap.d_indptr,
                       d_indices=snap.d_indices, base_ts=snap.base_ts,
                       d_ts=snap.d_ts, windowed=windowed)
        if windowed:
            # Python ints: compared as kernel arguments, never stored
            # into a device scalar (which would wait for the stream)
            overlay["window_lo"], overlay["window_hi"] = (
                int(time_window[0]), int(time_window[1]))
        key = ("stream", B, snap.epad, snap.delta_bucket, snap.has_ts,
               windowed)
        fn = self._programs.get(key)
        if fn is None:
            # two threads racing a new key both build; one entry is kept
            # (dict.setdefault is atomic, and both entries are the same
            # pipeline)
            # quiverlint: ignore[QT008, QT014] -- raw B is the sampler's
            # contract: one executable per seed-batch size, bit-stable
            # RNG per seed row (padding would consume extra key splits).
            # Serving pads upstream via _pad_ids; seal()/retrace_budget
            # guard the steady state.
            fn = self._programs.setdefault(key, self._stream_entry(B))
        return fn(snap.indptr, snap.indices, seeds, key_words, overlay)

    def sample(self, input_nodes, key_words=None, host_seeds=None,
               time_window=None, *, key=None) -> SampledBatch:
        """Sample the k-hop neighbourhood of ``input_nodes`` under the
        batch ``key`` (two uint32 words, ``utils.rng.key(seed)`` or JAX's
        ``key_data``: per hop the words :meth:`words_of_key` derives, so
        the batch is JAX's ``sample(input_nodes, key=...)``), or under
        per-hop ``key_words`` (``[L, 2]`` uint32), or words drawn here
        when neither is given.

        CPU mode reads no key words.  UVA mode takes ``[L, 2]`` words with
        ``host_seeds`` (``[L]``, each hop's host-tier seed) or ``[L, 3]``
        words whose last column is the host seeds.  A streaming sampler
        samples the graph's current snapshot (the batch's ``version``),
        restricted to edges with ``lo <= ts < hi`` under ``time_window =
        (lo, hi)``.

        Telemetry, as in the JAX package: each call folds into the
        ``sampler.sample`` span and ``sampler_sample_seconds{mode}`` (the
        device mode times the launches, not the card's work), and ticks
        ``sampler_batches_total{mode}`` and ``sampler_seeds_total{mode}``;
        ``mode`` is the sampler's mode in lower case (``gpu``, ``cpu``,
        ``uva``)."""
        mode = self.mode.lower()
        with telemetry.span("sampler.sample"), telemetry.histogram(
                "sampler_sample_seconds", mode=mode).time():
            batch = self._sample(input_nodes, key_words, host_seeds,
                                 time_window, key)
        telemetry.counter("sampler_batches_total", mode=mode).inc()
        telemetry.counter("sampler_seeds_total", mode=mode).inc(
            float(batch.batch_size))
        return batch

    def _sample(self, input_nodes, key_words, host_seeds,
                time_window=None, key=None) -> SampledBatch:
        if self._stream is None and time_window is not None:
            raise ValueError(
                "time_window requires a StreamingGraph with per-edge "
                "timestamps (quiver_tpu_torch.stream)")
        if self.mode == "CPU":
            return self._sample_cpu(input_nodes)
        if key is not None:
            if key_words is not None or host_seeds is not None:
                raise ValueError("pass key, or key_words (and host_seeds), "
                                 "not both")
            key_words = self.words_of_key(key)
        if key_words is None:
            key_words = self.draw_key_words()
        if self.mode == "UVA":
            return self._sample_uva(input_nodes, key_words, host_seeds)
        snap = (self._stream.snapshot(self.device)
                if self._stream is not None else None)
        seeds = self.seed_tensor(input_nodes)
        n_id, n_mask, num_nodes, blocks, drops = self.pipeline(
            seeds, key_words, snapshot=snap, time_window=time_window)
        # kept on the device until overflow_stats() reads it
        with self._state_lock:
            self.last_drops = drops
            self._drops_recorded = False
        return SampledBatch(n_id=n_id, n_id_mask=n_mask, num_nodes=num_nodes,
                            batch_size=int(seeds.shape[0]), layers=blocks,
                            drops=drops,
                            version=None if snap is None else snap.version)

    def overflow_stats(self, batch: Optional[SampledBatch] = None
                       ) -> Optional[np.ndarray]:
        """``[L]`` per-hop counts of frontier nodes the caps dropped, as
        numpy: ``batch``'s, or the last :meth:`sample` call's (``None``
        before any).  The second form adds the dropped count to
        ``sampler_frontier_drops_total{mode}`` in the registry once per
        ``sample`` call; a loader that samples ahead should pass the
        batch."""
        if batch is not None:
            # quiverlint: ignore[QT001] -- overflow_stats answers numpy by
            # contract; a diagnostic read
            return None if batch.drops is None else batch.drops.cpu().numpy()
        with self._state_lock:
            drops, recorded = self.last_drops, self._drops_recorded
            self._drops_recorded = True
        if drops is None:
            return None
        # quiverlint: ignore[QT001] -- overflow_stats answers numpy by
        # contract; a diagnostic read
        arr = drops.cpu().numpy()
        if not recorded:
            total = float(arr.sum())
            if total:
                telemetry.counter("sampler_frontier_drops_total",
                                  mode=self.mode.lower()).inc(total)
        return arr

    # -- host modes -----------------------------------------------------
    def set_fanout_frac(self, frac: float) -> None:
        """Scale the CPU mode's fanouts to ``frac`` of ``sizes`` (each at
        least 1); ``1.0`` restores them.  The device and UVA modes keep
        ``sizes``, as in the JAX package."""
        # quiverlint: ignore[QT008] -- single atomic float rebind; the CPU
        # lane reads it once per batch and may see the previous step of
        # the degradation ladder for one batch
        self._fanout_frac = float(min(max(frac, 0.0), 1.0))

    def _effective_sizes(self):
        frac = self._fanout_frac
        if frac >= 1.0:
            return self.sizes
        return [max(1, int(s * frac)) for s in self.sizes]

    def _host_batch(self, n_id, n_mask, num_nodes, batch_size,
                    blocks) -> SampledBatch:
        """A :class:`SampledBatch` on ``self.device`` from host arrays,
        with the device mode's dtypes."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

        return SampledBatch(
            n_id=dev(n_id, torch.int32), n_id_mask=dev(n_mask, torch.bool),
            num_nodes=dev(num_nodes, torch.int32), batch_size=batch_size,
            layers=tuple(LayerBlock(dev(nl, torch.int32), dev(m, torch.bool),
                                    dev(t, torch.int32))
                         for nl, m, t in blocks))

    def _host_seeds(self, input_nodes) -> np.ndarray:
        if isinstance(input_nodes, torch.Tensor):
            # quiverlint: ignore[QT001] -- the host modes sample host seeds:
            # their one read-back
            input_nodes = input_nodes.cpu().numpy()
        ids = np.asarray(input_nodes)
        n = self.csr_topo.node_count
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"node ids must lie in [0, {n})")
        return ids

    def _sample_cpu(self, input_nodes) -> SampledBatch:
        seeds = self._host_seeds(input_nodes)
        n_id, n_mask, num_nodes, blocks = self._cpu.sample_multihop(
            seeds, self._effective_sizes())
        return self._host_batch(n_id, n_mask, num_nodes, len(seeds), blocks)

    def _sample_uva(self, input_nodes, key_words, host_seeds) -> SampledBatch:
        from .uva import UVAGraph, sample_uva

        words = np.asarray(key_words, dtype=np.uint32).reshape(
            len(self.sizes), -1)
        if host_seeds is None:
            if words.shape[1] != 3:
                raise ValueError("UVA mode needs host_seeds with [L, 2] key "
                                 "words, or [L, 3] words")
            host_seeds = words[:, 2]
        with self._state_lock:  # one hot-tier upload, whoever comes first
            if self._uva is None:
                self._uva = UVAGraph(self.csr_topo, self.uva_budget,
                                     device=self.device)
            uva = self._uva
        seeds = self._host_seeds(input_nodes)
        n_id, n_mask, num, blocks = sample_uva(
            uva, self.sizes, seeds, words[:, :2], host_seeds,
            gather_mode=self.gather_mode, overlap=self.uva_overlap,
            timings=self.uva_timings, sample_rng=self.sample_rng)
        return self._host_batch(n_id, n_mask, num, len(seeds), blocks)

    # -- the single-hop API (the reference's sample_layer / reindex /
    #    sample_sub) --------------------------------------------------
    def sample_layer(self, batch, size: int, key_words=None, *,
                     key=None) -> SampleOut:
        """One uniform hop of fanout ``size`` from ``batch`` under the hop
        ``key`` (folded under ``"hash"``, raw under ``"key"``), or two
        key words (the first hop's of :meth:`draw_key_words` when neither
        is given)."""
        if key is not None:
            if key_words is not None:
                raise ValueError("pass key or key_words, not both")
            key_words = hop_key_words(_rng.key_data(key), self.sample_rng)[0]
        if key_words is None:
            key_words = self.draw_key_words()[0]
        indptr, indices = self.csr_topo.to_device(self.device)
        return run_hop(indptr, indices, self.seed_tensor(batch), size,
                       *key_words_pair(key_words), None, self.gather_mode,
                       self.sample_rng)

    def reindex(self, inputs, nbrs: torch.Tensor,
                mask: torch.Tensor) -> ReindexOut:
        """Dedup ``inputs`` and their neighbours ``nbrs`` and relabel
        (``ops/reindex.py``)."""
        return reindex(self.seed_tensor(inputs), nbrs, mask)

    def sample_sub(self, seeds, size: int, key_words=None, *, key=None):
        """One-hop subgraph on the host: ``(nodes, row, col)`` numpy, with
        ``nodes[:len(seeds)] == seeds`` and ``(row, col)`` the sampled
        edges in local ids (the reference's ``sample_sub``)."""
        seeds = np.asarray(seeds)
        out = self.sample_layer(seeds, size, key_words, key=key)
        r = self.reindex(seeds, out.nbrs, out.mask)
        # quiverlint: ignore[QT001] -- sample_sub answers numpy by contract
        nodes = r.n_id[: int(r.num_nodes)].cpu().numpy()
        # quiverlint: ignore[QT001] -- sample_sub answers numpy by contract
        m = r.mask.cpu().numpy()
        row = np.repeat(np.arange(len(seeds)), m.shape[1]).reshape(m.shape)
        # quiverlint: ignore[QT001] -- sample_sub answers numpy by contract
        return nodes, row[m], r.local_nbrs.cpu().numpy()[m]

    def sample_prob(self, train_idx, total_node_count: int) -> torch.Tensor:
        """Each node's expected appearances in a batch grown from
        ``train_idx`` through this sampler's fanouts (``ops/prob.py``)."""
        indptr, indices = self.csr_topo.to_device(self.device)
        return sample_prob(indptr, indices, np.asarray(train_idx),
                           total_node_count, self.sizes,
                           num_edges=self.csr_topo.edge_count)

    # -- process hand-off (``quiver_tpu_torch.multiprocessing``) ----------
    def share_ipc(self):
        """``(csr_topo, sizes, mode, options)``: what rebuilds this sampler
        in another process, the topology on the host (its device copies
        are dropped when pickled).  The rebuilt sampler puts its tables on
        ``options["device"]`` and starts its generator from ``seed``."""
        options = dict(
            device=str(self.device), return_eid=self.return_eid,
            seed=self.seed, gather_mode=self.gather_mode, dedup=self.dedup,
            sample_rng=self.sample_rng,
            frontier_caps=self.frontier_caps,
            edge_weights=(None if self._edge_weights is None
                          else np.asarray(self._edge_weights)),
            uva_budget=self.uva_budget, uva_overlap=self.uva_overlap)
        return self.csr_topo, self.sizes, self.mode, options

    @classmethod
    def lazy_from_ipc_handle(cls, ipc_handle) -> "GraphSageSampler":
        csr_topo, sizes, mode, options = ipc_handle
        return cls(csr_topo, sizes, mode=mode, **options)

    def __repr__(self):
        return (f"GraphSageSampler(sizes={self.sizes}, mode={self.mode!r}, "
                f"dedup={self.dedup!r}, gather={self.gather_mode!r}, "
                f"rng={self.sample_rng!r}, "
                f"device={self.device}, graph={self.csr_topo!r})")
