"""Hot/cold split of a graph larger than the card (counterpart of
``quiver_tpu/uva.py``).

The hot rows, the degree-ordered top rows whose edge lists fit a byte
budget, live on the device as a compacted sub-CSR over every node id (a
cold row has degree 0 there); the cold rows stay in host memory and are
sampled by the native host sampler (``cpp/native.py``).  Each hop
launches the device tier first (``ops/sample.py::sample_neighbors`` with
the hot seeds as its seed mask: kernel B1's literal entry under
``"auto"``/``"pwindow"``) and samples the cold seeds on the host while it
runs.  One read-back of the hop's neighbours then merges the tiers on the
host, the positional relabel builds the hop's block and frontier, and the
next hop copies that frontier back up.

Activated by ``GraphSageSampler(..., mode="UVA", uva_budget=...)``.
Without a budget, or with one that covers every edge, every row is hot.

Counters land in the port's metrics registry alone, under the JAX
package's names, where JAX ticks them: ``uva_seeds_total{tier=hot|cold}``
and the ``uva_host_tier_seconds`` histogram.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .cpp.native import CPUSampler
from .ops.sample import sample_neighbors
from . import telemetry
from .utils.device import resolve_device
from .utils.topology import CSRTopo, parse_size

__all__ = ["UVAGraph", "sample_uva"]


class UVAGraph:
    """Hot/cold split of a CSR's edge lists (see the module docstring).

    Args:
      topo: the graph; the host tier reads its full CSR.
      budget: device bytes for the hot edge lists (4 bytes an edge), or
        ``None`` for all of them.
      n_threads: host sampler threads (0: one per core).
      device: where the hot tier lives (``None``: the card).
    """

    def __init__(self, topo: CSRTopo, budget: Union[int, str, None],
                 n_threads: int = 0, device=None):
        self.device = resolve_device(device)
        deg = topo.degree.astype(np.int64)
        n = topo.node_count
        budget_b = None if budget is None else parse_size(budget)
        if budget_b is None or budget_b >= topo.edge_count * 4:
            hot_mask = np.ones(n, dtype=bool)
        else:
            order = np.argsort(-deg, kind="stable")
            cum = np.cumsum(deg[order]) * 4  # indices are int32
            hot_mask = np.zeros(n, dtype=bool)
            hot_mask[order[cum <= budget_b]] = True
        self.is_hot = hot_mask
        self.hot_edges = int(deg[hot_mask].sum())
        self.cold_edges = int(topo.edge_count - self.hot_edges)
        if self.hot_edges >= 2**31:
            raise ValueError(
                f"hot tier has {self.hot_edges:,} edges: int32 positions "
                "overflow; lower uva_budget")
        indptr_hot = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.where(hot_mask, deg, 0), out=indptr_hot[1:])
        indices_hot = topo.indices[np.repeat(hot_mask, deg)].astype(np.int32)
        # the JAX package's padding: indices to a non-empty multiple of 128,
        # indptr to a multiple of 128 by repeating its last offset (padded
        # rows read as degree 0), so no gather mode reads past a table
        pad = (-len(indices_hot)) % 128 or (0 if len(indices_hot) else 128)
        indices_hot = np.concatenate([indices_hot, np.zeros(pad, np.int32)])
        indptr_hot = indptr_hot.astype(np.int32)
        ppad = (-len(indptr_hot)) % 128
        indptr_hot = np.concatenate(
            [indptr_hot, np.full(ppad, indptr_hot[-1], np.int32)])
        # quiverlint: ignore[QT001] -- construction: the hot tier is placed
        # once
        self.indptr_dev = torch.from_numpy(indptr_hot).to(self.device)
        # quiverlint: ignore[QT001] -- construction: the hot tier is placed
        # once
        self.indices_dev = torch.from_numpy(indices_hot).to(self.device)
        # the host tier keeps the full CSR: cold rows are read from it
        self.cpu = CPUSampler(topo.indptr, topo.indices, n_threads=n_threads)

    def stats(self) -> dict:
        return dict(hot_edges=self.hot_edges, cold_edges=self.cold_edges,
                    hot_rows=int(self.is_hot.sum()),
                    hbm_bytes=int(self.hot_edges * 4))


def sample_uva(uva: UVAGraph, sizes: Sequence[int], input_nodes, key_words,
               host_seeds, gather_mode: str = "auto", overlap: bool = True,
               timings: Optional[dict] = None, sample_rng: str = "auto"):
    """Multi-hop positional sampling over the hot/cold split.

    ``key_words`` (``[L, 2]`` uint32) drive each hop's device tier under
    ``sample_rng`` (folded words under ``"hash"``, the hop keys' raw data
    under ``"key"``) and ``host_seeds`` (``[L]``) seed its host tier; from
    a batch key JAX's are ``split(key, L)`` and each hop key's last word
    (``GraphSageSampler.words_of_key``).  ``overlap=False`` waits
    for the device tier before the host tier runs.  ``timings`` accumulates
    the host tier's seconds under ``"host_s"``.  Returns host arrays
    ``(n_id, n_id_mask, num_nodes, blocks)``, blocks outermost first, each
    ``(nbr_local, mask, num_targets)``."""
    dev = uva.device
    frontier = np.asarray(input_nodes, dtype=np.int32)
    fmask = np.ones(len(frontier), dtype=bool)
    blocks = []
    for l, k in enumerate(sizes):
        hot = uva.is_hot[frontier] & fmask
        # the device tier first: its launch returns at once
        out = sample_neighbors(uva.indptr_dev, uva.indices_dev,
                               torch.from_numpy(frontier), k, key_words[l],
                               seed_mask=torch.from_numpy(hot), device=dev,
                               gather_mode=gather_mode,
                               sample_rng=sample_rng)
        if not overlap and dev.type == "cuda":
            # quiverlint: ignore[QT001] -- overlap=False A/B baseline
            # serializes device-then-host on purpose (measures the win)
            torch.cuda.current_stream(dev).synchronize()
        # the host tier runs while the device works
        cold_idx = np.nonzero(fmask & ~hot)[0]
        if len(cold_idx):
            t0 = time.perf_counter()
            cn, cm, _ = uva.cpu.sample_neighbors(frontier[cold_idx], k,
                                                 seed=int(host_seeds[l]))
            host_dt = time.perf_counter() - t0
            if timings is not None:
                timings["host_s"] = timings.get("host_s", 0.0) + host_dt
            telemetry.histogram("uva_host_tier_seconds").observe(host_dt)
        # per-hop hot/cold seed attribution: how much of the frontier the
        # device sub-CSR covered
        telemetry.counter("uva_seeds_total", tier="hot").inc(
            float(hot.sum()))
        telemetry.counter("uva_seeds_total", tier="cold").inc(
            float(len(cold_idx)))
        # the hop's one read-back: the tiers merge on the host
        # quiverlint: ignore[QT001] -- hot/cold merge happens on host: this is
        # the UVA design's one deliberate sync per hop, overlapped with the
        # host tier above
        nbrs = out.nbrs.cpu().numpy().copy()
        # quiverlint: ignore[QT001] -- same read-back as the line above
        mask = out.mask.cpu().numpy().copy()
        if len(cold_idx):
            nbrs[cold_idx] = cn
            mask[cold_idx] = cm
        t = len(frontier)
        pos = (t + np.arange(t, dtype=np.int32)[:, None] * k
               + np.arange(k, dtype=np.int32)[None, :])
        blocks.append((np.where(mask, pos, 0), mask, int(fmask.sum())))
        frontier = np.concatenate(
            [frontier, np.where(mask, nbrs, 0).reshape(-1)]).astype(np.int32)
        fmask = np.concatenate([fmask, mask.reshape(-1)])
    return frontier, fmask, int(fmask.sum()), blocks[::-1]
