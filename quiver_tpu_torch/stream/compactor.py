"""Compaction — fold the delta overlay into a fresh base CSR (counterpart
of ``quiver_tpu/stream/compactor.py``).

A fold concatenates the surviving base edges (tombstones dropped) with the
live delta edges and rebuilds CSR with the same stable counting sort the
initial build uses (``utils.topology.coo_to_csr``).  Stable order gives
every row ``[surviving base neighbours in base order, delta neighbours in
append order]`` — the virtual concatenation the overlay sampler draws
from — so after the swap, with the overlay empty, sampling is bitwise the
frozen sampler's on the new base.

The swap runs under the graph lock and is atomic to samplers: an
in-flight snapshot keeps its own tensors, the next ``snapshot()`` sees the
new base.  The fold (a host sort over E edges) also runs under the lock,
or mutations arriving mid-fold would be folded twice or lost; the pause it
imposes on ingestion is ``stream_compact_pause_seconds``.

Chaos: ``stream.compact`` fires before any state is touched, so an
injected fault aborts the fold with the graph unchanged; the
:class:`Compactor` loop counts it and retries next tick.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from .. import telemetry
from ..resilience import chaos
from ..resilience.shutdown import join_and_reap
from ..utils.topology import CSRTopo, coo_to_csr

__all__ = ["compact", "Compactor"]

log = logging.getLogger("quiver_tpu_torch.stream")

_CHAOS_COMPACT = chaos.point("stream.compact")


def compact(graph) -> dict:
    """Fold ``graph``'s overlay into a fresh base CSR and swap it in.

    Returns the fold's stats; raises whatever the ``stream.compact``
    chaos point injects (state untouched in that case)."""
    t0 = time.perf_counter()
    with graph._lock:
        _CHAOS_COMPACT()
        base = graph._base
        n = base.node_count
        keep = ~graph._tomb
        dropped = int(graph._tomb.sum())
        d_src, d_dst, d_ts = graph._delta.live_edges()
        folded = len(d_src)
        # base edges back to COO rows, tombstones squeezed out
        bsrc = np.repeat(np.arange(n, dtype=np.int64), base.degree)[keep]
        src = np.concatenate([bsrc, d_src.astype(np.int64)])
        dst = np.concatenate([base.indices[keep].astype(np.int64),
                              d_dst.astype(np.int64)])
        indptr, indices, eid = coo_to_csr(src, dst, n)
        new_base = CSRTopo(indptr=indptr, indices=indices)
        new_base.feature_order = base.feature_order
        if graph.has_ts:
            ts = np.concatenate([graph._base_ts[keep], d_ts])
            graph._base_ts = ts[eid].astype(np.int32)
        # the old base's device tensors live on in in-flight snapshots;
        # dropping its cache and bumping its version keeps anything else
        # from serving it as current
        base.invalidate()
        graph._base = new_base
        graph._base_ts_dev = {}
        graph._tomb = np.zeros(new_base.edge_count, dtype=bool)
        graph._tombstones = 0
        graph._delta.clear()
        graph._version += 1
        graph._snap = None
        version = graph._version
    pause = time.perf_counter() - t0
    telemetry.counter("stream_compactions_total").inc()
    telemetry.histogram("stream_compact_pause_seconds").observe(pause)
    telemetry.gauge("stream_overlay_bytes").set(0.0)
    telemetry.gauge("stream_graph_version_total").set(version)
    return dict(folded=folded, dropped=dropped, pause_s=pause,
                version=version, edges=new_base.edge_count)


class Compactor(threading.Thread):
    """Background thread folding the overlay on cadence or watermark.

    A fold runs when ``interval_s`` has passed since the last one and
    anything is pending, or when the pending share of the delta capacity
    reaches ``watermark`` (checked every ``poll_s``)."""

    def __init__(self, graph, interval_s: Optional[float] = None,
                 watermark: Optional[float] = None, poll_s: float = 0.05):
        from ..config import get_config

        cfg = get_config()
        super().__init__(daemon=True, name="quiver-stream-compactor")
        self.graph = graph
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.stream_compact_interval_s)
        self.watermark = float(watermark if watermark is not None
                               else cfg.stream_compact_watermark)
        self.poll_s = float(poll_s)
        self._stop_ev = threading.Event()
        self._last = time.perf_counter()

    def _due(self) -> bool:
        pending = self.graph.pending_deltas
        tombs = self.graph.tombstone_count
        if pending + tombs == 0:
            return False
        if pending >= self.watermark * self.graph._delta.capacity:
            return True
        return time.perf_counter() - self._last >= self.interval_s

    def run(self):
        while not self._stop_ev.wait(self.poll_s):
            try:
                if self._due():
                    compact(self.graph)
                    self._last = time.perf_counter()
            except Exception as e:
                # a failed fold leaves the graph unchanged; count it and
                # retry next tick, or the overlay would grow to capacity
                telemetry.counter("stream_compact_errors_total").inc()
                log.warning("compaction failed (will retry): %s", e)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_ev.set()
        join_and_reap([self], timeout, component="stream.compactor")
