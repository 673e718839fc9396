"""StreamingGraph — a mutable graph view over a frozen base CSR
(counterpart of ``quiver_tpu/stream/graph.py``).

The streaming tier's contract, as in the JAX package:

  * the **base** :class:`~quiver_tpu_torch.utils.topology.CSRTopo` never
    mutates in place — deletions of base edges set bits in a
    **tombstone table** indexed by base edge position, insertions go to
    the :class:`~quiver_tpu_torch.stream.delta.DeltaStore` append segment;
  * samplers read immutable :class:`DeltaSnapshot`\\ s — one set of
    device tensors per graph version, built lazily and cached until the
    next mutation.  The delta segment is re-CSR'd per snapshot and padded
    to a **pow2 fanout bucket**, so the sampler's per-key entries
    (``recovery/registry.py``) stay few;
  * the **compactor** (``stream/compactor.py``) folds tombstones and live
    delta edges into a fresh base CSR and swaps it in under ``_lock``;
    in-flight snapshots keep sampling their own tensors, the next
    :meth:`StreamingGraph.snapshot` sees the new base;
  * every mutation bumps ``version``; the flight recorder stamps the
    version current at each request's admission
    (``flightrec.set_version_provider``).

**Snapshots are never written.**  JAX arrays are immutable; torch tensors
are not, so the port keeps the rule by construction: every snapshot gets
tensors of its own for ``tomb``, ``d_indptr``, ``d_indices`` and
``d_ts``, uploaded from fresh host arrays, and nothing holds a reference
that could write them.  ``indptr``/``indices`` are the base's cached
placement and ``base_ts`` is cached per base and device (both change only
at a fold, which makes new tensors).  So ``tomb`` — the edge count in
int32 — is uploaded again for every version, as in JAX.

Invalidation: row listeners registered through
:meth:`register_invalidation` / :meth:`attach_feature` run after every
mutation with the touched endpoints (``Feature.invalidate_rows`` drops
stale overlay rows and pages).  Listeners run outside ``_lock``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry
from ..telemetry import flightrec
from ..utils.device import resolve_device
from ..utils.topology import CSRTopo, coo_to_csr
from .delta import DeltaStore

__all__ = ["StreamingGraph", "DeltaSnapshot"]


def _pad_to(a: np.ndarray, n: int, dtype=np.int32) -> np.ndarray:
    """``a`` as ``dtype``, zero-padded to length ``n``, in a new array
    (never a view of ``a``: a snapshot's tensors must not share memory
    with host state that later mutations write)."""
    out = np.zeros(n, dtype=dtype)
    out[:len(a)] = a
    return out


def _pad128_len(n: int) -> int:
    """The base tables' padded length: a multiple of 128, at least 128
    (``CSRTopo.to_device``)."""
    return max(((n + 127) // 128) * 128, 128)


def _fanout_bucket(n: int) -> int:
    """Smallest pow2 >= n, floored at 128: the length the delta tables
    pad to, so sampler entries key on O(log capacity) buckets instead of
    every pending count."""
    b = 128
    while b < n:
        b *= 2
    return b


class DeltaSnapshot(NamedTuple):
    """Immutable device view of one graph version.

    ``d_indices`` / ``d_ts`` are padded to ``delta_bucket``, ``tomb`` /
    ``base_ts`` to the base table's padded length ``epad``; every table
    is int32 with a length that is a multiple of 128, so kernel B3 reads
    each of them.
    """

    indptr: torch.Tensor        # [Npad] int32 base CSR row pointers
    indices: torch.Tensor       # [epad] int32 base CSR columns
    tomb: torch.Tensor          # [epad] int32, nonzero = base edge deleted
    d_indptr: torch.Tensor      # [Npad] int32 delta CSR row pointers
    d_indices: torch.Tensor     # [delta_bucket] int32 delta columns
    base_ts: Optional[torch.Tensor]  # [epad] int32 or None
    d_ts: Optional[torch.Tensor]     # [delta_bucket] int32 or None
    version: int
    epad: int
    delta_bucket: int
    has_ts: bool
    pending: int                # live delta edges in this snapshot


class StreamingGraph:
    """Thread-safe mutable graph: base CSR + tombstones + delta segment.

    Args:
      csr_topo: the initial base :class:`CSRTopo` (frozen from here on).
      edge_ts: optional ``[E]`` int32 per-edge timestamps aligned with
        ``csr_topo.indices``; they enable the samplers' time windows (and
        make ``add_edges`` require ``ts``).
      delta_capacity: pending-edge ceiling (default
        ``config.stream_delta_capacity``).
      device: where :meth:`snapshot` places its tensors when the caller
        names none (``None``: the card).
    """

    def __init__(self, csr_topo: CSRTopo, edge_ts=None,
                 delta_capacity: Optional[int] = None, device=None):
        from ..config import get_config

        cfg = get_config()
        self._lock = threading.RLock()
        self._base = csr_topo
        self.has_ts = edge_ts is not None
        if self.has_ts:
            edge_ts = np.asarray(edge_ts, dtype=np.int32)
            if edge_ts.shape[0] != csr_topo.edge_count:
                raise ValueError(
                    f"edge_ts length {edge_ts.shape[0]} != edge_count "
                    f"{csr_topo.edge_count}")
        self._base_ts = edge_ts
        self._base_ts_dev: dict = {}  # str(device) -> tensor, this base's
        self._tomb = np.zeros(csr_topo.edge_count, dtype=bool)
        self._tombstones = 0  # live tombstone count (folds reset it)
        cap = int(delta_capacity if delta_capacity is not None
                  else cfg.stream_delta_capacity)
        self._delta = DeltaStore(cap, has_ts=self.has_ts)
        self._version = 0
        self._snap: Optional[DeltaSnapshot] = None
        self._snap_dev: Optional[str] = None
        self.device = device
        self._listeners: List[Callable] = []
        # flight records stamp the version current at their admission
        flightrec.set_version_provider(self._read_version)

    # -- read side -----------------------------------------------------
    @property
    def base(self) -> CSRTopo:
        return self._base

    @property
    def node_count(self) -> int:
        return self._base.node_count

    @property
    def version(self) -> int:
        return self._read_version()

    def _read_version(self) -> int:
        # an int read is atomic under the GIL; the flight recorder calls
        # this on every trace admission, so it takes no lock
        return self._version

    @property
    def pending_deltas(self) -> int:
        with self._lock:
            return self._delta.live

    @property
    def tombstone_count(self) -> int:
        with self._lock:
            return self._tombstones

    # -- invalidation wiring -------------------------------------------
    def register_invalidation(self, fn: Callable) -> None:
        """``fn(rows: np.ndarray)`` runs after every mutation with the
        touched node ids (edge endpoints).  Exceptions propagate to the
        mutator: a listener that cannot invalidate must not fail
        silently, or the caches serve stale rows."""
        with self._lock:
            self._listeners.append(fn)

    def attach_feature(self, feature) -> None:
        """Wire a ``Feature``'s ``invalidate_rows``."""
        self.register_invalidation(feature.invalidate_rows)

    def close(self) -> None:
        """Unhook the flight recorder's version provider."""
        flightrec.set_version_provider(None)

    def _notify(self, rows: np.ndarray) -> None:
        if rows.size == 0:
            return
        # the listener list is read under the lock and called outside it:
        # a listener takes Feature._plock, and holding _lock across it
        # would order _lock before _plock in every notification
        with self._lock:
            listeners = list(self._listeners)
        if not listeners:
            return
        rows = np.unique(rows.astype(np.int64))
        for fn in listeners:
            fn(rows)

    def _overlay_gauges(self, pending: int) -> None:
        telemetry.gauge("stream_graph_version_total").set(self._version)
        telemetry.gauge("stream_overlay_bytes").set(
            float(pending) * (12.0 if self.has_ts else 8.0))

    # -- mutation side -------------------------------------------------
    def add_edges(self, src, dst, ts=None) -> int:
        """Append edges to the delta segment; returns the count applied.

        ``BufferError`` (segment full) propagates: callers treat it as
        backpressure (the ingest worker compacts and retries)."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        n = self._base.node_count
        if src.size and (int(src.max()) >= n or int(dst.max()) >= n
                         or int(src.min()) < 0 or int(dst.min()) < 0):
            raise ValueError(
                f"edge endpoints must be in [0, {n}) — node additions "
                "are not part of the streaming tier")
        with self._lock:
            m = self._delta.add(src, dst, ts)
            self._version += 1
            self._snap = None
            pending = self._delta.live
        telemetry.counter("stream_edges_applied_total", op="add").inc(m)
        self._overlay_gauges(pending)
        self._notify(np.concatenate([src, dst]))
        return m

    def remove_edges(self, src, dst) -> int:
        """Delete edges: tombstone a live base occurrence, else kill a
        live pending delta edge.  Returns the count deleted (absent edges
        are ignored)."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int64))
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        removed = tombed = 0
        touched = []
        with self._lock:
            indptr, indices = self._base.indptr, self._base.indices
            for u, v in zip(src, dst):
                u, v = int(u), int(v)
                lo, hi = int(indptr[u]), int(indptr[u + 1])
                row = indices[lo:hi]
                hit = np.nonzero((row == v) & ~self._tomb[lo:hi])[0]
                if len(hit):
                    self._tomb[lo + hit[0]] = True
                    self._tombstones += 1
                    tombed += 1
                elif not self._delta.kill(u, v):
                    continue  # edge absent: no-op
                removed += 1
                touched.append((u, v))
            if removed:
                self._version += 1
                self._snap = None
                pending = self._delta.live
        if removed:
            if tombed:
                telemetry.counter("stream_tombstones_total").inc(tombed)
            telemetry.counter("stream_edges_applied_total",
                              op="remove").inc(removed)
            self._overlay_gauges(pending)
            self._notify(np.asarray(touched, dtype=np.int64).reshape(-1))
        return removed

    # -- snapshot side -------------------------------------------------
    def _base_ts_on(self, dev: torch.device, epad: int) -> torch.Tensor:
        """This base's timestamps on ``dev``, padded to ``epad``: uploaded
        once per base and device (caller holds ``_lock``)."""
        key = str(dev)
        t = self._base_ts_dev.get(key)
        if t is None:
            # quiverlint: ignore[QT001] -- once per base and device, cached
            t = torch.from_numpy(_pad_to(self._base_ts, epad)).to(dev)
            self._base_ts_dev[key] = t
        return t

    def snapshot(self, device=None) -> DeltaSnapshot:
        """Device view of the current version (cached until a mutation).

        The delta segment's live edges are re-CSR'd over the node space
        (stable: a row's delta neighbours keep append order, the order a
        fold preserves, which makes post-compaction sampling bitwise
        reproducible) and padded to the pow2 fanout bucket."""
        dev = resolve_device(device if device is not None else self.device)
        with self._lock:
            snap = self._snap
            if snap is not None and self._snap_dev == str(dev):
                return snap
            n = self._base.node_count
            indptr, indices = self._base.to_device(dev)
            epad = int(indices.shape[0])
            if epad != _pad128_len(self._base.edge_count):
                raise RuntimeError(
                    f"base table padded to {epad}, not "
                    f"{_pad128_len(self._base.edge_count)}: delta edge ids "
                    "would differ from the JAX package's")
            tomb = _pad_to(self._tomb, epad)
            d_src, d_dst, d_ts = self._delta.live_edges()
            d_indptr64, d_indices, _ = coo_to_csr(d_src, d_dst, n)
            bucket = _fanout_bucket(len(d_indices))
            d_ts_pad = base_ts = None
            if self.has_ts:
                order = np.argsort(d_src, kind="stable")
                # quiverlint: ignore[QT001] -- once per graph version (ROADMAP
                # perf item: the snapshot's re-upload)
                d_ts_pad = torch.from_numpy(
                    _pad_to(d_ts[order], bucket)).to(dev)
                base_ts = self._base_ts_on(dev, epad)
            snap = DeltaSnapshot(
                indptr=indptr, indices=indices,
                # quiverlint: ignore[QT001] -- once per graph version (ROADMAP
                # perf item: the snapshot's re-upload)
                tomb=torch.from_numpy(tomb).to(dev),
                # quiverlint: ignore[QT001] -- once per graph version (ROADMAP
                # perf item: the snapshot's re-upload)
                d_indptr=torch.from_numpy(_pad_to(
                    d_indptr64, _pad128_len(len(d_indptr64)))).to(dev),
                # quiverlint: ignore[QT001] -- once per graph version (ROADMAP
                # perf item: the snapshot's re-upload)
                d_indices=torch.from_numpy(
                    _pad_to(d_indices, bucket)).to(dev),
                base_ts=base_ts, d_ts=d_ts_pad,
                version=self._version, epad=epad, delta_bucket=bucket,
                has_ts=self.has_ts, pending=len(d_indices),
            )
            self._snap, self._snap_dev = snap, str(dev)
            return snap

    def __repr__(self):
        return (f"StreamingGraph(base={self._base!r}, "
                f"pending={self.pending_deltas}, "
                f"tombstones={self.tombstone_count}, "
                f"version={self.version})")
