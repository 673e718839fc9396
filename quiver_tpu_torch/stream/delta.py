"""Host-side delta segment for the streaming graph tier (a copy of
``quiver_tpu/stream/delta.py``, which the port may not import).

The delta-CSR overlay keeps the base CSR **frozen** (so every device
placement and compiled executable built against it stays valid) and
accumulates mutations in two side structures:

  * an **append-only edge segment** — ``(src, dst[, ts])`` triples in
    arrival order, preallocated to ``capacity`` so steady-state ingestion
    never reallocates;
  * a **dead mark per pending edge** — a delta edge deleted before it
    ever reached a base CSR is marked dead here (base-edge deletions
    live in the owning :class:`~quiver_tpu_torch.stream.graph.StreamingGraph`'s
    tombstone bitmap instead, since they address base CSR positions).

This module is pure numpy bookkeeping: the device view of the segment is
built per snapshot by ``StreamingGraph.snapshot`` — live pending edges
re-CSR'd over the node-id space and padded to a pow2 fanout bucket, so
the sampler's per-key entries stay few.

Thread-safety: externally synchronized — every caller holds the owning
``StreamingGraph._lock`` (same division of labor as ``ColdRowCache`` /
``Feature._plock``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["DeltaStore"]


class DeltaStore:
    """Preallocated append-only edge segment with dead marks.

    Args:
      capacity: maximum pending (uncompacted) edges; :meth:`add` raises
        ``BufferError`` past it — the compactor is expected to fold long
        before that (``config.stream_compact_watermark``).
      has_ts: store a per-edge int32 timestamp alongside each edge.
    """

    def __init__(self, capacity: int, has_ts: bool = False):
        capacity = int(capacity)
        if capacity <= 0:
            raise ValueError(f"delta capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self.has_ts = bool(has_ts)
        self.n = 0  # appended (live + dead) pending edges
        self.src = np.zeros(capacity, dtype=np.int32)
        self.dst = np.zeros(capacity, dtype=np.int32)
        self.ts = np.zeros(capacity, dtype=np.int32) if has_ts else None
        self.dead = np.zeros(capacity, dtype=bool)

    # ------------------------------------------------------------------
    # quiverlint: requires-lock[StreamingGraph._lock]
    def add(self, src: np.ndarray, dst: np.ndarray,
            ts: Optional[np.ndarray] = None) -> int:
        """Append edges; returns the count appended.

        Raises ``BufferError`` when the segment cannot hold the batch —
        the caller (ingest worker) treats that as backpressure and forces
        a compaction instead of dropping updates.
        """
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        m = len(src)
        if self.n + m > self.capacity:
            raise BufferError(
                f"delta segment full ({self.n}+{m} > {self.capacity}): "
                "compact before ingesting more edges")
        if self.has_ts:
            if ts is None:
                raise ValueError(
                    "this graph carries per-edge timestamps: add() "
                    "requires ts")
            ts = np.atleast_1d(np.asarray(ts, dtype=np.int32))
            if ts.shape != src.shape:
                raise ValueError("ts length mismatch")
            self.ts[self.n:self.n + m] = ts
        sl = slice(self.n, self.n + m)
        self.src[sl] = src
        self.dst[sl] = dst
        self.dead[sl] = False
        self.n += m
        return m

    # quiverlint: requires-lock[StreamingGraph._lock]
    def kill(self, src: int, dst: int) -> bool:
        """Mark ONE live pending edge (src, dst) dead; last match wins
        (most-recently-added duplicate dies first).  Returns False when
        no live pending match exists (the caller then consults the base
        tombstones)."""
        n = self.n
        hits = np.nonzero(
            (self.src[:n] == src) & (self.dst[:n] == dst)
            & ~self.dead[:n]
        )[0]
        if not len(hits):
            return False
        self.dead[hits[-1]] = True
        return True

    # ------------------------------------------------------------------
    @property
    def live(self) -> int:
        """Pending edges that would survive a fold right now."""
        return int(self.n - self.dead[:self.n].sum())

    def live_edges(self) -> Tuple[np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]:
        """``(src, dst, ts-or-None)`` copies of the live pending edges,
        in append order (the order a fold preserves per row)."""
        n = self.n
        keep = ~self.dead[:n]
        ts = self.ts[:n][keep].copy() if self.has_ts else None
        return self.src[:n][keep].copy(), self.dst[:n][keep].copy(), ts

    # quiverlint: requires-lock[StreamingGraph._lock]
    def clear(self) -> None:
        """Empty the segment (after its edges were folded into a base)."""
        self.n = 0

    def __repr__(self):
        return (f"DeltaStore(pending={self.n}, live={self.live}, "
                f"capacity={self.capacity}, has_ts={self.has_ts})")
