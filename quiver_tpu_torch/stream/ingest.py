"""Serving ingestion lane for edge updates (counterpart of
``quiver_tpu/stream/ingest.py``).

Edge mutations enter serving deployments through their own
:class:`~quiver_tpu_torch.resilience.lanes.BoundedLane` — NOT the query lanes
— with their own deadline class (``config.stream_ingest_deadline_ms``)
and shed priority (``config.stream_ingest_priority``).  Keeping the
lane separate means a mutation burst sheds mutations, never queries,
and vice versa; the priority knob decides who wins when an operator
routes both through one consumer.

Every update is stamped at admission with ``t_enqueue``, an absolute
deadline, a flight-recorder trace (which itself carries the graph
version current at admission), and ``admitted_version`` — the
consistency handle: once the worker acks an update at version ``v``,
every sample taken from a snapshot with ``version >= v`` reflects it.

Results travel as ``(update, outcome)`` tuples on ``results``:
``outcome`` is ``("ok", applied_count, version)`` on success, or the
exception instance (``LoadShed`` / ``DeadlineExceeded`` from the shed
path, the raised error otherwise).

Chaos: ``stream.ingest`` fires inside the worker before the graph is
touched, so injected faults produce clean ``(update, exc)`` answers.

Durability: with a WAL attached
(``RecoveryManager.attach_lane``), the worker appends each update to
the log **before** applying it and only acks after both — an acked op
is durable, a ``WALWriteError`` is answered on ``results`` with the
graph untouched.  The crash semantics are *at-least-once*: a durable
record whose ack was lost to the crash replays on boot (graph
mutations are idempotent — re-adding an edge re-adds it, which the
consistency contract states in terms of acked ops only).  An op whose
*apply* fails after the append (delta overflow with
``compact_on_full=False``, a bad op) is nacked AND compensated with a
WAL abort record, so replay does not resurrect the rejected mutation;
only a nack from the fsync itself leaves the record's fate
indeterminate (see the caveats in ``recovery/wal.py``).
``CheckpointBarrier`` control items ride the same lane and run on the
writer thread between applies, which is what makes a snapshot's graph
state and WAL watermark agree exactly.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import telemetry
from ..resilience import chaos
from ..resilience.deadline import deadline_for, shed_if_expired
from ..resilience.lanes import BoundedLane, WeightedFairLane
from ..resilience.qos import qos_from_config
from ..telemetry import flightrec
from .compactor import compact

__all__ = ["EdgeUpdate", "IngestLane", "CheckpointBarrier"]

log = logging.getLogger("quiver_tpu_torch.stream")

_CHAOS_INGEST = chaos.point("stream.ingest")

_STOP = object()


@dataclass
class EdgeUpdate:
    """One edge mutation request (shed-compatible: carries the same
    admission fields as a ServingRequest)."""

    src: object
    dst: object
    ts: Optional[object] = None
    op: str = "add"                 # "add" | "remove"
    t_enqueue: float = 0.0          # perf_counter at admission
    deadline: Optional[float] = None
    priority: int = 0
    trace: object = None
    admitted_version: int = -1      # graph version at admission
    # QoS class (stamped at submit when a controller is installed —
    # ingestion traffic rides the configured ``qos_ingest_tenant``
    # class, so a mutation burst fair-shares against queries instead
    # of starving them)
    tenant_class: Optional[str] = None
    meta: dict = field(default_factory=dict)


@dataclass
class CheckpointBarrier:
    """A control item the writer thread executes between applies.

    Deliberately carries **no** ``t_enqueue``: ``BoundedLane`` admits
    attribute-less items as control traffic (never shed, never counted
    against depth priorities), so a checkpoint request cannot be load-
    shed into never happening.  The worker calls ``fn(applied_lsn)``
    and publishes the outcome through ``done``/``result``/``error``.
    """

    fn: Callable[[int], object]
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


class IngestLane:
    """Bounded edge-update lane + single writer thread.

    One writer serializes graph mutations (the ``StreamingGraph`` lock
    makes concurrent writers safe, but a single writer keeps version
    order equal to ack order, which is what the consistency contract is
    stated in).  ``BufferError`` from a full delta segment triggers an
    inline compaction and a retry — backpressure folds, it never drops.
    """

    def __init__(self, graph: "StreamingGraph", depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 priority: Optional[int] = None,
                 result_queue=None, compact_on_full: bool = True,
                 wal=None):
        from ..config import get_config

        cfg = get_config()
        self.graph = graph
        self.wal = wal                  # WriteAheadLog, or None = volatile
        self.checkpoint_fn = None       # set by RecoveryManager.attach_lane
        # writer-thread-private (worker + its barriers only — no lock):
        self._applied_lsn = -1          # newest WAL record folded into graph
        self._compacted = False         # inline compaction since last ckpt
        self.deadline_ms = float(
            deadline_ms if deadline_ms is not None
            else cfg.stream_ingest_deadline_ms)
        self.priority = int(priority if priority is not None
                            else cfg.stream_ingest_priority)
        self.results = (result_queue if result_queue is not None
                        else queue.Queue())
        maxsize = int(depth if depth is not None
                      else cfg.stream_ingest_depth)
        self._qos = qos_from_config()
        if self._qos is not None:
            self.lane = WeightedFairLane(
                "stream_ingest", self._qos.weights(),
                default_class=self._qos.ingest,
                maxsize=maxsize, result_queue=self.results)
        else:
            self.lane = BoundedLane(
                "stream_ingest", maxsize=maxsize,
                result_queue=self.results)
        self.compact_on_full = compact_on_full
        self._thread = threading.Thread(
            target=self._ingest_worker, daemon=True,
            name="quiver-stream-ingest")

    # -- producer side -------------------------------------------------
    def start(self) -> "IngestLane":
        self._thread.start()
        return self

    def submit(self, src, dst, ts=None, op: str = "add",
               priority: Optional[int] = None) -> EdgeUpdate:
        """Enqueue one edge update; returns the stamped request (its
        answer arrives on ``results``).  May shed a lower-priority
        queued update (or this one) under load — the shed victim is
        answered with ``LoadShed`` on ``results``."""
        now = time.perf_counter()
        upd = EdgeUpdate(
            src=src, dst=dst, ts=ts, op=op, t_enqueue=now,
            deadline=deadline_for(now, self.deadline_ms),
            priority=self.priority if priority is None else int(priority),
            trace=flightrec.new_trace(),
            admitted_version=self.graph.version,
            tenant_class=(self._qos.ingest
                          if self._qos is not None else None),
        )
        if upd.trace is not None:
            upd.trace.add("stream.enqueue",
                          {"op": op, "lane": "stream_ingest"})
        self.lane.put(upd)
        return upd

    # -- consumer side -------------------------------------------------
    def _apply(self, upd: EdgeUpdate) -> int:
        if upd.op == "add":
            try:
                return self.graph.add_edges(upd.src, upd.dst, upd.ts)
            except BufferError:
                if not self.compact_on_full:
                    raise
                compact(self.graph)  # backpressure: fold, then retry
                self._compacted = True
                return self.graph.add_edges(upd.src, upd.dst, upd.ts)
        if upd.op == "remove":
            return self.graph.remove_edges(upd.src, upd.dst)
        raise ValueError(f"unknown edge op {upd.op!r}")

    def _durable(self, upd: EdgeUpdate):
        """Append ``upd`` to the WAL (durable per its fsync policy);
        returns the LSN, or None when running volatile.  Raises
        :class:`~quiver_tpu_torch.recovery.errors.WALWriteError` — answered
        on ``results`` like any other failure — when durability cannot
        be promised; the graph is then never touched."""
        if self.wal is None:
            return None
        from ..recovery.wal import encode_edge_op

        return self.wal.append(
            encode_edge_op(upd.op, upd.src, upd.dst, upd.ts))

    def _abort_durable(self, lsn: int) -> None:
        """Append a compensation record for a durable-but-nacked op.

        Best-effort: if the log refuses even this, replay will apply
        the rejected mutation (the at-least-once caveat documented in
        ``recovery/wal.py``) — counted, logged, never raised, because
        the producer is already being answered with the original
        error."""
        from ..recovery.wal import encode_abort

        try:
            self.wal.append(encode_abort(lsn))
            telemetry.counter("recovery_wal_abort_records_total").inc()
        except Exception as e:
            telemetry.counter("recovery_wal_abort_failures_total").inc()
            log.warning("could not abort nacked wal record %d: %s", lsn, e)

    def _run_barrier(self, item: CheckpointBarrier) -> None:
        try:
            item.result = item.fn(self._applied_lsn)
        except Exception as e:
            log.warning("checkpoint barrier failed: %s", e)
            item.error = e
        finally:
            item.done.set()

    def _ingest_worker(self):
        while True:
            item = self.lane.get()
            if item is _STOP:
                return
            if isinstance(item, CheckpointBarrier):
                self._run_barrier(item)
                continue
            lsn = None  # set iff the append fully succeeded (durable)
            try:
                if shed_if_expired(item, self.results, "stream_ingest"):
                    continue
                with flightrec.activate(item.trace):
                    _CHAOS_INGEST()
                    lsn = self._durable(item)
                    applied = self._apply(item)
                if lsn is not None:
                    self._applied_lsn = lsn
                version = self.graph.version
                if item.trace is not None:
                    item.trace.add("stream.applied",
                                   {"n": applied, "version": version})
                    flightrec.get_recorder().finish(
                        item.trace,
                        time.perf_counter() - item.t_enqueue,
                        status="ok", lane="stream_ingest")
                self.results.put((item, ("ok", applied, version)))
            except Exception as e:
                # answer the producer with the exception object (chaos
                # faults, bad ops) — an unanswered update would hang a
                # waiting producer forever
                if lsn is not None:
                    # the record is already durable but its apply was
                    # rejected: compensate, or replay would resurrect
                    # a mutation this nack just disclaimed
                    self._abort_durable(lsn)
                telemetry.counter("stream_ingest_errors_total").inc()
                if item.trace is not None:
                    flightrec.get_recorder().finish(
                        item.trace,
                        time.perf_counter() - item.t_enqueue,
                        status="error", lane="stream_ingest")
                self.results.put((item, e))
            if self._compacted and self.checkpoint_fn is not None:
                # an inline compaction folded the delta into a new base:
                # snapshot it so the covered WAL prefix can truncate.
                # Best-effort — a failed snapshot costs replay time only.
                self._compacted = False
                try:
                    self.checkpoint_fn(self._applied_lsn)
                except Exception as e:
                    log.warning("post-compaction checkpoint failed: %s", e)

    def request_checkpoint(self, fn=None) -> CheckpointBarrier:
        """Enqueue a checkpoint barrier for the writer thread; returns
        it immediately (wait on ``barrier.done``).  ``fn`` defaults to
        the attached manager's snapshot function."""
        fn = fn if fn is not None else self.checkpoint_fn
        if fn is None:
            raise ValueError("no checkpoint_fn attached to this lane")
        barrier = CheckpointBarrier(fn=fn)
        self.lane.put(barrier)
        return barrier

    def is_running(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self.lane.put(_STOP)
        join_and_reap([self._thread], timeout, component="stream.ingest")

    @property
    def depth(self) -> int:
        return self.lane.qsize()
