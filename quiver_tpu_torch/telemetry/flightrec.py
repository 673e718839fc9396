"""Flight recorder — per-request trace context with tail-based retention.

The registry answers "how fast is each stage on average?"; this
module answers "why was *this* request slow?".  Every serving request
gets a :class:`TraceContext` at enqueue (``serving.py`` attaches it to
the ``ServingRequest``), stages append monotonic events as the request
moves queue_wait → coalesce → sample → gather → infer → finish, and at
finish the :class:`FlightRecorder` keeps the full event log only for
requests worth debugging — slow (> ``config.flightrec_slow_ms``),
errored, or explicitly flagged — and discards the rest.  Aggregates
(SALIENT, arxiv 2110.08450) show *that* the pipeline is imbalanced;
the retained tail shows *which* stage ate a given request's budget.

Cross-thread attribution uses a :mod:`contextvars` context-var holding
the tuple of active trace contexts (a coalesced device batch activates
every member's trace at once — they all wait for the batch, so they all
own its events).  Thread pools do NOT inherit context automatically, so
the two background boundaries capture it explicitly:

  * ``Feature.prefetch`` snapshots :func:`active` at submit time and
    re-activates it inside the worker, so the ``feature-prefetch``
    thread's coldcache / H2D events land on the originating request;
  * ``parallel.Prefetcher`` (the ``SeedLoader`` worker) runs
    ``make_batch`` under a ``contextvars.copy_context()`` taken at
    iteration start, so loader-driven prefetch work attributes the
    same way.

Gating: when ``QUIVER_TELEMETRY=off`` :func:`new_trace` returns None,
no context is ever activated, and :func:`event` / :func:`tracing` reduce
to one context-var read — no locks, no clocks, no allocations.  Hot
paths guard event construction with ``if flightrec.tracing():`` so even
the attrs dict is never built off a live trace.

Lock discipline: the per-trace event list and the recorder's ring
are mutated from every pipeline thread; all writes hold the declared
locks (see ``_guarded_by``).
"""

from __future__ import annotations

import contextvars
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import timeline as _timeline

__all__ = [
    "TraceContext", "FlightRecorder",
    "new_trace", "current", "active", "activate", "event", "flag",
    "tracing", "get_recorder", "reset",
    "set_version_provider", "graph_version",
]

# -- graph-version stamping (a streaming graph) -------------------------
# The streaming tier registers its version counter here; every trace
# created afterwards carries the graph version that was current at its
# admission, so a retained flight record pins exactly which topology a
# slow/errored request sampled against.  None until a StreamingGraph
# registers (frozen-CSR deployments pay one global read per trace).
_VERSION_PROVIDER = None


def set_version_provider(fn) -> None:
    """Register a zero-arg callable returning the current graph version
    (``None`` unregisters).  Called by ``stream.StreamingGraph``."""
    global _VERSION_PROVIDER
    # single atomic reference rebind at
    # graph construction/teardown; readers snapshot it into a local and
    # tolerate one stale observation (graph_version falls back to None)
    _VERSION_PROVIDER = fn


def graph_version() -> Optional[int]:
    """Current graph version, or None when no streaming graph is live."""
    fn = _VERSION_PROVIDER
    if fn is None:
        return None
    return int(fn())

# events per trace are capped so one pathological request (a chunked
# giant batch, a retry loop) cannot grow without bound while in flight
_MAX_EVENTS_PER_TRACE = 2048

_ACTIVE: "contextvars.ContextVar[Optional[Tuple[TraceContext, ...]]]" = \
    contextvars.ContextVar("quiver_flightrec_active", default=None)

_id_lock = threading.Lock()
_id_counter = 0


def _next_trace_id() -> str:
    """Process-unique, monotonic, and grep-friendly: ``<pid>-<seq>``."""
    global _id_counter
    with _id_lock:
        _id_counter += 1
        n = _id_counter
    return f"{os.getpid():x}-{n:08x}"


class TraceContext:
    """One request's monotonic event log.

    Events are ``(t, name, thread, attrs)`` tuples with ``t`` from
    ``perf_counter`` — appended from whichever pipeline thread is doing
    the request's work at that moment, so ``thread`` is the
    attribution: a gather staged by the prefetch worker shows up as
    ``feature-prefetch_0``, not as the server loop that claimed it.
    """

    _guarded_by = {"events": "_lock", "dropped": "_lock",
                   "flagged": "_lock"}

    __slots__ = ("trace_id", "t_start", "wall_start", "events", "dropped",
                 "flagged", "graph_version", "tenant", "_lock")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or _next_trace_id()
        self.t_start = time.perf_counter()
        self.wall_start = time.time()
        self.events: List[Tuple[float, str, str, Optional[dict]]] = []
        self.dropped = 0
        self.flagged = False
        # tenant label, stamped at admission by serving (None for
        # untenanted traffic); set-once before the request enters the
        # pipeline, so unguarded reads are safe like graph_version
        self.tenant: Optional[str] = None
        # topology version at admission (None without a streaming graph);
        # immutable after construction, so unguarded reads are safe
        self.graph_version = graph_version()
        self._lock = threading.Lock()

    def add(self, name: str, attrs: Optional[dict] = None) -> None:
        t = time.perf_counter()
        th = threading.current_thread().name
        with self._lock:
            if len(self.events) < _MAX_EVENTS_PER_TRACE:
                self.events.append((t, name, th, attrs))
            else:
                self.dropped += 1

    def flag(self) -> None:
        """Force retention at finish regardless of latency/status."""
        with self._lock:
            self.flagged = True

    def to_record(self, e2e_seconds: Optional[float] = None,
                  status: str = "ok", reason: Optional[str] = None,
                  lane: Optional[str] = None,
                  stages: Optional[dict] = None) -> dict:
        """Plain-JSON view; event times are seconds relative to enqueue."""
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
            flagged = self.flagged
        rec = {
            "trace_id": self.trace_id,
            "wall_start": self.wall_start,
            "status": status,
            "flagged": flagged,
            "events": [
                {"t": max(t - self.t_start, 0.0), "name": name,
                 "thread": th, "attrs": attrs or {}}
                for t, name, th, attrs in events
            ],
            "events_dropped": dropped,
        }
        if self.graph_version is not None:
            rec["graph_version"] = self.graph_version
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        if e2e_seconds is not None:
            rec["e2e_seconds"] = float(e2e_seconds)
        if reason is not None:
            rec["reason"] = reason
        if lane is not None:
            rec["lane"] = lane
        if stages:
            rec["stages"] = {k: float(v) for k, v in stages.items()}
        return rec


class _Activation:
    """Context manager installing a tuple of traces on the context-var."""

    __slots__ = ("_ctxs", "_token")

    def __init__(self, ctxs: Tuple[TraceContext, ...]):
        self._ctxs = ctxs
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self._ctxs)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return False


class _NoopActivation:
    """Shared, stateless, reentrant — activating nothing costs nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_ACTIVATION = _NoopActivation()


def new_trace(trace_id: Optional[str] = None) -> Optional[TraceContext]:
    """A fresh trace context, or None when telemetry is disabled (the
    None threads through the pipeline for free: every consumer guards)."""
    from . import enabled

    if not enabled():
        return None
    ctx = TraceContext(trace_id)
    return ctx


def tracing() -> bool:
    """True iff the calling context has at least one live trace — ONE
    context-var read, so hot paths can guard event-dict construction."""
    return _ACTIVE.get() is not None


def active() -> Optional[Tuple[TraceContext, ...]]:
    """The raw active tuple (or None) — capture this before handing work
    to a thread pool, then re-activate inside the worker."""
    return _ACTIVE.get()


def current() -> Optional[TraceContext]:
    """First active trace context, for single-request call sites."""
    ctxs = _ACTIVE.get()
    return ctxs[0] if ctxs else None


def activate(ctx):
    """``with activate(ctx):`` — attribute the block's events to ``ctx``.

    Accepts a single :class:`TraceContext`, a sequence of them (a
    coalesced batch), a tuple captured via :func:`active`, or None /
    empty (returns a shared no-op so disabled pipelines allocate
    nothing).
    """
    if ctx is None:
        return _NOOP_ACTIVATION
    if isinstance(ctx, TraceContext):
        return _Activation((ctx,))
    ctxs = tuple(c for c in ctx if c is not None)
    if not ctxs:
        return _NOOP_ACTIVATION
    return _Activation(ctxs)


def event(name: str, attrs: Optional[dict] = None) -> None:
    """Append one event to every active trace; no-op off a live trace.

    Hot paths should guard with :func:`tracing` before building
    ``attrs`` so the dict literal itself is never allocated when no
    request is being traced.
    """
    ctxs = _ACTIVE.get()
    if ctxs is None:
        return
    for c in ctxs:
        c.add(name, attrs)
    if _timeline._ON:  # one global read when the timeline is off
        # a {"seconds": dt} attr is a stage interval that just closed:
        # surface it as a complete slice, anything else as an instant
        dur = attrs.get("seconds") if attrs else None
        _timeline.emit(name, dur_s=dur, attrs=attrs, trace=ctxs[0])


def flag() -> None:
    """Flag every active trace for retention (operator breadcrumb: mark
    the request you are about to debug, then pull /debug/requests)."""
    ctxs = _ACTIVE.get()
    if ctxs is None:
        return
    for c in ctxs:
        c.flag()


class FlightRecorder:
    """Tail-sampling ring buffer of finished request records.

    Fixed capacity (``config.flightrec_capacity``): retaining a record
    past capacity evicts the oldest, so steady-state memory is
    O(capacity x events-per-trace) no matter how long the server runs.
    Retention reasons, in precedence order: any non-ok status verbatim
    (``error`` — the request failed; ``shed`` — admission control or a
    deadline dropped it; ``rejected`` — the payload never parsed),
    then ``flagged`` (explicitly marked), then ``slow`` (end-to-end
    above ``config.flightrec_slow_ms``).  Everything else is discarded
    at finish and only ticks ``flightrec_dropped_total``.
    """

    _guarded_by = {"_ring": "_lock", "_by_id": "_lock"}

    def __init__(self, capacity: Optional[int] = None,
                 slow_threshold_s: Optional[float] = None):
        if capacity is None or slow_threshold_s is None:
            from ..config import get_config

            cfg = get_config()
            if capacity is None:
                capacity = int(cfg.flightrec_capacity)
            if slow_threshold_s is None:
                slow_threshold_s = float(cfg.flightrec_slow_ms) / 1e3
        self.capacity = max(int(capacity), 1)
        self.slow_threshold_s = float(slow_threshold_s)
        self._lock = threading.Lock()
        self._ring: List[dict] = []
        self._by_id: Dict[str, dict] = {}

    # -- finish-time decision -----------------------------------------
    def classify(self, ctx: TraceContext, e2e_seconds: float,
                 status: str) -> Optional[str]:
        if status != "ok":
            return status  # error / shed / rejected — all worth keeping
        if ctx.flagged:
            return "flagged"
        if e2e_seconds > self.slow_threshold_s:
            return "slow"
        return None

    def finish(self, ctx: Optional[TraceContext], e2e_seconds: float,
               status: str = "ok", lane: Optional[str] = None,
               stages: Optional[dict] = None) -> Optional[str]:
        """Retain or discard ``ctx``.  Returns the retention reason, or
        None when the record was dropped (the common, fast case)."""
        if ctx is None:  # telemetry disabled at enqueue: nothing to do
            return None
        from . import counter

        if _timeline._ON:  # one global read when the timeline is off
            # the request's end-to-end slice IS the correlation origin:
            # every stage event sharing its trace_id nests under it
            _timeline.emit("request", cat="serving", dur_s=e2e_seconds,
                           attrs={"status": status, "lane": lane},
                           trace=ctx)
        reason = self.classify(ctx, e2e_seconds, status)
        if reason is None:
            counter("flightrec_dropped_total").inc()
            return None
        rec = ctx.to_record(e2e_seconds, status=status, reason=reason,
                            lane=lane, stages=stages)
        with self._lock:
            while len(self._ring) >= self.capacity:
                old = self._ring.pop(0)
                self._by_id.pop(old["trace_id"], None)
            self._ring.append(rec)
            self._by_id[rec["trace_id"]] = rec
        counter("flightrec_retained_total", reason=reason).inc()
        return reason

    # -- read side -----------------------------------------------------
    def records(self) -> List[dict]:
        """Retained records, oldest first (full event logs)."""
        with self._lock:
            return list(self._ring)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            return self._by_id.get(trace_id)

    def summaries(self) -> List[dict]:
        """Index view for ``GET /debug/requests``: everything except the
        event log (pull ``/debug/requests/<trace_id>`` for that)."""
        out = []
        for rec in self.records():
            summary = {
                "trace_id": rec["trace_id"],
                "wall_start": rec["wall_start"],
                "e2e_ms": round(rec.get("e2e_seconds", 0.0) * 1e3, 3),
                "status": rec["status"],
                "reason": rec.get("reason"),
                "lane": rec.get("lane"),
                "n_events": len(rec["events"]),
            }
            if "tenant" in rec:
                summary["tenant"] = rec["tenant"]
            out.append(summary)
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_id.clear()


_RECORDER: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """Process-wide recorder (lazy: config is read at first touch)."""
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _recorder_lock:
            rec = _RECORDER
            if rec is None:
                rec = _RECORDER = FlightRecorder()
    return rec


def reset() -> None:
    """Drop retained records, re-read config, unhook the graph-version
    provider (tests)."""
    global _RECORDER, _VERSION_PROVIDER
    with _recorder_lock:
        _RECORDER = None
    _VERSION_PROVIDER = None


def partition_check(record: dict, rel_tol: float = 0.25) -> bool:
    """Debug helper: do the record's stage intervals partition its
    end-to-end latency?  (Used by tests and worth keeping importable —
    an operator sanity check that the recorder's accounting is closed.)
    """
    stages = record.get("stages") or {}
    e2e = record.get("e2e_seconds")
    if e2e is None or not stages:
        return False
    s = sum(stages.values())
    return math.isclose(s, e2e, rel_tol=rel_tol, abs_tol=5e-3)
