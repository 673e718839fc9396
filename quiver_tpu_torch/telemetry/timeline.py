"""Unified timeline event bus — one Perfetto-loadable view of a process.

The spans answer "how long does each scope take on average?", the
flight recorder answers "why was this request slow?", Prometheus
counters answer "how much?".  None of them can show one batch's journey
*across* subsystems — a request that stalls because its gather faulted
twelve pages while a chaos delay stalled its lane and the QoS ladder
stepped down is three disconnected stories.  This module merges
them: every subsystem emits lightweight events into per-thread bounded
rings, and :func:`chrome_trace` serializes the union as Chrome
trace-event JSON (loadable in Perfetto / chrome://tracing) with the
flight-recorder correlation identity (``trace_id`` / ``tenant`` /
``graph_version``) stamped into each event's ``args``.

Sources that land here when the timeline is enabled:

  * **span closes** — :class:`~quiver_tpu_torch.telemetry.spans.SpanTracer`
    forwards every closed span (``cat="span"``);
  * **flight-recorder events** — :func:`flightrec.event` forwards each
    request-scoped event; a ``{"seconds": dt}`` attr becomes a complete
    ("X") slice, anything else an instant;
  * **direct emits** — chaos injections, QoS ladder transitions,
    serving admissions, and the per-program profiler (:mod:`.profile`) call :func:`emit` at their
    own sites, so they appear even when no request trace is active.

Gating discipline (same as flightrec / chaos): the timeline is OFF by
default and every emit site guards with ``if timeline.on():`` — ONE
module-global read, no locks, no clocks, no allocations on the off
path (``QUIVER_TELEMETRY=off`` keeps it off no matter what; a pinned
test asserts ``on()`` reads exactly one global).  Enabled, each emit
is one thread-local ring append; rings are bounded
(``config.timeline_ring_capacity`` events per thread) so a runaway
emitter overwrites its own oldest events instead of growing without
bound.

Lock discipline: rings are single-writer (thread-local); only
the ring *registry* is shared, and every mutation holds ``_REG_LOCK``.
Export snapshots each ring's buffer under the same lock — a torn read
of a concurrently-overwritten slot would interleave two events.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "on", "enable", "disable", "reset",
    "emit", "instant", "events", "chrome_trace", "export", "status",
]

# THE gate.  Emit sites read this one module global (via :func:`on` or
# ``timeline._ON`` directly); everything else in this module is only
# reachable when it is True.
_ON = False

_REG_LOCK = threading.Lock()
_RINGS: List["_Ring"] = []
_TLS = threading.local()
_CAPACITY = 8192          # per-thread ring slots; re-read from config
_SEQ_LOCK = threading.Lock()


def _telemetry_enabled() -> bool:
    from . import enabled

    return enabled()


class _Ring:
    """One thread's bounded event buffer.

    Single writer (the owning thread): appends are lock-free — a list
    append / slot store is atomic under the GIL, and events are
    immutable tuples replaced whole, so a concurrent exporter can read
    a stale slot but never a torn one.  Only registration in the
    shared ``_RINGS`` list takes ``_REG_LOCK``.
    """

    __slots__ = ("tid", "thread_name", "buf", "n", "cap")

    def __init__(self, cap: int):
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.buf: List[tuple] = []
        self.n = 0          # total events ever emitted by this thread
        self.cap = cap

    def append(self, ev: tuple) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.n % self.cap] = ev
        self.n += 1

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)

    def ordered(self) -> List[tuple]:
        """Events oldest-first (unwraps the ring)."""
        if self.n <= self.cap:
            return list(self.buf)
        i = self.n % self.cap
        return self.buf[i:] + self.buf[:i]


def on() -> bool:
    """True iff the timeline is recording — ONE module-global read, so
    hot paths can guard event construction for free when it is off."""
    return _ON


def enable(capacity: Optional[int] = None) -> bool:
    """Start recording.  Returns False (and stays off) when telemetry
    itself is disabled — ``QUIVER_TELEMETRY=off`` wins."""
    global _ON, _CAPACITY
    if not _telemetry_enabled():
        return False
    if capacity is None:
        from ..config import get_config

        capacity = int(get_config().timeline_ring_capacity)
    with _REG_LOCK:
        _CAPACITY = max(int(capacity), 1)
    # single atomic bool rebind; emit-site
    # readers tolerate one stale observation by design (a missed first
    # event, never a torn ring)
    _ON = True
    return True


def disable() -> None:
    global _ON
    # single atomic bool rebind, see enable
    _ON = False


def reset() -> None:
    """Drop every ring and stop recording (tests)."""
    global _ON, _TLS
    _ON = False
    with _REG_LOCK:
        _RINGS.clear()
        # orphan the thread-local rings: no longer registered, so the
        # exporter never sees them again; emitters lazily re-register.
        # The swap happens under _REG_LOCK with the clear so a racing
        # _ring() can never register a fresh ring against the old list.
        _TLS = threading.local()


def _ring() -> _Ring:
    # reset() swaps _TLS wholesale, so a stale ring can never be
    # resurrected here — the None check alone keeps emits lock-free
    tls = _TLS
    r = getattr(tls, "ring", None)
    if r is None:
        r = _Ring(_CAPACITY)
        with _REG_LOCK:
            _RINGS.append(r)
        tls.ring = r
    return r


def _seen_rings() -> List["_Ring"]:
    with _REG_LOCK:
        return list(_RINGS)


# serving's stage events predate dotted names; map them home
_CAT_MAP = {
    "sample": "serving", "gather": "serving", "infer": "serving",
    "dequeue": "serving", "enqueue": "serving", "request": "serving",
}


def _category(name: str) -> str:
    cat = _CAT_MAP.get(name)
    if cat is not None:
        return cat
    if "." in name:
        head = name.split(".", 1)[0]
        return {"feature": "paged"}.get(head, head)
    return "app"


def emit(name: str, cat: Optional[str] = None,
         dur_s: Optional[float] = None, t0: Optional[float] = None,
         attrs: Optional[dict] = None, trace=None) -> None:
    """Record one event on the calling thread's ring.

    Callers guard with ``if timeline.on():`` — this function assumes
    the gate already passed (calling it while off still works, it just
    pays the cost the guard exists to avoid).  ``dur_s`` makes a
    complete slice ("X"), otherwise an instant ("i"); ``t0`` backdates
    the slice start (defaults to now - dur).  ``trace`` overrides the
    flight-recorder correlation (a :class:`TraceContext`); by default
    the first active trace on this thread is stamped in.
    """
    t = time.perf_counter()
    if trace is None:
        from . import flightrec

        trace = flightrec.current()
    if t0 is None:
        t0 = t - (dur_s or 0.0)
    if cat is None:
        cat = _category(name)
    tid = None
    tenant = gver = None
    if trace is not None:
        tid = trace.trace_id
        tenant = trace.tenant
        gver = trace.graph_version
    _ring().append((t0, dur_s, name, cat, tid, tenant, gver, attrs))
    from . import counter

    counter("timeline_events_total", subsystem=cat).inc()


def instant(name: str, cat: Optional[str] = None,
            attrs: Optional[dict] = None) -> None:
    emit(name, cat=cat, attrs=attrs)


# -- read side ---------------------------------------------------------
def events() -> List[dict]:
    """Every retained event as plain dicts, per-thread order preserved
    within each thread, threads concatenated."""
    out = []
    for r in _seen_rings():
        for (t0, dur, name, cat, tid, tenant, gver, attrs) in r.ordered():
            e = {"t": t0, "name": name, "cat": cat,
                 "thread": r.thread_name, "tid": r.tid}
            if dur is not None:
                e["dur_s"] = dur
            if tid is not None:
                e["trace_id"] = tid
            if tenant is not None:
                e["tenant"] = tenant
            if gver is not None:
                e["graph_version"] = gver
            if attrs:
                e["attrs"] = dict(attrs)
            out.append(e)
    return out


def status() -> dict:
    rings = _seen_rings()
    return {
        "enabled": _ON,
        "threads": len(rings),
        "events": sum(min(r.n, r.cap) for r in rings),
        "dropped": sum(r.dropped for r in rings),
        "capacity_per_thread": _CAPACITY,
    }


def chrome_trace() -> dict:
    """Chrome trace-event JSON over every ring — complete "X" slices
    for duration events, "i" instants otherwise, one tid per emitting
    thread with its name as "M" metadata.  Timestamps are absolute
    ``perf_counter`` microseconds, the same clock every subsystem
    stamps, so merged events line up."""
    pid = os.getpid()
    evs: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "quiver_tpu_torch"},
    }]
    dropped = 0
    for r in _seen_rings():
        evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": r.tid, "args": {"name": r.thread_name}})
        dropped += r.dropped
        for (t0, dur, name, cat, tid, tenant, gver, attrs) in r.ordered():
            args: Dict[str, Any] = dict(attrs) if attrs else {}
            if tid is not None:
                args["trace_id"] = tid
            if tenant is not None:
                args["tenant"] = tenant
            if gver is not None:
                args["graph_version"] = gver
            e: Dict[str, Any] = {
                "name": name, "cat": cat, "pid": pid, "tid": r.tid,
                "ts": t0 * 1e6, "args": args,
            }
            if dur is not None:
                e["ph"] = "X"
                e["dur"] = dur * 1e6
            else:
                e["ph"] = "i"
                e["s"] = "t"
            evs.append(e)
    out: Dict[str, Any] = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if dropped:
        out["otherData"] = {"dropped_events": dropped}
    return out


def export(path: str) -> str:
    """Write :func:`chrome_trace` to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path
