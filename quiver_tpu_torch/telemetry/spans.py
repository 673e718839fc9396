"""Span tracer: nested wall-clock scopes + Chrome trace-event export.

``utils.trace.trace_scope`` / ``Timer`` delegate here.  Two independent
switches:

  * **aggregation** is always on for a live (non-noop) tracer: every
    span folds into ``{name: [count, total_s]}`` — this is what
    ``summary()`` (né ``trace_summary``) reads and costs one lock + two
    adds per span.
  * **event retention** (``set_tracing(True)`` or env
    ``QUIVER_TPU_TRACE=1``) additionally appends one event record per
    span — name, start/duration in µs, pid/tid, nesting depth, the
    enclosing span's name and the id of the outermost span of its thread
    (one id a root, shared by everything under it) — which
    ``chrome_trace()`` serializes as Chrome trace-event JSON
    (``{"traceEvents": [...]}``) loadable in Perfetto / chrome://tracing.
    While a retained span is open under a ``torch.profiler`` capture, it
    also opens ``record_function("quiver.<name>")``, so the profiler's
    trace shows it on the card's clock, over the kernels it launched.

The training step's spans (``train.*``) are hot-path sites: they record
only while the process-wide tracer retains events and telemetry is
enabled, and otherwise cost their site one read of :data:`_HOT` and
nothing else (no ``Span``, no clock, no lock), so aggregation alone never
reaches them.  :func:`gate` and ``SpanTracer.set_tracing`` keep that one
global current.

A word on async launches: a span around work on the card measures the
**launch** unless you pass ``block=`` a tensor (or a list of tensors):
the span then synchronizes each CUDA tensor's device stream (the current
one) before it closes, so it covers the device time.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from . import timeline as _timeline

__all__ = ["SpanTracer", "Span", "synchronize"]

_MAX_EVENTS = 200_000  # retention cap: ~25 MB of events, then drop
PROFILER_PREFIX = "quiver."  # names of the spans in a torch.profiler trace
# the process id stamped on each event: ``os.getpid`` is a system call (2-4
# µs on an H100 machine's host, a third of a retained span there), so it is
# read once, and again in a forked child
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)

# THE gate of the hot-path spans: the process-wide tracer retains events
# and telemetry is enabled.  Their sites read this one module global;
# everything else they do is only reachable when it is True.
_HOT = False
_process: Optional["SpanTracer"] = None   # the telemetry package's tracer
_telemetry_on = True


def gate(tracer: "SpanTracer", telemetry_on: bool) -> None:
    """Name the process-wide ``tracer`` and whether telemetry is enabled
    (the telemetry package calls this), and set :data:`_HOT` from them."""
    global _process, _telemetry_on
    _process, _telemetry_on = tracer, bool(telemetry_on)
    _regate()


def _regate() -> None:
    global _HOT
    _HOT = _telemetry_on and _process._tracing


def _env_tracing() -> bool:
    return os.environ.get("QUIVER_TPU_TRACE", "").strip().lower() in (
        "1", "true", "on", "yes")


def synchronize(block) -> None:
    """Wait for the current stream of each CUDA tensor in ``block`` (a
    tensor or a list or tuple of them); CPU tensors are ready already."""
    for x in (block if isinstance(block, (list, tuple)) else (block,)):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()


class Span:
    """One ``with``-scope.  Created per call (only when telemetry is
    enabled); closing folds into the tracer's aggregate and, when
    tracing, appends an event record."""

    __slots__ = ("_tracer", "name", "_block", "_t0", "_depth", "_parent",
                 "_root", "_rf")

    def __init__(self, tracer: "SpanTracer", name: str, block=None):
        self._tracer = tracer
        self.name = name
        self._block = block

    def __enter__(self):
        tracer = self._tracer
        tls = tracer._tls
        parent = getattr(tls, "top", None)
        self._parent = parent
        if parent is None:
            self._depth, self._root = 0, next(tracer._roots)
        else:
            self._depth, self._root = parent._depth + 1, parent._root
        tls.top = self
        self._rf = None
        if tracer._tracing and torch.autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._block is not None:
            synchronize(self._block)
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        parent = self._parent
        self._tracer._tls.top = parent
        self._tracer._close(self.name, self._t0, t1, self._depth,
                            None if parent is None else parent.name,
                            self._root)
        return False


class SpanTracer:
    """Aggregating tracer with optional Chrome-trace event retention."""

    def __init__(self, tracing: Optional[bool] = None):
        self._lock = threading.Lock()
        self._agg: Dict[str, List[float]] = {}   # name -> [count, total_s]
        self._events: List[dict] = []
        self._dropped = 0
        self._tls = threading.local()
        self._roots = itertools.count(1)
        self._epoch = time.perf_counter()
        self._tracing = _env_tracing() if tracing is None else bool(tracing)

    # -- recording --------------------------------------------------------
    def span(self, name: str, block=None) -> Span:
        return Span(self, name, block=block)

    def _close(self, name: str, t0: float, t1: float, depth: int,
               parent: Optional[str], root: int) -> None:
        dt = t1 - t0
        with self._lock:
            s = self._agg.get(name)
            if s is None:
                self._agg[name] = [1, dt]
            else:
                s[0] += 1
                s[1] += dt
            if self._tracing:
                if len(self._events) < _MAX_EVENTS:
                    self._events.append({
                        "name": name,
                        "ts_us": (t0 - self._epoch) * 1e6,
                        "dur_us": dt * 1e6,
                        "pid": _PID,
                        "tid": threading.get_ident(),
                        "depth": depth,
                        "parent": parent,
                        "root": root,
                    })
                else:
                    self._dropped += 1
        if _timeline._ON:  # one global read when the timeline is off
            _timeline.emit(name, cat="span", dur_s=dt, t0=t0,
                           attrs={"depth": depth} if depth else None)

    # -- switches ---------------------------------------------------------
    @property
    def tracing(self) -> bool:
        return self._tracing

    def set_tracing(self, on: bool) -> None:
        self._tracing = bool(on)
        if self is _process:
            _regate()

    # -- readout ----------------------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """``{name: {count, total_s, mean_ms}}`` — same shape the old
        ``trace_summary()`` returned."""
        with self._lock:
            return {
                name: {
                    "count": int(c),
                    "total_s": t,
                    "mean_ms": (t / c * 1e3) if c else 0.0,
                }
                for name, (c, t) in sorted(self._agg.items())
            }

    def events(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._events.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    # -- Chrome trace-event JSON -----------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (complete "X" events, µs units) —
        load via Perfetto (ui.perfetto.dev) or chrome://tracing."""
        with self._lock:
            evs = [
                {
                    "name": e["name"],
                    "ph": "X",
                    "ts": e["ts_us"],
                    "dur": e["dur_us"],
                    "pid": e["pid"],
                    "tid": e["tid"],
                    "args": {"depth": e["depth"], "parent": e["parent"],
                             "root": e["root"]},
                }
                for e in self._events
            ]
            dropped = self._dropped
        out: Dict[str, Any] = {"traceEvents": evs, "displayTimeUnit": "ms"}
        if dropped:
            out["otherData"] = {"dropped_events": dropped}
        return out

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    @staticmethod
    def parse_chrome_trace(data) -> List[dict]:
        """Inverse of :meth:`chrome_trace` for round-trip tests and
        offline analysis: accepts the dict (or its JSON string) and
        returns event records in :meth:`events` form."""
        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        out = []
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            out.append({
                "name": e["name"],
                "ts_us": e["ts"],
                "dur_us": e["dur"],
                "pid": e["pid"],
                "tid": e["tid"],
                "depth": e.get("args", {}).get("depth", 0),
                "parent": e.get("args", {}).get("parent"),
                "root": e.get("args", {}).get("root"),
            })
        return out
