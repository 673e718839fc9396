"""Shared do-nothing singletons for ``QUIVER_TELEMETRY=off``.

Every facade entry point answers with one of these pre-built objects
when telemetry is disabled, so the instrumented hot paths pay only a
module-global bool check and a method call — no locks, no
``perf_counter``, and no net allocations (the zero-allocation property
is pinned by the telemetry tests).

The noop span/timer is **stateless and reentrant**: ``__enter__``
returns the shared instance itself, so the same object can be live in
any number of nested/concurrent ``with`` blocks.
"""

from __future__ import annotations

__all__ = ["METRIC", "SPAN", "REGISTRY", "TRACER"]

_EMPTY_SNAPSHOT: dict = {"counters": {}, "gauges": {}, "histograms": {}}


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NoopMetric:
    """Quacks like Counter, Gauge, and Histogram at once."""

    __slots__ = ()
    key = ""
    value = 0.0
    sum = 0.0
    count = 0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def time(self):
        return SPAN

    def percentile(self, q: float) -> float:
        return 0.0


class _NoopRegistry:
    __slots__ = ()

    def counter(self, name, help=None, **labels):
        return METRIC

    def gauge(self, name, help=None, **labels):
        return METRIC

    def histogram(self, name, bounds=None, help=None, **labels):
        return METRIC

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def merge(self, snap) -> None:
        pass

    def reset(self) -> None:
        pass

    def __iter__(self):
        return iter(())


class _NoopTracer:
    __slots__ = ()
    tracing = False

    def span(self, name, block=None):
        return SPAN

    def set_tracing(self, on) -> None:
        pass

    def summary(self) -> dict:
        return {}

    def events(self):
        return []

    def reset(self) -> None:
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


METRIC = _NoopMetric()
SPAN = _NoopSpan()
REGISTRY = _NoopRegistry()
TRACER = _NoopTracer()
