"""quiver_tpu_torch.telemetry — metrics and tracing for the port
(counterpart of the JAX package's ``telemetry``, with the same metric
names, keys and snapshot shape).

One process-wide :class:`MetricsRegistry` (counters / gauges /
fixed-bucket histograms, label support, mergeable snapshots) plus one
:class:`SpanTracer` (nested spans, Chrome trace-event export).  Hot
paths call the module-level helpers::

    from quiver_tpu_torch import telemetry

    telemetry.counter("sampler_batches_total", mode="gpu").inc()
    with telemetry.histogram("feature_gather_seconds", tier="hot").time():
        ...
    with telemetry.span("sampler.sample", block=out):
        ...

The registry is the port's own object, separate from the JAX package's.

Gating: ``QUIVER_TELEMETRY=off`` (or ``0``/``false``/``no``) makes every
helper answer with a shared do-nothing singleton from :mod:`.noop` —
no locks, no clocks, no net allocations.  Default is ON.  Span *event
retention* (Chrome traces) stays opt-in via ``QUIVER_TPU_TRACE=1`` or
``get_tracer().set_tracing(True)`` either way.

The HTTP exporter lives in :mod:`.export` and is imported lazily.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from . import noop as _noop
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       DEFAULT_TIME_BUCKETS, metric_key, parse_metric_key,
                       snapshot_delta, summarize_snapshot)
from .spans import Span, SpanTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "SpanTracer", "DEFAULT_TIME_BUCKETS", "metric_key", "parse_metric_key",
    "snapshot_delta", "summarize_snapshot",
    "enabled", "set_enabled", "get_registry", "get_tracer",
    "counter", "gauge", "histogram", "span",
    "snapshot", "merge", "reset",
]

_ENABLED = os.environ.get("QUIVER_TELEMETRY", "on").strip().lower() not in (
    "off", "0", "false", "no")

_registry = MetricsRegistry()
_tracer = SpanTracer()

# the package's root, for the companion singletons reset() reaches
_ROOT = __name__.rsplit(".", 1)[0]


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip telemetry at runtime (overrides ``QUIVER_TELEMETRY``)."""
    global _ENABLED
    # quiverlint: ignore[QT008] -- single atomic bool rebind; worker
    # readers tolerate one stale observation by design (noop fallback)
    _ENABLED = bool(on)


def get_registry() -> MetricsRegistry:
    return _registry if _ENABLED else _noop.REGISTRY


def get_tracer() -> SpanTracer:
    return _tracer if _ENABLED else _noop.TRACER


def counter(name: str, help: Optional[str] = None, **labels) -> Counter:
    if _ENABLED:
        return _registry.counter(name, help=help, **labels)
    return _noop.METRIC


def gauge(name: str, help: Optional[str] = None, **labels) -> Gauge:
    if _ENABLED:
        return _registry.gauge(name, help=help, **labels)
    return _noop.METRIC


def histogram(name: str, bounds: Optional[Sequence[float]] = None,
              help: Optional[str] = None, **labels) -> Histogram:
    if _ENABLED:
        return _registry.histogram(name, bounds=bounds, help=help, **labels)
    return _noop.METRIC


def span(name: str, block=None):
    return _tracer.span(name, block=block) if _ENABLED else _noop.SPAN


def snapshot() -> dict:
    """Snapshot of the *real* registry (even while disabled, so a
    paused session can still read what was collected)."""
    return _registry.snapshot()


def merge(snap: dict) -> None:
    _registry.merge(snap)


def reset() -> None:
    """Empty the registry and the tracer, and reset the companion
    singletons that have been imported (flight recorder, timeline,
    profile, SLO watchdog, breakers); none is imported just to reset
    it."""
    _registry.reset()
    _tracer.reset()
    for mod in ("telemetry.flightrec", "telemetry.timeline",
                "telemetry.profile", "telemetry.slo",
                "resilience.breaker"):
        m = sys.modules.get(f"{_ROOT}.{mod}")
        if m is not None:
            m.reset()
