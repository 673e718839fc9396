"""SLO watchdog — rolling burn rates over the metrics registry.

Declared objectives live in :mod:`quiver_tpu_torch.config`:

  * ``slo_p99_ms`` — p99 end-to-end serving latency ceiling,
  * ``slo_error_ratio`` — errored / total request ratio ceiling,
  * ``slo_coldcache_hit_floor`` — coldcache hit-rate floor (0 disables;
    a budgeted feature tier whose overlay stops hitting is about to
    drag gather latency through the host link).

Each evaluation snapshots the registry, takes the delta against the
previous snapshot (so every tick scores only the *window* since the
last one — a rolling rate, not a lifetime average), computes the three
indicators, and compares against the objectives.  ``burn`` is the
standard burn-rate reading: observed / allowed for ceilings, allowed /
observed for floors — burn > 1 means the objective is breaching and the
error budget is being spent faster than provisioned.  Breaches tick
``slo_breaches_total{objective=...}`` and flip the objective's
``breaching`` bit in :meth:`SLOWatchdog.status`, which is what
``GET /debug/slo`` serves.

The watchdog thread is explicitly started
(``InferenceServer.start_slo_watchdog()`` or ``watchdog.start()``) —
``status()`` also evaluates on demand when no thread is running, so the
debug endpoint is always live.  Evaluation is read-only over snapshots:
it never touches the serving hot path and costs one registry snapshot
per tick.

Locking: evaluation state is written from the watchdog thread and read
from HTTP handler threads; both hold ``_lock``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .registry import parse_metric_key, snapshot_delta

__all__ = ["SLOWatchdog", "get_watchdog", "reset"]


def _sum_counters(snap: dict, name: str,
                  where: Optional[dict] = None) -> float:
    total = 0.0
    for key, v in snap.get("counters", {}).items():
        n, labels = parse_metric_key(key)
        if n != name:
            continue
        if where and any(labels.get(k) != v2 for k, v2 in where.items()):
            continue
        total += v
    return total


def _merged_histogram(snap: dict, name: str):
    """Merge every labelled instance of ``name`` in a snapshot into one
    Histogram (lanes share the fixed default bounds, so the merge is
    exact)."""
    from .registry import Histogram

    h = None
    for key, d in snap.get("histograms", {}).items():
        n, _ = parse_metric_key(key)
        if n != name:
            continue
        if h is None:
            h = Histogram(bounds=d["bounds"])
        h.merge_dict(d)
    return h


class SLOWatchdog:
    """Periodic evaluator of serving SLOs against registry deltas."""

    _guarded_by = {"_state": "_lock", "_prev": "_lock", "_ticks": "_lock",
                   "_listeners": "_lock"}

    def __init__(self, registry=None, interval_s: Optional[float] = None,
                 p99_ms: Optional[float] = None,
                 error_ratio: Optional[float] = None,
                 coldcache_hit_floor: Optional[float] = None):
        from ..config import get_config

        cfg = get_config()
        if registry is None:
            from . import get_registry

            registry = get_registry()
        self.registry = registry
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.slo_interval_s)
        self.p99_ms = float(p99_ms if p99_ms is not None else cfg.slo_p99_ms)
        self.error_ratio = float(error_ratio if error_ratio is not None
                                 else cfg.slo_error_ratio)
        self.coldcache_hit_floor = float(
            coldcache_hit_floor if coldcache_hit_floor is not None
            else cfg.slo_coldcache_hit_floor)
        self._lock = threading.Lock()
        self._prev: Optional[dict] = None
        self._state: Dict[str, dict] = {}
        self._ticks = 0
        self._listeners: List = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_listener(self, fn) -> None:
        """Register ``fn(results)`` to run after every evaluation — the
        reaction hook (the QoS degradation ladder attaches here).
        Listener exceptions are swallowed: a broken reaction must not
        kill SLO scoring."""
        with self._lock:
            self._listeners.append(fn)

    # -- evaluation -----------------------------------------------------
    def evaluate_once(self) -> List[dict]:
        """Score one window (now - previous tick).  Returns the updated
        per-objective state and ticks ``slo_breaches_total`` for every
        breaching objective."""
        snap = self.registry.snapshot()
        with self._lock:
            prev = self._prev
            self._prev = snap
        window = snapshot_delta(prev, snap) if prev is not None else snap

        results = self._score(window)

        from . import counter

        for r in results:
            if r["breaching"]:
                counter("slo_breaches_total", objective=r["objective"]).inc()
        with self._lock:
            self._ticks += 1
            for r in results:
                st = self._state.setdefault(
                    r["objective"], {"breaches_total": 0})
                if r["breaching"]:
                    st["breaches_total"] += 1
                st.update(r)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(results)
            except Exception:
                # a reaction bug must not kill the scoring loop — it is
                # accounted, and the ladder keeps its own telemetry
                counter("slo_listener_errors_total").inc()
        return results

    def _score(self, window: dict) -> List[dict]:
        """The objective battery for one window.  Subclasses replace
        this to swap objectives while keeping the tick/breach/listener
        machinery."""
        results = [self._eval_p99(window), self._eval_errors(window)]
        if self.coldcache_hit_floor > 0:
            results.append(self._eval_coldcache(window))
        return results

    def _eval_p99(self, window: dict) -> dict:
        h = _merged_histogram(window, "serving_request_seconds")
        n = h.count if h is not None else 0
        p99_ms = h.percentile(99) * 1e3 if n else 0.0
        return {
            "objective": "p99_latency",
            "target": self.p99_ms, "unit": "ms",
            "value": round(p99_ms, 3), "samples": int(n),
            "burn": round(p99_ms / self.p99_ms, 4) if self.p99_ms else 0.0,
            "breaching": bool(n and p99_ms > self.p99_ms),
        }

    def _eval_errors(self, window: dict) -> dict:
        err = _sum_counters(window, "serving_requests_total",
                           {"status": "error"})
        total = _sum_counters(window, "serving_requests_total")
        ratio = err / total if total else 0.0
        return {
            "objective": "error_ratio",
            "target": self.error_ratio, "unit": "ratio",
            "value": round(ratio, 6), "samples": int(total),
            "burn": (round(ratio / self.error_ratio, 4)
                     if self.error_ratio else 0.0),
            "breaching": bool(total and ratio > self.error_ratio),
        }

    def _eval_coldcache(self, window: dict) -> dict:
        hit = _sum_counters(window, "feature_coldcache_rows_total",
                            {"result": "hit"})
        miss = _sum_counters(window, "feature_coldcache_rows_total",
                             {"result": "miss"})
        total = hit + miss
        rate = hit / total if total else 1.0
        floor = self.coldcache_hit_floor
        return {
            "objective": "coldcache_hit_rate",
            "target": floor, "unit": "ratio",
            "value": round(rate, 6), "samples": int(total),
            # floor objective: burn > 1 means the hit rate fell below it
            "burn": round(floor / rate, 4) if rate else float(total > 0),
            "breaching": bool(total and rate < floor),
        }

    # -- status / thread ------------------------------------------------
    def status(self) -> dict:
        """JSON view for ``GET /debug/slo``.  Evaluates on demand when
        the thread isn't running — or hasn't completed its first tick
        yet — so the endpoint never serves stale nothing."""
        with self._lock:
            ticked = self._ticks > 0
        if (self._thread is None or not self._thread.is_alive()
                or not ticked):
            self.evaluate_once()
        with self._lock:
            objectives = [dict(v) for _, v in sorted(self._state.items())]
            ticks = self._ticks
        return {
            "interval_s": self.interval_s,
            "running": bool(self._thread is not None
                            and self._thread.is_alive()),
            "ticks": ticks,
            "objectives": objectives,
        }

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # a scoring bug must never kill the thread
                pass

    def start(self) -> "SLOWatchdog":
        """Start (idempotently) the evaluation thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="quiver-slo-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # local import: resilience.shutdown itself imports telemetry
        from ..resilience.shutdown import join_and_reap

        self._stop.set()
        t = self._thread
        if t is not None:
            join_and_reap([t], max(self.interval_s * 2, 1.0),
                          component="telemetry.slo")
            self._thread = None


_WATCHDOG: Optional[SLOWatchdog] = None
_watchdog_lock = threading.Lock()


def get_watchdog() -> SLOWatchdog:
    """Process-wide watchdog (lazy; objectives read from config at
    first touch)."""
    global _WATCHDOG
    wd = _WATCHDOG
    if wd is None:
        with _watchdog_lock:
            wd = _WATCHDOG
            if wd is None:
                wd = _WATCHDOG = SLOWatchdog()
    return wd


def reset() -> None:
    """Stop and drop the singleton (tests)."""
    global _WATCHDOG
    with _watchdog_lock:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
        _WATCHDOG = None
