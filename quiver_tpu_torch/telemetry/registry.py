"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints, in order:

  * **hot-path cheap** — a counter ``inc`` is one lock acquire and one
    float add; a histogram ``observe`` adds one ``bisect``.  All metric
    handles are cached in the registry dict, so
    ``telemetry.counter("x").inc()`` in a per-batch loop costs a dict
    lookup + the increment (sub-µs against ms-scale batches).
  * **mergeable** — ``snapshot()`` returns a plain-JSON dict and
    ``merge()`` folds one into a registry, so dist workers / threads /
    subprocesses can aggregate by shipping snapshots (histograms merge
    exactly because buckets are fixed at creation; merge is associative
    and commutative).
  * **fixed buckets** — quantiles are read from bucket counts by linear
    interpolation, never from stored samples, so memory is O(buckets)
    no matter how many observations stream through (the serving p50/p99
    lists this replaces grew without bound).

Key encoding: a metric instance is addressed by ``name`` plus sorted
``labels``, flattened to the canonical string ``name{k=v,k2=v2}`` used
both as the registry key and in snapshots.  Label values must not
contain ``,``, ``=``, or ``}`` (enforced at creation).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_TIME_BUCKETS", "metric_key", "parse_metric_key",
    "snapshot_delta", "summarize_snapshot",
]

# ~exponential grid, 10 buckets per decade (step ~1.26x => worst-case
# quantile interpolation error ~13% of the value) spanning 10µs .. 50s —
# wide enough for a noop'd counter tick and a cold kernel build alike.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = tuple(
    round(1e-5 * 10 ** (i / 10.0), 12) for i in range(67)
)

_FORBIDDEN = set(",={}\"\n")


def metric_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical flat key: ``name`` or ``name{k=v,...}`` (sorted by k)."""
    if not labels:
        return name
    for k in labels:
        v = str(labels[k])
        if _FORBIDDEN & set(v) or _FORBIDDEN & set(str(k)):
            raise ValueError(
                f"label {k}={v!r} contains a reserved character ,=}}\"")
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`metric_key` (used by the exporters)."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key[:-1].partition("{")
    labels: Dict[str, str] = {}
    for part in inner.split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """Monotonically increasing float. ``inc(n)`` / ``.value``."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str = "", lock: Optional[threading.Lock] = None):
        self.key = key
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key or '<anon>'}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-writer-wins float. ``set`` / ``inc`` / ``dec`` / ``.value``."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str = "", lock: Optional[threading.Lock] = None):
        self.key = key
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram; bucket ``i`` counts values ``<= bounds[i]``
    (strictly above ``bounds[i-1]``), with one implicit +inf overflow
    bucket.  Two histograms with identical bounds merge exactly by
    adding counts, which makes cross-worker aggregation associative."""

    __slots__ = ("key", "bounds", "counts", "sum", "min", "max", "_lock")

    def __init__(self, key: str = "",
                 bounds: Optional[Sequence[float]] = None,
                 lock: Optional[threading.Lock] = None):
        b = tuple(float(x) for x in (bounds or DEFAULT_TIME_BUCKETS))
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram {key or '<anon>'}: bounds must be "
                             "strictly increasing")
        self.key = key
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = lock or threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def time(self) -> "_HistTimer":
        """``with h.time(): ...`` observes the block's wall seconds."""
        return _HistTimer(self)

    @property
    def count(self) -> int:
        return sum(self.counts)

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the covering bucket, clamped to the
        observed min/max so small samples don't report a bucket edge
        far from any real observation."""
        with self._lock:
            counts = list(self.counts)
            lo_obs, hi_obs = self.min, self.max
        total = sum(counts)
        if not total:
            return 0.0
        # A histogram populated purely via merge_dict may lack observed
        # min/max (older snapshots, or deltas that dropped them): the
        # sentinels are +/-inf and would leak straight through the clamp
        # below.  Fall back to the finite bucket grid — values at or
        # beyond the last bound report the last finite bound, never inf.
        if not math.isfinite(hi_obs):
            hi_obs = self.bounds[-1]
        if not math.isfinite(lo_obs):
            lo_obs = self.bounds[0]
        target = max(q, 0.0) / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else min(lo_obs, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (target - cum) / c
                v = lo + (hi - lo) * max(min(frac, 1.0), 0.0)
                return max(min(v, hi_obs), lo_obs)
            cum += c
        return hi_obs

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self.counts),
                "sum": self.sum,
                "min": None if self.min == float("inf") else self.min,
                "max": None if self.max == float("-inf") else self.max,
            }

    def merge_dict(self, d: dict) -> None:
        if tuple(float(x) for x in d["bounds"]) != self.bounds:
            raise ValueError(
                f"histogram {self.key or '<anon>'}: cannot merge across "
                "different bucket bounds")
        with self._lock:
            for i, c in enumerate(d["counts"]):
                self.counts[i] += c
            self.sum += d["sum"]
            if d.get("min") is not None and d["min"] < self.min:
                self.min = d["min"]
            if d.get("max") is not None and d["max"] > self.max:
                self.max = d["max"]


class _HistTimer:
    """Re-usable-per-call timing context for :meth:`Histogram.time`."""

    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Thread-safe name+labels -> metric store with snapshot/merge.

    Lock discipline: the registry map is written from any thread
    that first touches a metric name; all mutations hold ``_lock`` (the
    unlocked ``.get()`` in ``_get`` is the double-checked fast path).
    """

    _guarded_by = {"_metrics": "_lock", "_help": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        # metric *family* name -> help text (one line per family in the
        # Prometheus exposition, regardless of label instances).
        self._help: Dict[str, str] = {}

    # -- handle accessors -------------------------------------------------
    def _get(self, cls, name: str, labels: dict, help: Optional[str] = None,
             **kw):
        key = metric_key(name, labels)
        m = self._metrics.get(key)
        if m is None or (help is not None and name not in self._help):
            with self._lock:
                if help is not None:
                    self._help.setdefault(name, str(help))
                m = self._metrics.get(key)
                if m is None:
                    m = cls(key, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {key!r} already registered as "
                            f"{type(m).__name__}, requested "
                            f"{cls.__name__}")
        return m

    def counter(self, name: str, help: Optional[str] = None,
                **labels) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, help: Optional[str] = None,
              **labels) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  help: Optional[str] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, help=help, bounds=bounds)

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        with self._lock:
            items = list(self._metrics.items())
        return iter(sorted(items))

    # -- snapshot / merge -------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON view: ``{"counters": {key: v}, "gauges": {key: v},
        "histograms": {key: {bounds, counts, sum, min, max}}}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in self:
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][key] = m.to_dict()
        with self._lock:
            if self._help:
                # Only when non-empty: snapshots without help text keep
                # their historical exact shape (and snapshot_delta
                # equality against {} still holds).
                out["help"] = dict(self._help)
        return out

    def merge(self, snap: dict) -> None:
        """Fold a snapshot in: counters/histograms add, gauges overwrite."""
        for key, v in snap.get("counters", {}).items():
            name, labels = parse_metric_key(key)
            self.counter(name, **labels).inc(v)
        for key, v in snap.get("gauges", {}).items():
            name, labels = parse_metric_key(key)
            self.gauge(name, **labels).set(v)
        for key, d in snap.get("histograms", {}).items():
            name, labels = parse_metric_key(key)
            self.histogram(name, bounds=d["bounds"], **labels).merge_dict(d)
        h = snap.get("help")
        if h:
            with self._lock:
                for name, text in h.items():
                    self._help.setdefault(name, text)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._help.clear()


def snapshot_delta(before: dict, after: dict) -> dict:
    """``after - before`` for the additive parts (counters, histogram
    counts/sum); gauges pass through from ``after``.  Entries whose delta
    is zero are dropped, so a section that touched nothing contributes
    nothing.  Used to attribute registry activity to one section of a
    run (and by the SLO watchdog, per window)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    cb = before.get("counters", {})
    for key, v in after.get("counters", {}).items():
        d = v - cb.get(key, 0.0)
        if d:
            out["counters"][key] = d
    out["gauges"] = dict(after.get("gauges", {}))
    hb = before.get("histograms", {})
    for key, d in after.get("histograms", {}).items():
        prev = hb.get(key)
        if prev is None or tuple(prev["bounds"]) != tuple(d["bounds"]):
            delta = dict(d)
        else:
            counts = [a - b for a, b in zip(d["counts"], prev["counts"])]
            if not any(counts):
                continue
            delta = {"bounds": d["bounds"], "counts": counts,
                     "sum": d["sum"] - prev["sum"],
                     "min": d.get("min"), "max": d.get("max")}
        if any(delta["counts"]):
            out["histograms"][key] = delta
    if not out["gauges"]:
        del out["gauges"]
    if not out["counters"]:
        del out["counters"]
    if not out["histograms"]:
        del out["histograms"]
    return out


def _quantile_from_dict(d: dict, q: float) -> float:
    h = Histogram(bounds=d["bounds"])
    h.merge_dict(d)
    return h.percentile(q)


def summarize_snapshot(snap: dict) -> dict:
    """Compact a snapshot for JSON artifacts: histograms collapse to
    ``{count, mean, p50, p99, max}`` (seconds for ``*_seconds`` metrics)
    instead of 60+ bucket counts.  Lossy — for merging keep the full
    snapshot."""
    out: dict = {}
    if snap.get("counters"):
        out["counters"] = {k: round(v, 6)
                           for k, v in snap["counters"].items()}
    if snap.get("gauges"):
        out["gauges"] = {k: round(v, 6) for k, v in snap["gauges"].items()}
    if snap.get("histograms"):
        hs = {}
        for key, d in snap["histograms"].items():
            n = sum(d["counts"])
            hs[key] = {
                "count": n,
                "mean": round(d["sum"] / n, 9) if n else 0.0,
                "p50": round(_quantile_from_dict(d, 50), 9),
                "p99": round(_quantile_from_dict(d, 99), 9),
                "max": d.get("max"),
            }
        out["histograms"] = hs
    return out
