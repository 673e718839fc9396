"""Fixed-bucket histogram and counter (copy of the pure-Python parts of
``quiver_tpu/telemetry/registry.py`` that the serving slice reads).

Quantiles are read from bucket counts by linear interpolation, so memory
is O(buckets) however many observations stream through.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Optional, Sequence, Tuple

__all__ = ["Counter", "Histogram", "DEFAULT_TIME_BUCKETS"]

# ~exponential grid, 10 buckets per decade (step ~1.26x, so a quantile is
# off by at most ~13% of its value) spanning 10 us .. 50 s
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = tuple(
    round(1e-5 * 10 ** (i / 10.0), 12) for i in range(67)
)


class Counter:
    """Monotonically increasing float. ``inc(n)`` / ``.value``."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str = ""):
        self.key = key
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.key or '<anon>'}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram; bucket ``i`` counts values ``<= bounds[i]``
    (strictly above ``bounds[i-1]``), plus one +inf overflow bucket."""

    __slots__ = ("key", "bounds", "counts", "sum", "min", "max", "_lock")

    def __init__(self, key: str = "",
                 bounds: Optional[Sequence[float]] = None):
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
        self._lock = threading.Lock()

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

    @property
    def count(self) -> int:
        return sum(self.counts)

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the covering bucket, clamped to the observed
        min/max."""
        with self._lock:
            counts = list(self.counts)
            lo_obs, hi_obs = self.min, self.max
        total = sum(counts)
        if not total:
            return 0.0
        if not math.isfinite(hi_obs):
            hi_obs = self.bounds[-1]
        if not math.isfinite(lo_obs):
            lo_obs = self.bounds[0]
        target = max(q, 0.0) / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else min(lo_obs,
                                                          self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (target - cum) / c
                v = lo + (hi - lo) * max(min(frac, 1.0), 0.0)
                return max(min(v, hi_obs), lo_obs)
            cum += c
        return hi_obs
