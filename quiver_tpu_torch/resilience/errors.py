"""Typed failure results for the serving pipeline.

A request that cannot be served is *answered*, never dropped: the
result queue carries ``(request, exception)`` with one of these types,
so a client can tell "you were too late" (:class:`DeadlineExceeded`)
from "we were overloaded" (:class:`LoadShed`) from "the lane is down"
(:class:`LaneUnavailable`) — three different retry policies.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "ResilienceError", "DeadlineExceeded", "LoadShed", "LaneUnavailable",
    "ChaosFault", "QuotaExceeded", "PeerTimeout",
]


class ResilienceError(RuntimeError):
    """Base of every typed fault-tolerance result."""


class DeadlineExceeded(ResilienceError):
    """The request's deadline passed before a lane could finish it.

    Carries the elapsed and budgeted milliseconds so clients can tune
    ``SERVING_DEADLINE_MS`` from the answers alone.
    """

    def __init__(self, elapsed_ms: float, budget_ms: float,
                 lane: Optional[str] = None):
        self.elapsed_ms = float(elapsed_ms)
        self.budget_ms = float(budget_ms)
        self.lane = lane
        where = f" at lane {lane!r}" if lane else ""
        super().__init__(
            f"deadline exceeded{where}: {self.elapsed_ms:.1f} ms elapsed "
            f"against a {self.budget_ms:.1f} ms budget")


class LoadShed(ResilienceError):
    """The request was shed by admission control (queue over watermark
    or at capacity) — the system chose to fail it fast rather than let
    every queued request miss its deadline."""

    def __init__(self, reason: str, lane: Optional[str] = None):
        self.reason = reason
        self.lane = lane
        where = f" from lane {lane!r}" if lane else ""
        super().__init__(f"request shed{where} ({reason})")


class QuotaExceeded(ResilienceError):
    """The tenant's token bucket is empty — cooperative backpressure.

    Unlike :class:`LoadShed` (the *system* is overloaded, back off with
    jitter), this answer means *this tenant* exceeded its provisioned
    rate; ``retry_after_s`` is the earliest time a retry can be
    admitted, computed from the bucket's refill rate, so a well-behaved
    client can pace itself instead of hammering the admission gate.
    """

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"tenant {tenant!r} over quota; retry after "
            f"{self.retry_after_s:.3f} s")


class LaneUnavailable(ResilienceError):
    """The target lane's circuit breaker is open and no failover path
    exists for this request."""

    def __init__(self, lane: str):
        self.lane = lane
        super().__init__(f"lane {lane!r} unavailable (breaker open, "
                         f"no failover path)")


class PeerTimeout(ResilienceError):
    """A cross-shard exchange (the dist feature or sampler all-to-all)
    timed out waiting on a peer shard."""

    def __init__(self, what: str = "exchange"):
        super().__init__(f"peer shard timed out during {what}")


class ChaosFault(ResilienceError):
    """Default exception injected by :mod:`.chaos` — distinguishable
    from every organic failure so a chaos test can assert its faults
    (and only its faults) propagated."""

    def __init__(self, point: str, hit: int):
        self.point = point
        self.hit = hit
        super().__init__(f"injected fault at {point!r} (hit #{hit})")
