"""Per-lane circuit breakers (closed → open → half-open).

A lane that keeps failing should stop receiving traffic *before* every
queued request burns its deadline discovering the same fault.  The
breaker counts consecutive failures; at ``failure_threshold`` it opens
and :meth:`CircuitBreaker.allow` answers False (the server reroutes to
the failover lane instead).  After ``reset_timeout_s`` the next
``allow()`` transitions to half-open and admits ``half_open_probes``
probe requests: one success closes the breaker, one failure re-opens
it and restarts the timeout.

Half-open is gated to a **single in-flight probe**: the first ``allow``
after the timeout wins the probe slot; every concurrent caller sees the
breaker as still open until that probe resolves (``record_success`` /
``record_failure``, or ``release_probe`` when the pass met a fault
that is not the lane's).  Admitting every concurrent caller as a probe —
the original behaviour — stampedes a barely-recovered lane with the
exact burst that tripped it.  Consecutive probe failures also back off
the reset timeout exponentially (:class:`~.retry.Backoff`, capped at
8x), so a hard-down lane is probed ever more gently.

State is exported two ways: the gauge ``serving_breaker_state{lane}``
(0 closed, 1 half-open, 2 open) plus
``serving_breaker_transitions_total{lane, to}`` in the registry, and
``GET /debug/breakers`` serving :func:`breakers_status` over the
process-wide registry of live breakers.

The clock is injectable (``clock=time.monotonic``) so tests drive the
open → half-open timeout deterministically instead of sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .. import telemetry
from ..telemetry import flightrec

__all__ = ["CircuitBreaker", "get_breaker", "breakers_status", "reset"]

_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """One lane's failure-driven admission switch.

    Thread-safe: ``allow`` / ``record_*`` are called from every lane
    thread.  Construction registers the breaker under ``name`` in the
    process-wide registry (latest wins — a restarted server's breakers
    replace its predecessor's on the debug endpoint).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    _guarded_by = {"_failures": "_lock", "_state": "_lock",
                   "_opened_at": "_lock", "_probes": "_lock",
                   "_probe_inflight": "_lock", "_reopens": "_lock"}

    def __init__(self, name: str, failure_threshold: Optional[int] = None,
                 reset_timeout_s: Optional[float] = None,
                 half_open_probes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..config import get_config

        cfg = get_config()
        self.name = name
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else cfg.serving_breaker_failures)
        self.reset_timeout_s = float(
            reset_timeout_s if reset_timeout_s is not None
            else cfg.serving_breaker_reset_s)
        self.half_open_probes = int(
            half_open_probes if half_open_probes is not None
            else cfg.serving_breaker_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        self._probe_inflight = False
        self._reopens = 0  # consecutive failed probes: backs off the timeout
        from .retry import Backoff

        # deterministic (jitter=0) so scripted-clock tests stay exact;
        # delay(0) == reset_timeout_s, doubling per consecutive reopen
        self._reopen_backoff = Backoff(self.reset_timeout_s,
                                       cap_s=self.reset_timeout_s * 8)
        telemetry.gauge("serving_breaker_state", lane=name).set(0)
        _register(self)

    def _current_timeout_s(self) -> float:
        """Caller holds ``_lock``: the open→half-open delay.  The first
        failed probe re-opens at the base timeout; each further
        consecutive failure doubles it (capped), so a hard-down lane is
        probed ever more gently."""
        return self._reopen_backoff.delay(max(self._reopens - 1, 0))

    # -- decisions ------------------------------------------------------
    def allow(self) -> bool:
        """May the caller send one request down this lane right now?"""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < \
                        self._current_timeout_s():
                    return False
                self._transition(self.HALF_OPEN)
                self._probes = 0
                self._probe_inflight = False
            # half-open: exactly ONE probe in flight; sequential probes
            # up to half_open_probes, concurrent callers see open
            if (not self._probe_inflight
                    and self._probes < self.half_open_probes):
                self._probes += 1
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._reopens = 0
            if self._state == self.HALF_OPEN:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                # the probe failed: back to open, restart the (now
                # backed-off) timeout
                self._probe_inflight = False
                self._reopens += 1
                self._opened_at = self._clock()
                self._transition(self.OPEN)
                return
            self._failures += 1
            if (self._state == self.CLOSED
                    and self._failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(self.OPEN)

    def release_probe(self) -> None:
        """Hand back the probe slot of a pass that ended in a fault of the
        program (a kernel fault), not of the lane: neither a success nor
        a failure is counted, and the next ``allow`` may probe again.
        A no-op unless a half-open probe is in flight."""
        with self._lock:
            if self._state == self.HALF_OPEN and self._probe_inflight:
                self._probe_inflight = False
                self._probes -= 1

    def _transition(self, to: str) -> None:
        """Caller holds ``_lock``.  Metrics + flight-recorder breadcrumb
        (the event lands on whatever request's trace is active — the one
        whose failure tripped the breaker)."""
        # every caller (allow /
        # record_success / record_failure) holds _lock; the guard is
        # real, just not lexical in this helper
        self._state = to
        telemetry.gauge("serving_breaker_state",
                        lane=self.name).set(_STATE_VALUES[to])
        telemetry.counter("serving_breaker_transitions_total",
                          lane=self.name, to=to).inc()
        if flightrec.tracing():
            flightrec.event("breaker", {"lane": self.name, "to": to})

    # -- read side ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self) -> dict:
        with self._lock:
            st = {
                "lane": self.name,
                "state": self._state,
                "failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "half_open_probes": self.half_open_probes,
            }
            if self._state != self.CLOSED:
                st["open_age_s"] = round(
                    max(self._clock() - self._opened_at, 0.0), 3)
                st["effective_reset_timeout_s"] = round(
                    self._current_timeout_s(), 3)
            if self._state == self.HALF_OPEN:
                st["probe_inflight"] = self._probe_inflight
        return st


# -- process-wide registry (feeds GET /debug/breakers) ------------------
_BREAKERS: Dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def _register(br: CircuitBreaker) -> None:
    with _registry_lock:
        _BREAKERS[br.name] = br


def get_breaker(name: str, **kwargs) -> CircuitBreaker:
    """The registered breaker for ``name``, created on first touch
    (``kwargs`` apply only then)."""
    with _registry_lock:
        br = _BREAKERS.get(name)
    if br is None:
        br = CircuitBreaker(name, **kwargs)  # __init__ registers
    return br


def breakers_status() -> dict:
    """JSON view for ``GET /debug/breakers``."""
    with _registry_lock:
        brs = sorted(_BREAKERS.values(), key=lambda b: b.name)
    return {"breakers": [b.status() for b in brs]}


def reset() -> None:
    """Drop every registered breaker (tests)."""
    with _registry_lock:
        _BREAKERS.clear()
