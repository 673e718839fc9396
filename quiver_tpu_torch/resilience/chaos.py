"""Deterministic fault injection for the serving pipeline.

Pipeline stages declare **named injection points** once, at module
scope::

    _CHAOS_DEVICE = chaos.point("serving.device_lane")

and fire them on the hot path with a bare call — ``_CHAOS_DEVICE()``.
With no plan installed (production, and every non-chaos test) a fire is
one module-global read and a None check: no locks, no clocks, no
allocations.

A chaos test installs a seeded :class:`ChaosPlan`::

    plan = ChaosPlan(seed=7).fail("serving.device_lane", times=2)
    with chaos.active(plan):
        ...drive traffic...
    assert plan.log() == expected   # byte-identical on every replay

Determinism: a rule's probabilistic decisions hash ``(seed, point,
hit_index)`` — no wall clock, no global RNG — so the same plan over the
same request sequence takes the same decisions, raises the same faults,
and leaves identical shed / retry / degraded counters behind.  Every
fired action ticks ``chaos_injections_total{point}`` and lands in the
plan's replay log.
"""

from __future__ import annotations

import hashlib
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .errors import ChaosFault

__all__ = ["ChaosPlan", "InjectionPoint", "point", "install", "uninstall",
           "active", "current_plan"]


def _hash01(seed: int, name: str, idx: int) -> float:
    """Uniform [0, 1) from (seed, point, hit) — the only randomness
    source, so replays are exact."""
    h = hashlib.blake2b(f"{seed}:{name}:{idx}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


class _Rule:
    """One fault rule: fire on hits ``after <= idx`` matching ``every``
    / ``rate``, at most ``times`` times (None = unbounded)."""

    __slots__ = ("exc", "times", "after", "every", "rate", "delay_s",
                 "fired")

    def __init__(self, exc=None, times: Optional[int] = 1, after: int = 0,
                 every: Optional[int] = None, rate: Optional[float] = None,
                 delay_s: float = 0.0):
        self.exc = exc
        self.times = times
        self.after = int(after)
        self.every = every
        self.rate = rate
        self.delay_s = float(delay_s)
        self.fired = 0

    def matches(self, seed: int, name: str, idx: int) -> bool:
        if idx < self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.every is not None and (idx - self.after) % self.every:
            return False
        if self.rate is not None and _hash01(seed, name, idx) >= self.rate:
            return False
        return True


class ChaosPlan:
    """A seeded script of faults, keyed by injection-point name."""

    _guarded_by = {"_rules": "_lock", "_hits": "_lock", "_log": "_lock"}

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        self._hits: Dict[str, int] = {}
        self._log: List[Tuple[str, int, str]] = []

    def fail(self, point_name: str, exc=None, times: Optional[int] = 1,
             after: int = 0, every: Optional[int] = None,
             rate: Optional[float] = None) -> "ChaosPlan":
        """Raise at ``point_name``: hits ``after, after+1, ...`` matching
        ``every``/``rate``, at most ``times`` total (None = forever).
        ``exc`` may be an exception instance, a class, or None for the
        default :class:`ChaosFault`."""
        with self._lock:
            self._rules.setdefault(point_name, []).append(
                _Rule(exc=exc, times=times, after=after, every=every,
                      rate=rate))
        return self

    def delay(self, point_name: str, delay_s: float,
              times: Optional[int] = 1, after: int = 0,
              every: Optional[int] = None,
              rate: Optional[float] = None) -> "ChaosPlan":
        """Sleep ``delay_s`` at ``point_name`` (same selectors as
        :meth:`fail`) — models a stall rather than a crash."""
        with self._lock:
            self._rules.setdefault(point_name, []).append(
                _Rule(exc=None, times=times, after=after, every=every,
                      rate=rate, delay_s=delay_s))
        return self

    def fire(self, name: str) -> None:
        """One hit of point ``name``: take the scripted decision, log
        it, then act (sleep and/or raise) outside the lock."""
        delay_s = 0.0
        exc: Optional[BaseException] = None
        with self._lock:
            idx = self._hits.get(name, 0)
            self._hits[name] = idx + 1
            action = "pass"
            for rule in self._rules.get(name, ()):
                if not rule.matches(self.seed, name, idx):
                    continue
                rule.fired += 1
                if rule.delay_s:
                    delay_s += rule.delay_s
                    action = f"delay:{rule.delay_s:g}"
                if rule.exc is not None or rule.delay_s == 0.0:
                    e = rule.exc
                    if e is None:
                        e = ChaosFault(name, idx)
                    elif isinstance(e, type):
                        e = e()
                    exc = e
                    action = f"raise:{type(e).__name__}"
                break  # first matching rule wins, like iptables
            self._log.append((name, idx, action))
        if action != "pass":
            from .. import telemetry
            from ..telemetry import timeline

            telemetry.counter("chaos_injections_total", point=name).inc()
            if timeline._ON:
                timeline.emit("chaos.inject", cat="chaos",
                              attrs={"point": name, "hit": idx,
                                     "action": action})
        if delay_s:
            time.sleep(delay_s)
        if exc is not None:
            raise exc

    def log(self) -> List[Tuple[str, int, str]]:
        """The replay log: ``(point, hit_index, action)`` per hit, in
        firing order.  Identical across runs of the same plan over the
        same request sequence — the determinism contract chaos tests
        assert on."""
        with self._lock:
            return list(self._log)

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)


class InjectionPoint:
    """A named chaos call site.  Calling it is free when no plan is
    installed — the production steady state."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self) -> None:
        plan = _PLAN
        if plan is None:
            return
        plan.fire(self.name)

    def __repr__(self):
        return f"InjectionPoint({self.name!r})"


_PLAN: Optional[ChaosPlan] = None
_POINTS: Dict[str, InjectionPoint] = {}
_points_lock = threading.Lock()


def point(name: str) -> InjectionPoint:
    """The (cached) injection point for ``name`` — call once at module
    scope, fire the returned object on the hot path."""
    p = _POINTS.get(name)
    if p is None:
        with _points_lock:
            p = _POINTS.setdefault(name, InjectionPoint(name))
    return p


def install(plan: ChaosPlan) -> ChaosPlan:
    """Arm ``plan`` process-wide.  One plan at a time, by design: chaos
    scripts own the process while they run."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def current_plan() -> Optional[ChaosPlan]:
    return _PLAN


@contextmanager
def active(plan: ChaosPlan):
    """``with chaos.active(plan): ...`` — install for the block, always
    disarm on the way out (a leaked plan would fail every later test)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()
