"""Shared jittered-exponential-backoff policy.

Two retry loops grew independently — the dist sampler's one-shot
exchange retry and the circuit breaker's open→half-open probe delay —
each with its own hardcoded schedule.  :class:`Backoff` centralizes the
schedule; the call sites keep their own loop shapes (the sampler wants
"retry the collective N times", the breaker wants "how long until the
next probe is allowed").

``delay(attempt)`` is a pure function of ``(attempt, rng state)``:

    base_s * multiplier**attempt, capped at cap_s,
    then spread by ±jitter (a fraction of the delay)

With ``jitter=0`` the schedule is exactly deterministic — the breaker
uses that so scripted-clock tests stay exact.  With jitter, pass a
seeded ``random.Random`` for reproducible spreads (the unit tests pin
the sequence); the default RNG is a private instance so concurrent
callers never contend on (or perturb) the global ``random`` state.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["Backoff", "retry_call"]


class Backoff:
    """Exponential backoff schedule with bounded multiplicative jitter."""

    def __init__(self, base_s: float, cap_s: Optional[float] = None,
                 multiplier: float = 2.0, jitter: float = 0.0,
                 rng: Optional[random.Random] = None):
        if base_s < 0:
            raise ValueError(f"base_s must be >= 0, got {base_s}")
        if multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s) if cap_s is not None else self.base_s * 64
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()

    def delay(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (0-based).
        Monotone nondecreasing in ``attempt`` up to the cap; never above
        ``cap_s * (1 + jitter)``."""
        d = min(self.base_s * self.multiplier ** max(int(attempt), 0),
                self.cap_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)


def retry_call(fn: Callable, attempts: int = 2,
               backoff: Optional[Backoff] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[int, BaseException],
                                           None]] = None):
    """Call ``fn()`` up to ``attempts`` times, sleeping the backoff
    delay between tries.  Only ``retry_on`` exceptions retry; anything
    else — and the last ``retry_on`` failure — propagates.  ``on_retry``
    fires before each re-attempt (metrics hooks), ``sleep`` is
    injectable so tests assert the schedule without waiting it."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt + 1 >= attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff is not None:
                d = backoff.delay(attempt)
                if d > 0:
                    sleep(d)
