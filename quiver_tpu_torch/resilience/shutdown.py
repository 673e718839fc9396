"""Leak-aware thread shutdown.

``t.join(timeout=...)`` returning is not the same as ``t`` exiting —
a wedged worker sails right past the timeout and the old ``stop()``
paths pretended shutdown succeeded.  :func:`join_and_reap` joins a
batch of threads, reports the ones still alive, ticks
``serving_thread_leak_total{component}``, and logs each leaker with its
name so a hung stage shows up in both the registry and the logs instead
of as a mystery at interpreter exit.
"""

from __future__ import annotations

import logging
import time
from typing import List, Sequence

from .. import telemetry

__all__ = ["join_and_reap"]

_log = logging.getLogger("quiver_tpu_torch.resilience")


def join_and_reap(threads: Sequence, timeout: float,
                  component: str) -> List:
    """Join every thread with a shared deadline; return the leakers.

    The timeout is a total budget, not per-thread: ``n`` wedged threads
    cost one timeout, not ``n``.  Every thread still alive afterwards is
    logged and counted in ``serving_thread_leak_total{component}``.
    """
    deadline = time.monotonic() + timeout
    for t in threads:
        left = deadline - time.monotonic()
        t.join(timeout=max(left, 0.0))
    leaked = [t for t in threads if t.is_alive()]
    for t in leaked:
        telemetry.counter("serving_thread_leak_total",
                          component=component).inc()
        _log.warning("thread %r leaked at %s shutdown (join timed out "
                     "after %.1fs total)", t.name, component, timeout)
    return leaked
