"""Joining worker threads with one deadline (copy of
``quiver_tpu/resilience/shutdown.py::join_and_reap``, logging only: the
port has no metrics registry)."""

from __future__ import annotations

import logging
import time
from typing import List, Sequence

__all__ = ["join_and_reap"]

_log = logging.getLogger("quiver_tpu_torch")


def join_and_reap(threads: Sequence, timeout: float,
                  component: str) -> List:
    """Join every thread within one shared ``timeout`` (a total budget, not
    per thread); log and return the threads still alive."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    leaked = [t for t in threads if t.is_alive()]
    for t in leaked:
        _log.warning("thread %r leaked at %s shutdown (join timed out "
                     "after %.1fs total)", t.name, component, timeout)
    return leaked
