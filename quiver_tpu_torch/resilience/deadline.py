"""Per-request deadlines and the shared shed path.

A deadline is an **absolute** ``time.perf_counter`` value computed at
enqueue (``t_enqueue + config.serving_deadline_ms / 1e3``), carried on
the :class:`~quiver_tpu_torch.serving.ServingRequest`, and checked at every
stage boundary — batcher route, lane admission, sampler dequeue, server
dequeue, and per coalesced member.  A check is two floats and a compare;
with ``serving_deadline_ms = 0`` (the default) the deadline is ``None``
and every check short-circuits on one ``is None``.

Shedding is centralized in :func:`shed` so every path produces the same
artifacts: ``serving_shed_total{reason, lane}``, a ``shed`` event plus a
retained flight record (status ``shed``), and a typed answer on the
result queue — :class:`~.errors.DeadlineExceeded` for ``reason ==
"deadline"``, :class:`~.errors.LoadShed` otherwise.  A request that
cannot be answered (no result queue in scope) is never shed here; it
flows downstream to a stage that can answer it.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional, Tuple

from .. import telemetry
from ..telemetry import flightrec
from .errors import DeadlineExceeded, LoadShed

__all__ = ["deadline_for", "shed", "shed_if_expired",
           "deadline_scope", "ambient_deadline", "check_ambient"]

# -- ambient deadline (contextvar) ---------------------------------------
# Serving loops install the in-flight batch's tightest deadline here so
# code they call into WITHOUT a request in hand can still refuse dead
# work.  Holds ``(deadline, t_start)`` or None; with deadlines disabled
# nothing is ever installed and ``check_ambient`` is one contextvar read.
_AMBIENT: "contextvars.ContextVar[Optional[Tuple[float, float]]]" = \
    contextvars.ContextVar("quiver_ambient_deadline", default=None)


class deadline_scope:
    """``with deadline_scope(deadline, t_start):`` — make a deadline
    ambient for the block.  ``deadline=None`` is a no-op scope, so call
    sites need no branch."""

    __slots__ = ("_deadline", "_t_start", "_token")

    def __init__(self, deadline: Optional[float],
                 t_start: Optional[float] = None):
        self._deadline = deadline
        self._t_start = t_start
        self._token = None

    def __enter__(self):
        if self._deadline is not None:
            t0 = self._t_start if self._t_start is not None \
                else time.perf_counter()
            self._token = _AMBIENT.set((self._deadline, t0))
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _AMBIENT.reset(self._token)
        return False


def ambient_deadline() -> Optional[float]:
    """The ambient absolute deadline, or None."""
    scope = _AMBIENT.get()
    return scope[0] if scope is not None else None


def check_ambient(lane: str) -> None:
    """Raise :class:`DeadlineExceeded` iff the ambient deadline has
    passed — the callee-side twin of :func:`shed_if_expired` for code
    paths that hold no request object.  One
    contextvar read when no scope is installed."""
    scope = _AMBIENT.get()
    if scope is None:
        return
    deadline, t0 = scope
    now = time.perf_counter()
    if now < deadline:
        return
    raise DeadlineExceeded((now - t0) * 1e3, (deadline - t0) * 1e3,
                           lane=lane)


def deadline_for(t_enqueue: float,
                 deadline_ms: Optional[float] = None) -> Optional[float]:
    """Absolute deadline for a request enqueued at ``t_enqueue``
    (perf_counter seconds), or None when deadlines are disabled."""
    if deadline_ms is None:
        from ..config import get_config

        deadline_ms = get_config().serving_deadline_ms
    if not deadline_ms or deadline_ms <= 0:
        return None
    return t_enqueue + float(deadline_ms) / 1e3


def shed(req, result_queue, lane: str, reason: str) -> None:
    """Shed ``req`` unconditionally: tick the metric, retain the flight
    record, answer on ``result_queue`` (when one is in scope).

    The ``tenant`` label appears only on requests that passed QoS
    admission (which stamps the resolved class — an allowlisted name,
    so cardinality stays bounded); without QoS the metric keys are
    byte-identical to the pre-QoS ones."""
    now = time.perf_counter()
    tenant = getattr(req, "tenant_class", None)
    if tenant is not None:
        telemetry.counter("serving_shed_total", reason=reason, lane=lane,
                          tenant=tenant).inc()
    else:
        telemetry.counter("serving_shed_total", reason=reason,
                          lane=lane).inc()
    elapsed = max(now - req.t_enqueue, 0.0)
    if reason == "deadline":
        budget_s = (req.deadline - req.t_enqueue
                    if req.deadline is not None else 0.0)
        exc: Exception = DeadlineExceeded(elapsed * 1e3, budget_s * 1e3,
                                          lane=lane)
    else:
        exc = LoadShed(reason, lane=lane)
    tr = getattr(req, "trace", None)
    if tr is not None:
        tr.add("shed", {"reason": reason, "lane": lane})
        flightrec.get_recorder().finish(tr, elapsed, status="shed",
                                        lane=lane)
    if result_queue is not None:
        result_queue.put((req, exc))


def shed_if_expired(req, result_queue, lane: str) -> bool:
    """Shed ``req`` iff its deadline has passed AND it can be answered.

    Returns True when the caller must drop the request.  Without a
    result queue the request is forwarded instead — a shed that nobody
    hears is just a lost request.
    """
    dl = getattr(req, "deadline", None)
    if dl is None or result_queue is None:
        return False
    if time.perf_counter() < dl:
        return False
    shed(req, result_queue, lane, "deadline")
    return True
