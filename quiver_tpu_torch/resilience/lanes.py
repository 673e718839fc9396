"""BoundedLane — a shedding, priority-aware stage queue.

Drop-in for the ``queue.Queue`` subset the serving pipeline uses
(``put`` / ``get`` / ``get_nowait`` / ``qsize`` / ``empty``), plus
admission control:

  * **capacity** — the lane never holds more than ``maxsize`` requests;
    at capacity the lowest-priority request loses (the arrival, unless
    a strictly lower-priority request is queued to displace).
  * **watermarks with hysteresis** — crossing ``high`` (a fraction of
    capacity) engages shedding mode, which persists until depth drains
    below ``low``; while engaged, arrivals are shed unless they can
    displace lower-priority queued work.  Shedding *early* keeps the
    queue-wait of admitted requests bounded instead of letting every
    request age toward its deadline.
  * **deadline laziness** — an expired request found at ``get`` time is
    shed on the spot (reason ``deadline``) rather than handed to a lane
    that would do dead work.

Sheds go through :func:`quiver_tpu_torch.resilience.deadline.shed`: metric,
flight record, typed answer on ``result_queue``.  Without a result
queue the lane admits-or-forwards but never silently drops — control
items (the ``_STOP`` sentinel and anything that is not a request) are
always admitted and never shed.

:class:`WeightedFairLane` keeps all of the above (capacity, watermark
hysteresis, priority-ordered victims, lazy deadline sheds) but replaces
the single FIFO with **deficit-weighted round-robin across per-tenant
sub-queues**: each tenant class owns a deque, classes take turns, and a
class may dequeue while its deficit counter covers the head request's
cost (``len(ids)``), refilled by ``quantum * weight`` per round — so a
burst in one tenant delays only that tenant's queue, never another's
admitted requests.  Control items still bypass admission and are served
in global arrival order (a checkpoint barrier must run after every
update enqueued before it — fairness must not reorder control flow).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .deadline import shed

__all__ = ["BoundedLane", "WeightedFairLane"]


def _req_of(item):
    """The ServingRequest inside ``item`` (requests travel bare on the
    batcher lanes and as ``(req, batch, dt)`` on the sampled lane)."""
    if isinstance(item, tuple) and item:
        item = item[0]
    return item if hasattr(item, "t_enqueue") else None


class BoundedLane:
    """Bounded, watermark-shedding queue for one pipeline lane."""

    # _shedding is rebound under the condition; the storage internals
    # are mutated through the _push/_pop hooks below, whose callers
    # hold _cv
    _guarded_by = {"_shedding": "_cv"}

    def __init__(self, name: str, maxsize: Optional[int] = None,
                 high: Optional[float] = None, low: Optional[float] = None,
                 result_queue=None):
        from ..config import get_config

        cfg = get_config()
        self.name = name
        self.maxsize = int(maxsize if maxsize is not None
                           else cfg.serving_queue_depth)
        if self.maxsize <= 0:
            raise ValueError(f"BoundedLane needs maxsize >= 1, got "
                             f"{self.maxsize}")
        high = float(high if high is not None
                     else cfg.serving_queue_high_watermark)
        low = float(low if low is not None
                    else cfg.serving_queue_low_watermark)
        if not 0.0 < low <= high <= 1.0:
            raise ValueError(f"watermarks need 0 < low <= high <= 1, got "
                             f"low={low} high={high}")
        self.high = max(int(self.maxsize * high), 1)
        self.low = max(int(self.maxsize * low), 0)
        self.result_queue = result_queue
        self._cv = threading.Condition()
        self._items: List[object] = []
        self._shedding = False

    # -- storage hooks (WeightedFairLane overrides these; callers hold
    # ``_cv``).  The base lane is one FIFO list: control items and
    # requests interleave in arrival order.
    def _push(self, item) -> None:
        self._items.append(item)

    def _push_control(self, item) -> None:
        self._items.append(item)

    def _pop(self):
        return self._items.pop(0)

    def _depth(self) -> int:
        return len(self._items)

    def _has_items(self) -> bool:
        return bool(self._items)

    def _take_victim(self, incoming):
        """Remove and return the oldest queued request with priority
        strictly below ``incoming``'s, or None (the incoming request is
        the victim)."""
        inc_pri = getattr(incoming, "priority", 0)
        best_i, best_pri = None, inc_pri
        for i, it in enumerate(self._items):
            r = _req_of(it)
            if r is None:
                continue
            pri = getattr(r, "priority", 0)
            if pri < best_pri:
                best_i, best_pri = i, pri
        if best_i is None:
            return None
        return self._items.pop(best_i)

    # -- producer side --------------------------------------------------
    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        """Admit, displace, or shed.  Control items always enqueue.
        ``block``/``timeout`` are accepted for queue.Queue compatibility
        but never block: at capacity this lane sheds instead."""
        req = _req_of(item)
        with self._cv:
            if req is None:  # control item (_STOP): always through
                self._push_control(item)
                self._cv.notify()
                return
            depth = self._depth()
            if self._shedding and depth < self.low:
                self._shedding = False
            if depth >= self.high:
                self._shedding = True
            if not self._shedding and depth < self.maxsize:
                self._push(item)
                self._cv.notify()
                return
            # shedding mode (or hard-full): lowest priority loses
            reason = "overflow" if depth >= self.maxsize else "watermark"
            victim_item = self._take_victim(req)
            if victim_item is None:
                victim_item = item  # arrival is the lowest priority
            else:
                self._push(item)
                self._cv.notify()
        victim = _req_of(victim_item)
        if self.result_queue is None:
            # nobody to answer: a shed here would be a silent drop, so
            # admit past the watermark instead (degenerates to the old
            # unbounded queue.Queue behaviour — wire a result_queue to
            # get admission control)
            with self._cv:
                self._push(victim_item)
                self._cv.notify()
            return
        shed(victim, self.result_queue, self.name, reason)

    # -- consumer side --------------------------------------------------
    def get(self, block: bool = True, timeout: Optional[float] = None):
        """Pop the oldest item; expired requests are shed here (when
        answerable) instead of being handed to the lane."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cv:
            while True:
                while not self._has_items():
                    if not block:
                        raise _queue.Empty
                    if deadline is None:
                        self._cv.wait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0 or not self._cv.wait(left):
                            if not self._has_items():
                                raise _queue.Empty
                    continue
                item = self._pop()
                if self._depth() < self.low:
                    self._shedding = False
                req = _req_of(item)
                if (req is not None and self.result_queue is not None
                        and req.deadline is not None
                        and time.perf_counter() >= req.deadline):
                    shed(req, self.result_queue, self.name, "deadline")
                    continue
                return item

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        with self._cv:
            return self._depth()

    def empty(self) -> bool:
        return self.qsize() == 0

    @property
    def shedding(self) -> bool:
        with self._cv:
            return self._shedding


class WeightedFairLane(BoundedLane):
    """Deficit-weighted round-robin lane over per-tenant sub-queues.

    ``weights`` maps tenant-class name → scheduling weight (from
    :meth:`~quiver_tpu_torch.resilience.qos.QoSController.weights`); requests
    are classed by their ``tenant_class`` stamp (set by QoS admission),
    unstamped requests landing in ``default_class``.  ``quantum`` is
    the per-round deficit refill in request-cost units (a request costs
    ``max(len(ids), 1)``) per unit weight.

    DRR (Shreedhar & Varghese): each non-empty class takes a turn; on
    its turn it dequeues head requests while its deficit covers their
    cost, then the residual deficit carries to its next turn.  An empty
    class forfeits its deficit (no banking idle capacity).  Work
    complexity is O(1) amortized per dequeue — one rotation step per
    refill.

    Victim selection for watermark/overflow sheds scans every sub-queue
    for the globally lowest-priority, oldest request, so shedding lands
    on the lowest tenant class first no matter which class's burst
    crossed the watermark.

    Control items never shed AND never reorder: they are served only
    once every request that arrived before them has left the lane, so a
    checkpoint barrier still partitions an update stream exactly.
    """

    # all mutable state lives behind the inherited _push/_pop hooks,
    # whose callers hold _cv

    def __init__(self, name: str, weights: Dict[str, float],
                 default_class: Optional[str] = None,
                 quantum: Optional[int] = None, **kwargs):
        super().__init__(name, **kwargs)
        from ..config import get_config

        if not weights:
            raise ValueError("WeightedFairLane needs at least one class")
        self.weights = {k: max(float(v), 1e-3) for k, v in weights.items()}
        self.default_class = (default_class if default_class is not None
                              else next(iter(self.weights)))
        if self.default_class not in self.weights:
            self.weights[self.default_class] = 1.0
        self.quantum = int(quantum if quantum is not None
                           else get_config().qos_quantum)
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        # per-class deques hold (arrival_seq, item); _active is the DRR
        # rotation of class names with queued work
        self._subq: Dict[str, deque] = {}
        self._ctrl: deque = deque()
        self._active: deque = deque()
        self._deficit: Dict[str, float] = {}
        self._n = 0
        self._seq = 0

    # -- classing ------------------------------------------------------
    def _class_of(self, item) -> str:
        req = _req_of(item)
        cls = getattr(req, "tenant_class", None) if req is not None else None
        return cls if cls in self.weights else self.default_class

    @staticmethod
    def _cost_of(item) -> float:
        req = _req_of(item)
        ids = getattr(req, "ids", None) if req is not None else None
        try:
            return float(max(len(ids), 1)) if ids is not None else 1.0
        except TypeError:
            return 1.0

    # -- storage hooks (caller holds ``_cv``) --------------------------
    def _push(self, item) -> None:
        cls = self._class_of(item)
        q = self._subq.get(cls)
        if q is None:
            q = self._subq[cls] = deque()
        if not q:
            self._active.append(cls)
            self._deficit[cls] = 0.0
        self._seq += 1
        q.append((self._seq, item))
        self._n += 1

    def _push_control(self, item) -> None:
        self._seq += 1
        self._ctrl.append((self._seq, item))

    def _depth(self) -> int:
        return self._n

    def _has_items(self) -> bool:
        return self._n > 0 or bool(self._ctrl)

    def _oldest_req_seq(self) -> float:
        return min((q[0][0] for q in self._subq.values() if q),
                   default=float("inf"))

    def _pop(self):
        # control items: arrival-order fence — serve one only when no
        # earlier-arrived request is still queued
        if self._ctrl and self._ctrl[0][0] < self._oldest_req_seq():
            return self._ctrl.popleft()[1]
        # DRR scan: terminates because every full rotation refills each
        # active class by quantum*weight > 0 while costs are bounded by
        # the top serving bucket
        while True:
            cls = self._active[0]
            q = self._subq.get(cls)
            if not q:
                self._active.popleft()
                self._deficit.pop(cls, None)
                continue
            cost = self._cost_of(q[0][1])
            if self._deficit[cls] >= cost:
                self._deficit[cls] -= cost
                item = q.popleft()[1]
                self._n -= 1
                if not q:
                    self._active.popleft()
                    self._deficit.pop(cls, None)
                return item
            self._deficit[cls] += self.quantum * self.weights.get(
                cls, self.weights[self.default_class])
            self._active.rotate(-1)

    def _take_victim(self, incoming):
        inc_pri = getattr(incoming, "priority", 0)
        best, best_key = None, (float("inf"), float("inf"))
        for cls, q in self._subq.items():
            for i, (seq, it) in enumerate(q):
                r = _req_of(it)
                if r is None:
                    continue
                pri = getattr(r, "priority", 0)
                if pri >= inc_pri:  # only strictly-lower priority loses
                    continue
                key = (pri, seq)
                if key < best_key:
                    best, best_key = (cls, i), key
        if best is None:
            return None
        cls, i = best
        q = self._subq[cls]
        _, item = q[i]
        del q[i]
        self._n -= 1
        if not q and cls in self._deficit:
            self._active.remove(cls)
            self._deficit.pop(cls, None)
        return item

    # -- read side -----------------------------------------------------
    def class_depths(self) -> Dict[str, int]:
        """Per-class queued counts (for /debug/qos and tests)."""
        with self._cv:
            return {cls: len(q) for cls, q in self._subq.items() if q}
