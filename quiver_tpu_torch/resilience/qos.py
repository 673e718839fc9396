"""Multi-tenant QoS: admission quotas, fair-share classes, and the
adaptive degradation ladder.

Three cooperating pieces:

  * **Tenant classes + token buckets** — operators declare classes in
    ``config.qos_tenants`` (``"gold:rate=200,burst=50,weight=8,
    priority=3;..."``); each class gets a token bucket (``rate``
    tokens/s refill, ``burst`` capacity).  :meth:`QoSController.admit`
    is the single admission gate: over-quota requests are answered with
    a typed :class:`~.errors.QuotaExceeded` carrying the earliest
    useful retry time — cooperative backpressure, not a silent drop.
    The class list doubles as the **tenant-label allowlist**: metrics
    only ever carry declared class names (unlabeled or unknown tenants
    map to ``qos_default_tenant``), so label cardinality is bounded by
    config, not by whatever clients send.
  * **Weighted-fair scheduling** — admission stamps the resolved class
    on the request (``tenant_class``) and lifts its priority to the
    class priority; :class:`~.lanes.WeightedFairLane` then drains
    per-class sub-queues by deficit round-robin on the class weights,
    and the priority stamp makes watermark shedding land on the lowest
    class first.
  * **Degradation ladder** — :class:`DegradationLadder` listens to
    SLOWatchdog evaluations and, under ``breach_ticks`` consecutive
    breaching ticks, steps down one reversible level at a time (shrink
    sample fanout → pause coldcache admission writes → route the floor
    class to the CPU lane → shed the floor class at admission);
    ``recover_ticks`` consecutive healthy ticks step back up.  Every
    transition moves the ``serving_degradation_level`` gauge and is
    kept in a bounded history for ``GET /debug/qos``.

Disabled (``config.qos_enabled = False``, the default) none of this is
constructed and the serving hot path pays one ``is None`` attribute
check.

Locking: controller buckets and ladder state are touched from stream
threads, the device loop, and the watchdog thread; all mutation holds
the declared locks.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .. import telemetry
from ..telemetry import flightrec
from ..telemetry import timeline as _timeline
from .deadline import shed
from .errors import QuotaExceeded

__all__ = [
    "TenantClass", "TokenBucket", "QoSController", "LadderStep",
    "DegradationLadder", "parse_tenant_spec", "serving_ladder",
    "install_qos", "get_qos", "qos_from_config", "qos_status", "reset",
]


@dataclass(frozen=True)
class TenantClass:
    """One declared tenant class (the unit of quota, weight, and
    shed ordering).  ``rate`` is tokens (requests) per second, ``burst``
    the bucket capacity, ``weight`` the fair-share scheduling weight,
    ``priority`` the shed ordering (higher survives longer)."""

    name: str
    rate: float = 100.0
    burst: float = 25.0
    weight: float = 1.0
    priority: int = 0


def parse_tenant_spec(spec: str) -> Dict[str, TenantClass]:
    """Parse ``config.qos_tenants``: ``;``-separated
    ``name:key=value,...`` entries.  Raises on malformed entries — a
    typo'd quota silently defaulting would be an outage, not a
    convenience."""
    classes: Dict[str, TenantClass] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, body = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant entry {entry!r} has no name")
        kwargs: Dict[str, float] = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("rate", "burst", "weight", "priority"):
                raise ValueError(
                    f"unknown tenant field {k!r} in {entry!r} "
                    f"(rate|burst|weight|priority)")
            kwargs[k] = float(v)
        if kwargs.get("rate", 1.0) <= 0 or kwargs.get("burst", 1.0) <= 0:
            raise ValueError(f"tenant {name!r} needs rate > 0, burst > 0")
        if "priority" in kwargs:
            kwargs["priority"] = int(kwargs["priority"])
        classes[name] = TenantClass(name=name, **kwargs)
    if not classes:
        raise ValueError(f"tenant spec {spec!r} declares no classes")
    return classes


class TokenBucket:
    """Classic token bucket with an injectable monotonic clock.

    Not internally locked: the owning controller serializes access
    (one lock covers resolve + take, so two racing admits cannot both
    spend the last token).
    """

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._t_last = clock()

    def try_take(self, n: float = 1.0) -> float:
        """Take ``n`` tokens.  Returns 0.0 on success, else the seconds
        until ``n`` tokens will have refilled (the retry-after hint)."""
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        return (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        return self._tokens


class QoSController:
    """Per-tenant admission gate + the ladder's routing flags.

    ``route_floor_to_cpu`` / ``shed_floor`` are plain booleans written
    only by the ladder (under its lock) and read as single attribute
    loads on the admission path — the reader tolerates one stale
    observation by design (the ladder moves on second-scale ticks).
    """

    _guarded_by = {"_buckets": "_lock"}

    def __init__(self, classes: Optional[Dict[str, TenantClass]] = None,
                 default: Optional[str] = None,
                 ingest: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..config import get_config

        cfg = get_config()
        self.classes = (dict(classes) if classes is not None
                        else parse_tenant_spec(cfg.qos_tenants))
        self.default = default if default is not None \
            else cfg.qos_default_tenant
        self.ingest = ingest if ingest is not None else cfg.qos_ingest_tenant
        if self.default not in self.classes:
            raise ValueError(f"default tenant {self.default!r} is not a "
                             f"declared class {sorted(self.classes)}")
        # the floor class: lowest priority among query classes (the
        # ingest class sheds on its own lane, so it is not a candidate
        # for the ladder's route-to-cpu / shed steps)
        floor_pool = [c for n, c in self.classes.items() if n != self.ingest]
        self.floor = min(floor_pool or self.classes.values(),
                         key=lambda c: (c.priority, c.name)).name
        self._lock = threading.Lock()
        self._buckets = {n: TokenBucket(c.rate, c.burst, clock)
                         for n, c in self.classes.items()}
        # ladder-written routing flags (single attr read on hot paths)
        self.route_floor_to_cpu = False
        self.shed_floor = False
        self.ladder: Optional["DegradationLadder"] = None

    # -- resolution ----------------------------------------------------
    def resolve(self, tenant: Optional[str]) -> TenantClass:
        """Tenant label -> declared class (the allowlist); unknown or
        missing labels map to the default class."""
        cls = self.classes.get(tenant) if tenant else None
        return cls if cls is not None else self.classes[self.default]

    def weights(self) -> Dict[str, float]:
        return {n: c.weight for n, c in self.classes.items()}

    # -- admission (the gate every enqueue goes through) ---------------
    def admit(self, req, result_queue) -> bool:
        """Admit ``req`` or answer it (False = caller must drop it).

        Stamps the resolved class (``req.tenant_class``) and lifts
        ``req.priority`` to the class priority so downstream fair lanes
        and watermark sheds order by class.  Rejections are answered on
        ``result_queue`` exactly like sheds: typed exception, metric,
        retained flight record.
        """
        cls = self.resolve(getattr(req, "tenant", None))
        req.tenant_class = cls.name
        if req.priority < cls.priority:
            req.priority = cls.priority
        tr = getattr(req, "trace", None)
        ladder = self.ladder
        level = ladder.level if ladder is not None else 0
        if tr is not None and level:
            # degraded-mode breadcrumb: retained flight records show
            # which ladder level was in force when this request entered
            tr.add("qos.level", {"level": level})
        if self.shed_floor and cls.name == self.floor:
            shed(req, result_queue, "qos", "degraded")
            return False
        with self._lock:
            retry_after = self._buckets[cls.name].try_take()
        if retry_after > 0.0:
            telemetry.counter("serving_qos_rejected_total",
                              tenant=cls.name).inc()
            exc = QuotaExceeded(cls.name, retry_after)
            if tr is not None:
                tr.add("reject", {"reason": "quota", "tenant": cls.name,
                                  "retry_after_s": round(retry_after, 4)})
                flightrec.get_recorder().finish(
                    tr, max(time.perf_counter() - req.t_enqueue, 0.0),
                    status="rejected", lane="qos")
            if result_queue is not None:
                result_queue.put((req, exc))
            return False
        telemetry.counter("serving_qos_admitted_total",
                          tenant=cls.name).inc()
        return True

    # -- read side -----------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            buckets = {n: round(b.tokens, 3)
                       for n, b in sorted(self._buckets.items())}
        st = {
            "classes": [
                {"name": c.name, "rate": c.rate, "burst": c.burst,
                 "weight": c.weight, "priority": c.priority}
                for _, c in sorted(self.classes.items())
            ],
            "default": self.default,
            "ingest": self.ingest,
            "floor": self.floor,
            "tokens": buckets,
            "route_floor_to_cpu": self.route_floor_to_cpu,
            "shed_floor": self.shed_floor,
        }
        ladder = self.ladder
        if ladder is not None:
            st["ladder"] = ladder.status()
        return st


@dataclass(frozen=True)
class LadderStep:
    """One reversible degradation: ``apply()`` on step-down, ``revert()``
    on step-up.  Both must be idempotent — the ladder calls each at most
    once per transition, but operators can replay them by hand."""

    name: str
    apply: Callable[[], None]
    revert: Callable[[], None]


class DegradationLadder:
    """Burn-rate-driven reversible brownout.

    ``observe(breaching)`` is fed once per SLO evaluation (attach to a
    watchdog via :meth:`attach`).  ``breach_ticks`` consecutive
    breaching observations step DOWN one level (apply the next step);
    ``recover_ticks`` consecutive healthy observations step UP one
    (revert the newest applied step) — hysteresis in both directions so
    a single noisy window cannot flap the system.  Level 0 = nothing
    applied; level N = steps[0..N-1] applied, in order.
    """

    _guarded_by = {"_level": "_lock", "_breaches": "_lock",
                   "_healthy": "_lock", "_history": "_lock"}

    _MAX_HISTORY = 64

    def __init__(self, steps: List[LadderStep],
                 breach_ticks: Optional[int] = None,
                 recover_ticks: Optional[int] = None):
        from ..config import get_config

        cfg = get_config()
        self.steps = list(steps)
        self.breach_ticks = int(breach_ticks if breach_ticks is not None
                                else cfg.qos_breach_ticks)
        self.recover_ticks = int(recover_ticks if recover_ticks is not None
                                 else cfg.qos_recover_ticks)
        if self.breach_ticks < 1 or self.recover_ticks < 1:
            raise ValueError("breach_ticks and recover_ticks must be >= 1")
        self._lock = threading.Lock()
        self._level = 0
        self._breaches = 0
        self._healthy = 0
        self._history: List[dict] = []
        telemetry.gauge("serving_degradation_level").set(0)

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def observe(self, breaching: bool) -> int:
        """Fold one SLO evaluation in; returns the (possibly new) level.
        Step apply/revert callbacks run OUTSIDE the lock — they touch
        foreign subsystems (sampler, caches) that must not nest under
        ladder state."""
        action = None
        with self._lock:
            if breaching:
                self._breaches += 1
                self._healthy = 0
                if (self._breaches >= self.breach_ticks
                        and self._level < len(self.steps)):
                    self._breaches = 0
                    self._level += 1
                    action = ("down", self._level)
            else:
                self._healthy += 1
                self._breaches = 0
                if (self._healthy >= self.recover_ticks
                        and self._level > 0):
                    self._healthy = 0
                    action = ("up", self._level - 1)
                    self._level -= 1
            level = self._level
        if action is not None:
            self._transition(*action)
        return level

    def _transition(self, direction: str, level_arg: int) -> None:
        if direction == "down":
            step = self.steps[level_arg - 1]
            new_level = level_arg
            step.apply()
        else:
            step = self.steps[level_arg]
            new_level = level_arg
            step.revert()
        telemetry.gauge("serving_degradation_level").set(new_level)
        telemetry.counter("serving_qos_ladder_transitions_total",
                          direction=direction, step=step.name).inc()
        if flightrec.tracing():
            # forwards to the unified timeline too, trace-correlated
            flightrec.event("qos.ladder", {"direction": direction,
                                           "step": step.name,
                                           "level": new_level})
        elif _timeline._ON:
            # ladder ticks usually come from the watchdog thread with
            # no request trace active — land them on the timeline anyway
            _timeline.emit("qos.ladder", cat="qos",
                           attrs={"direction": direction,
                                  "step": step.name, "level": new_level})
        with self._lock:
            self._history.append({"t_wall": time.time(),
                                  "direction": direction,
                                  "step": step.name, "level": new_level})
            if len(self._history) > self._MAX_HISTORY:
                self._history.pop(0)

    def attach(self, watchdog,
               objectives: Optional[tuple] = None) -> "DegradationLadder":
        """Subscribe to a :class:`~quiver_tpu_torch.telemetry.slo.SLOWatchdog`:
        each evaluation becomes one ``observe`` tick (breaching iff any
        watched objective breaches; default = all objectives)."""
        names = set(objectives) if objectives else None

        def _on_eval(results):
            self.observe(any(
                r["breaching"] for r in results
                if names is None or r["objective"] in names))

        watchdog.add_listener(_on_eval)
        return self

    def status(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "max_level": len(self.steps),
                "steps": [s.name for s in self.steps],
                "breach_ticks": self.breach_ticks,
                "recover_ticks": self.recover_ticks,
                "history": list(self._history[-16:]),
            }


def serving_ladder(controller: QoSController, sampler=None,
                   cold_cache=None,
                   fanout_frac: Optional[float] = None,
                   breach_ticks: Optional[int] = None,
                   recover_ticks: Optional[int] = None
                   ) -> DegradationLadder:
    """The standard four-step serving ladder, mildest first:

      1. ``fanout`` — scale the host sampler's per-hop fanout by
         ``config.qos_degrade_fanout_frac`` (smaller frontiers, cheaper
         batches).  Host path only: device executables bake fanout as a
         closure constant, and recompiling under overload is exactly the
         wrong move.
      2. ``coldcache`` — pause cold-row overlay admission writes (probes
         still hit; the admission bookkeeping + H2D scatter stops).
      3. ``cpu_floor`` — route the floor class to the CPU lane.
      4. ``shed_floor`` — shed the floor class at admission.

    ``sampler`` / ``cold_cache`` may be None (those steps no-op) so the
    ladder degrades gracefully on partial deployments.  Registers
    itself on the controller (``controller.ladder``).
    """
    from ..config import get_config

    frac = float(fanout_frac if fanout_frac is not None
                 else get_config().qos_degrade_fanout_frac)

    def _set_fanout(f: float) -> None:
        if sampler is not None and hasattr(sampler, "set_fanout_frac"):
            sampler.set_fanout_frac(f)

    def _pause_coldcache(paused: bool) -> None:
        cc = cold_cache
        if cc is not None:
            cc.admission_paused = paused

    def _route_floor(on: bool) -> None:
        controller.route_floor_to_cpu = on

    def _shed_floor(on: bool) -> None:
        controller.shed_floor = on

    steps = [
        LadderStep("fanout", lambda: _set_fanout(frac),
                   lambda: _set_fanout(1.0)),
        LadderStep("coldcache", lambda: _pause_coldcache(True),
                   lambda: _pause_coldcache(False)),
        LadderStep("cpu_floor", lambda: _route_floor(True),
                   lambda: _route_floor(False)),
        LadderStep("shed_floor", lambda: _shed_floor(True),
                   lambda: _shed_floor(False)),
    ]
    ladder = DegradationLadder(steps, breach_ticks=breach_ticks,
                               recover_ticks=recover_ticks)
    controller.ladder = ladder
    return ladder


# -- process-wide controller (feeds GET /debug/qos) ----------------------
_CONTROLLER: Optional[QoSController] = None
_controller_lock = threading.Lock()


def install_qos(controller: QoSController) -> QoSController:
    """Register ``controller`` process-wide (latest wins, like breakers:
    a restarted server's controller replaces its predecessor's on the
    debug endpoint)."""
    global _CONTROLLER
    with _controller_lock:
        _CONTROLLER = controller
    return controller


def get_qos() -> Optional[QoSController]:
    with _controller_lock:
        return _CONTROLLER


def qos_from_config() -> Optional[QoSController]:
    """The installed controller when QoS is enabled, creating (and
    installing) one from config on first touch; None when
    ``config.qos_enabled`` is off — callers store the None and their
    hot path pays a single attribute check."""
    global _CONTROLLER
    from ..config import get_config

    if not get_config().qos_enabled:
        return None
    with _controller_lock:
        if _CONTROLLER is None:
            _CONTROLLER = QoSController()
        return _CONTROLLER


def qos_status() -> dict:
    """JSON view for ``GET /debug/qos``."""
    from ..config import get_config

    ctl = get_qos()
    if ctl is None:
        return {"enabled": bool(get_config().qos_enabled),
                "installed": False}
    st = ctl.status()
    st["enabled"] = bool(get_config().qos_enabled)
    st["installed"] = True
    return st


def reset() -> None:
    """Drop the installed controller (tests)."""
    global _CONTROLLER
    with _controller_lock:
        _CONTROLLER = None
