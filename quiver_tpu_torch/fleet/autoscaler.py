"""Federation-driven autoscaler: predictive spawn/drain over the fleet
(counterpart of ``quiver_tpu/fleet/autoscaler.py``).

The reactive loop everyone builds first — "p99 breached, add a replica"
— pays the whole join latency *during* the burst.  This autoscaler is
predictive where the workload allows it: a :class:`DiurnalPredictor`
fits a periodic rate profile (graph-serving traffic is strongly
diurnal) plus a short linear trend, and the control loop provisions for
the rate ``fleet_autoscaler_horizon_s`` seconds *ahead*.  A warm join
(shared checkpoint + persisted feature cache, measured by
``fleet_join_seconds``) lands before the peak instead of after it.

Inputs are read-only federation state — the same merged snapshot
``FleetSLOWatchdog`` scores (fleet request rate, merged p99, max
staleness, eligible-replica floor) — so the scaler needs no new wires
into replicas.  Outputs are two callables supplied by the harness or
operator: ``spawn_fn(count)`` and ``drain_fn(replica_id)``, which go
through the normal membership join/drain choreography; the scaler
never kills processes itself and never drains the leader.

Flap control is structural, not tuned: scale-up needs predicted load
above ``up_ratio`` of current capacity, scale-down below
``down_ratio`` of the *shrunk* capacity (hysteresis band), drains move
one replica at a time, and after any action the loop holds for
``fleet_autoscaler_cooldown_s`` — at most one membership direction
change per cooldown window, by construction.

Everything here is wall-clock driven (diurnal phase only means
anything in wall time) but every entry point takes an explicit ``now``
so tests and the chaos harness replay synthetic days in milliseconds.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from .. import telemetry
from ..telemetry.slo import _merged_histogram, _sum_counters

__all__ = ["DiurnalPredictor", "FleetAutoscaler"]

log = logging.getLogger("quiver_tpu_torch.fleet")


class DiurnalPredictor:
    """Periodic rate profile (per-bucket EWMA) + short linear trend.

    ``observe(t, rate)`` folds a measured request rate into the profile
    bucket that ``t`` falls in; ``predict(t)`` returns the larger of
    the profile's memory of that phase and a least-squares trend over
    the recent window — the profile anticipates the *recurring* ramp,
    the trend tracks a burst the profile has never seen.  Single
    caller (the autoscaler loop), so no locking."""

    def __init__(self, period_s: float = 86400.0, buckets: int = 48,
                 alpha: float = 0.3, window: int = 64):
        if period_s <= 0 or buckets <= 0:
            raise ValueError("period_s and buckets must be positive")
        self.period_s = float(period_s)
        self.buckets = int(buckets)
        self.alpha = float(alpha)
        self._profile: List[Optional[float]] = [None] * self.buckets
        self._recent: deque = deque(maxlen=int(window))

    def _bucket(self, t: float) -> int:
        phase = (t % self.period_s) / self.period_s
        return min(int(phase * self.buckets), self.buckets - 1)

    def observe(self, t: float, rate: float) -> None:
        rate = max(float(rate), 0.0)
        b = self._bucket(t)
        prev = self._profile[b]
        self._profile[b] = (rate if prev is None
                            else self.alpha * rate
                            + (1.0 - self.alpha) * prev)
        self._recent.append((float(t), rate))

    def _trend(self, t: float) -> float:
        pts = list(self._recent)
        if len(pts) < 2:
            return pts[-1][1] if pts else 0.0
        t0 = pts[0][0]
        xs = [p[0] - t0 for p in pts]
        ys = [p[1] for p in pts]
        n = len(pts)
        mx, my = sum(xs) / n, sum(ys) / n
        var = sum((x - mx) ** 2 for x in xs)
        if var <= 0.0:
            return ys[-1]
        slope = sum((x - mx) * (y - my)
                    for x, y in zip(xs, ys)) / var
        return my + slope * ((t - t0) - mx)

    def predict(self, t: float) -> float:
        """Predicted request rate at (future) time ``t``."""
        profile = self._profile[self._bucket(t)]
        return max(self._trend(t), profile if profile is not None
                   else 0.0, 0.0)


class FleetAutoscaler:
    """The control loop: federation snapshot in, spawn/drain out.

    Lock discipline: decision state is written by the scaler thread and read by
    ``status()`` from HTTP/test threads; both hold ``_lock``."""

    _guarded_by = {
        "_prev_total": "_lock",
        "_prev_t": "_lock",
        "_last_action_t": "_lock",
        "_last_decision": "_lock",
        "_target": "_lock",
    }

    def __init__(self,
                 snapshot_fn: Callable[[], dict],
                 spawn_fn: Callable[[int], None],
                 drain_fn: Callable[[Optional[str]], None],
                 directory=None,
                 predictor: Optional[DiurnalPredictor] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 rps_per_replica: Optional[float] = None,
                 horizon_s: Optional[float] = None,
                 up_ratio: Optional[float] = None,
                 down_ratio: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 name: str = "autoscaler"):
        from ..config import get_config

        cfg = get_config()
        self.snapshot_fn = snapshot_fn
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn
        self.directory = directory
        self.predictor = predictor or DiurnalPredictor()
        self.name = str(name)
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else cfg.fleet_autoscaler_min)
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else cfg.fleet_autoscaler_max)
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else cfg.fleet_autoscaler_cooldown_s)
        self.rps_per_replica = float(
            rps_per_replica if rps_per_replica is not None
            else cfg.fleet_autoscaler_rps_per_replica)
        self.horizon_s = float(horizon_s if horizon_s is not None
                               else cfg.fleet_autoscaler_horizon_s)
        self.up_ratio = float(up_ratio if up_ratio is not None
                              else cfg.fleet_autoscaler_up_ratio)
        self.down_ratio = float(down_ratio if down_ratio is not None
                                else cfg.fleet_autoscaler_down_ratio)
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.fleet_autoscaler_interval_s)
        self._p99_ceiling_s = cfg.slo_p99_ms / 1e3
        self._staleness_ceiling = cfg.fleet_max_staleness_lsn
        self._heartbeat_timeout_s = cfg.fleet_heartbeat_timeout_s
        self._lock = threading.Lock()
        self._prev_total: Optional[float] = None
        self._prev_t: Optional[float] = None
        self._last_action_t: Optional[float] = None
        self._last_decision: dict = {"action": "hold", "reason": "init"}
        self._target: Optional[int] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- fleet state readers -------------------------------------------
    def _replica_counts(self, snap: dict) -> Tuple[int, List]:
        """(serving replica count, drainable non-leader candidates)."""
        if self.directory is not None:
            members = [r for r in self.directory.replicas(fresh_only=True)
                       if r.state == "serving"]
            drainable = sorted(
                (r for r in members if r.role != "leader"),
                key=lambda r: r.replica_id)
            return len(members), drainable
        v = snap.get("gauges", {}).get("fleet_router_eligible_total")
        return (int(v) if v is not None else 0), []

    @staticmethod
    def _max_staleness(snap: dict) -> int:
        from ..telemetry.registry import parse_metric_key

        worst = 0
        for key, v in snap.get("gauges", {}).items():
            name, _labels = parse_metric_key(key)
            if name == "fleet_replica_staleness_lsn":
                worst = max(worst, int(v))
        return worst

    # -- the decision --------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None,
                      execute: bool = True) -> dict:
        """One control-loop tick: measure, predict, decide, (execute).

        Returns the decision record:
        ``{"action": spawn|drain|hold, "count", "target", "current",
        "predicted_rps", "rate_rps", "reason"}``."""
        # diurnal phase is only meaningful in wall time, and the rate
        # delta must share the predictor's timeline
        now = time.time() if now is None else float(now)
        snap = self.snapshot_fn()
        total = _sum_counters(snap, "fleet_replica_requests_total")
        with self._lock:
            prev_total, prev_t = self._prev_total, self._prev_t
            self._prev_total, self._prev_t = total, now
        rate = 0.0
        if prev_total is not None and prev_t is not None and now > prev_t:
            rate = max(total - prev_total, 0.0) / (now - prev_t)
            self.predictor.observe(now, rate)
        predicted = self.predictor.predict(now + self.horizon_s)

        current, drainable = self._replica_counts(snap)
        hist = _merged_histogram(snap, "fleet_replica_request_seconds")
        p99 = (hist.percentile(99)
               if hist is not None and hist.count else 0.0)
        staleness = self._max_staleness(snap)

        desired = max(int(math.ceil(predicted / self.rps_per_replica))
                      if self.rps_per_replica > 0 else current, 1)
        reason = f"predicted {predicted:.1f} rps"
        breach = False
        if p99 > self._p99_ceiling_s > 0:
            desired, breach = max(desired, current + 1), True
            reason = f"p99 breach ({p99 * 1e3:.0f}ms)"
        if staleness > self._staleness_ceiling > 0:
            desired, breach = max(desired, current + 1), True
            reason = f"staleness breach ({staleness} lsn)"

        capacity = current * self.rps_per_replica
        action, target = "hold", current
        if current <= 0:
            # nothing serving yet: membership choreography (first boot,
            # leader election) owns this phase, not the scaler
            reason = "no serving replicas"
        elif desired > current and (
                breach or predicted > self.up_ratio * capacity):
            action, target = "spawn", min(desired, self.max_replicas)
        elif (desired < current
              # the horizon looks past a burst's end while the burst is
              # still hot — the measured rate floors the shrink decision
              # so capacity never drains out from under live load
              and max(predicted, rate) < self.down_ratio
              * (current - 1) * self.rps_per_replica):
            action, target = "drain", max(current - 1, self.min_replicas)
            reason = (f"predicted {predicted:.1f} rps under "
                      f"{self.down_ratio:.0%} of shrunk capacity")
        target = max(min(target, self.max_replicas), self.min_replicas)
        if target == current:
            action = "hold"

        with self._lock:
            last_action_t = self._last_action_t
        if action != "hold" and last_action_t is not None \
                and (now - last_action_t) < self.cooldown_s:
            action, target = "hold", current
            reason = f"cooldown ({self.cooldown_s:.0f}s)"

        count = abs(target - current)
        decision = {"action": action, "count": count, "target": target,
                    "current": current, "predicted_rps": predicted,
                    "rate_rps": rate, "p99_s": p99,
                    "max_staleness_lsn": staleness, "reason": reason}
        telemetry.counter("fleet_autoscaler_decisions_total",
                          action=action).inc()
        telemetry.gauge("fleet_autoscaler_target_replicas").set(target)
        telemetry.gauge("fleet_autoscaler_predicted_rps").set(predicted)
        with self._lock:
            self._last_decision = dict(decision)
            self._target = target
            if action != "hold":
                self._last_action_t = now

        if execute and action == "spawn":
            self.spawn_fn(count)
        elif execute and action == "drain":
            victim = drainable[-1].replica_id if drainable else None
            self.drain_fn(victim)
        return decision

    def status(self) -> dict:
        with self._lock:
            return dict(self._last_decision)

    # -- loop ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"quiver-fleet-{self.name}")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            from ..resilience.shutdown import join_and_reap

            join_and_reap([self._thread], timeout,
                          component="fleet.autoscaler")
            self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # noqa: BLE001 -- scaler must outlive a bad tick
                log.warning("autoscaler tick failed: %s", e)
                telemetry.counter("fleet_autoscaler_errors_total").inc()
