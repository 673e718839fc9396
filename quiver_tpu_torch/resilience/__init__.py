"""quiver_tpu_torch.resilience — fault tolerance for the serving pipeline.

The SLO watchdog *detects* breaches; this package makes the system
*react* to them.  The mechanisms, threaded through serving:

  * **deadlines** (:mod:`.deadline`) — every :class:`ServingRequest`
    carries an absolute deadline (``config.serving_deadline_ms``);
    each stage boundary sheds expired requests with a typed
    :class:`~quiver_tpu_torch.resilience.errors.DeadlineExceeded` answer
    instead of letting them age silently in a queue.
  * **bounded queues + admission control** (:mod:`.lanes`) —
    :class:`BoundedLane` wraps the stage queues with capacity and
    high/low watermarks, shedding lowest-priority work first and
    ticking ``serving_shed_total{reason}``.
  * **circuit breaking + lane failover** (:mod:`.breaker`) — repeated
    device-lane failures trip a per-lane closed→open→half-open
    :class:`CircuitBreaker`; in-flight requests reroute to the CPU
    sampler lane.
  * **multi-tenant QoS + degradation ladder** (:mod:`.qos`,
    :class:`~.lanes.WeightedFairLane`) — per-tenant token-bucket
    admission (typed :class:`~.errors.QuotaExceeded` answers with a
    retry-after hint), deficit-weighted round-robin fair scheduling
    across tenant classes, and a reversible SLO-burn-driven brownout
    ladder (``serving_degradation_level``).  Off by default
    (``config.qos_enabled``); the hot path then pays one check.
  * **deterministic fault injection** (:mod:`.chaos`) — named
    injection points (``chaos.point("serving.device_lane")``) compile
    to one attribute read + None-check when no plan is installed, and
    replay byte-identically under a seeded :class:`ChaosPlan`.

Everything emits flight-recorder events and registry metrics (breaker
state gauge, shed / retry / degraded counters) so ``/debug/slo`` and
``/debug/breakers`` show remediation, not just breach.
"""

from __future__ import annotations

from .breaker import CircuitBreaker, breakers_status, get_breaker
from .chaos import ChaosPlan, point
from .deadline import (check_ambient, deadline_for, deadline_scope, shed,
                       shed_if_expired)
from .errors import (ChaosFault, DeadlineExceeded, LaneUnavailable,
                     LoadShed, PeerTimeout, QuotaExceeded, ResilienceError)
from .lanes import BoundedLane, WeightedFairLane
from .qos import (DegradationLadder, LadderStep, QoSController, TenantClass,
                  TokenBucket, get_qos, install_qos, qos_from_config,
                  qos_status, serving_ladder)
from .retry import Backoff, retry_call
from .shutdown import join_and_reap

__all__ = [
    "Backoff", "BoundedLane", "ChaosFault", "ChaosPlan", "CircuitBreaker",
    "DeadlineExceeded", "DegradationLadder", "LadderStep", "LaneUnavailable",
    "LoadShed", "PeerTimeout", "QoSController", "QuotaExceeded",
    "ResilienceError", "TenantClass", "TokenBucket", "WeightedFairLane",
    "breakers_status", "check_ambient", "deadline_for", "deadline_scope",
    "get_breaker", "get_qos", "install_qos", "join_and_reap", "point",
    "qos_from_config", "qos_status", "retry_call", "serving_ladder",
    "shed", "shed_if_expired",
]
