"""Elastic replicated serving fleet (counterpart of
``quiver_tpu/fleet/``, docs/FLEET.md).

Turns the single-node subsystems into a deployable system: a thin
partition-aware router in front of N replicas that warm-boot from
shared checkpoints + the shared kernel build cache, tail the
single-writer WAL for reads, and survive ``kill -9`` mid-burst without
losing an in-flight request (``chip_smoke.py``'s fleet phase).

  * :mod:`~quiver_tpu_torch.fleet.membership` — shared file-based replica
    directory (atomic-rename records, heartbeat freshness);
  * :mod:`~quiver_tpu_torch.fleet.shipping` — read-only WAL follower with a
    measured, bounded staleness watermark;
  * :mod:`~quiver_tpu_torch.fleet.replica` — replica lifecycle: warm join,
    heartbeats, TCP serving endpoint, drain/rejoin;
  * :mod:`~quiver_tpu_torch.fleet.router` — consistent-hash routing, health
    gating, per-replica breakers, bounded re-dispatch;
  * :mod:`~quiver_tpu_torch.fleet.federation` — the fleet observability
    plane: metrics federation, fleet SLOs, clock-aligned merged
    timelines, cross-process trace reconstruction
    (docs/OBSERVABILITY.md);
  * :mod:`~quiver_tpu_torch.fleet.election` — fenced leader auto-failover:
    epoch-stamped exclusive claims, a fencing token on every write,
    ranked follower promotion (``fleet_election=on``);
  * :mod:`~quiver_tpu_torch.fleet.walstream` — socket WAL shipping for
    followers with no shared WAL filesystem (``fleet_walstream=on``);
  * :mod:`~quiver_tpu_torch.fleet.autoscaler` — federation-driven predictive
    spawn/drain control loop (``fleet_autoscaler=on``).
"""

from .autoscaler import DiurnalPredictor, FleetAutoscaler
from .election import (ClaimRecord, ElectionDirectory, EpochFence,
                       FencedWAL, LeaderElector, StaleEpochError)
from .federation import (FleetFederation, FleetSLOWatchdog,
                         estimate_offsets, federate, federation_status,
                         get_federation, parse_prometheus_text)
from .membership import FLEET_STATES, MembershipDirectory, ReplicaInfo
from .replica import FleetReplica
from .router import ConsistentHashRing, FleetRouter, fleet_status
from .shipping import TailFollower, WALFollower
from .walstream import WALStreamFollower, WALStreamServer

__all__ = [
    "FLEET_STATES", "MembershipDirectory", "ReplicaInfo", "FleetReplica",
    "ConsistentHashRing", "FleetRouter", "fleet_status", "WALFollower",
    "TailFollower", "FleetFederation", "FleetSLOWatchdog",
    "estimate_offsets", "federate", "federation_status", "get_federation",
    "parse_prometheus_text", "ClaimRecord", "ElectionDirectory",
    "EpochFence", "FencedWAL", "LeaderElector", "StaleEpochError",
    "WALStreamServer", "WALStreamFollower", "DiurnalPredictor",
    "FleetAutoscaler",
]
