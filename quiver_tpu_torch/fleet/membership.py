"""Shared membership directory for the serving fleet
(counterpart of ``quiver_tpu/fleet/membership.py``).

One directory on a filesystem every replica can reach (the same class
of storage the checkpoints already live on) holds one
``replica-<id>.json`` per member, published through
``blockio.atomic_publish`` — readers see a complete old record or a
complete new one, never a torn hybrid, and a crashed writer leaves at
worst a stale record that ages out of the freshness window.  No
external coordination service: the WAL stays single-writer, so the
directory only has to answer "who exists, in what state, how fresh" —
liveness is decided by heartbeat age, not by consensus.

A replica announces itself through the fleet readiness ladder
(``booting → replaying → warming → serving``, plus ``draining`` while
it finishes in-flight work before deregistering).  The router treats
only *fresh* ``serving`` records as routable; everything else is
visible for operators (``/debug/fleet``) but receives no traffic.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import telemetry
from ..recovery import blockio
from ..recovery.manager import RECOVERY_STATES

__all__ = ["FLEET_STATES", "ReplicaInfo", "MembershipDirectory",
           "shard_groups", "group_complete"]

# the recovery ladder plus the explicit-drain state; order is the gauge
# encoding of fleet_replica_state
FLEET_STATES = RECOVERY_STATES + ("draining",)
_STATE_CODE = {s: i for i, s in enumerate(FLEET_STATES)}

_REC_RE = re.compile(r"^replica-([A-Za-z0-9_.-]+)\.json$")


def _record_path(root: str, replica_id: str) -> str:
    if not re.match(r"^[A-Za-z0-9_.-]+$", replica_id):
        raise ValueError(f"replica id {replica_id!r} must be filesystem-"
                         "safe ([A-Za-z0-9_.-])")
    return os.path.join(root, f"replica-{replica_id}.json")


@dataclass
class ReplicaInfo:
    """One parsed membership record."""

    replica_id: str
    state: str = "booting"
    host: str = "127.0.0.1"
    port: int = 0
    role: str = "follower"          # "leader" | "follower"
    pid: int = 0
    heartbeat: float = 0.0          # wall-clock time of the last announce
    staleness_lsn: int = 0
    staleness_seconds: float = 0.0
    wal_next_lsn: int = -1          # leaders: the shipping frontier
    epoch: int = -1                 # leaders: the fencing epoch claimed
    detail: dict = field(default_factory=dict)

    def fresh(self, timeout_s: float, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return (now - self.heartbeat) <= timeout_s

    # -- shard-group membership (docs/SHARDING.md) ---------------------
    # Shard groups ride the extensible ``detail`` dict, so records from
    # pre-mesh builds parse unchanged and an unsharded fleet never
    # carries the keys at all.
    @property
    def shard_group(self) -> Optional[str]:
        """Group id when this member is one shard of a logical replica
        spanning several processes; None for a whole-graph replica."""
        g = self.detail.get("shard_group")
        return str(g) if g else None

    @property
    def shard_index(self) -> int:
        try:
            return int(self.detail.get("shard_index", 0))
        except (TypeError, ValueError):
            return 0

    @property
    def shard_count(self) -> int:
        try:
            return int(self.detail.get("shard_count", 0))
        except (TypeError, ValueError):
            return 0

    def to_dict(self) -> dict:
        return {
            "replica_id": self.replica_id, "state": self.state,
            "host": self.host, "port": self.port, "role": self.role,
            "pid": self.pid, "heartbeat": self.heartbeat,
            "staleness_lsn": self.staleness_lsn,
            "staleness_seconds": self.staleness_seconds,
            "wal_next_lsn": self.wal_next_lsn, "epoch": self.epoch,
            "detail": self.detail,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaInfo":
        return cls(
            replica_id=str(d["replica_id"]),
            state=str(d.get("state", "booting")),
            host=str(d.get("host", "127.0.0.1")),
            port=int(d.get("port", 0)),
            role=str(d.get("role", "follower")),
            pid=int(d.get("pid", 0)),
            heartbeat=float(d.get("heartbeat", 0.0)),
            staleness_lsn=int(d.get("staleness_lsn", 0)),
            staleness_seconds=float(d.get("staleness_seconds", 0.0)),
            wal_next_lsn=int(d.get("wal_next_lsn", -1)),
            epoch=int(d.get("epoch", -1)),
            detail=dict(d.get("detail", {})),
        )


def shard_groups(infos: List[ReplicaInfo]) -> Dict[str, List[ReplicaInfo]]:
    """Group shard members by group id, sorted by shard index.  Members
    without a ``shard_group`` (whole-graph replicas) are not included —
    they route as singletons."""
    groups: Dict[str, List[ReplicaInfo]] = {}
    for info in infos:
        gid = info.shard_group
        if gid is not None:
            groups.setdefault(gid, []).append(info)
    for members in groups.values():
        members.sort(key=lambda r: (r.shard_index, r.replica_id))
    return groups


def group_complete(members: List[ReplicaInfo]) -> bool:
    """A shard group is routable only when EVERY declared shard is
    present exactly once: each member's declared ``shard_count`` must
    agree and the shard indices must be exactly ``{0 .. n-1}`` — a
    half-booted or split-brained group never takes traffic."""
    if not members:
        return False
    counts = {m.shard_count for m in members}
    if len(counts) != 1:
        return False
    n = counts.pop()
    if n < 1 or len(members) != n:
        return False
    return sorted(m.shard_index for m in members) == list(range(n))


class MembershipDirectory:
    """File-backed fleet membership: announce / scan / deregister.

    Stateless between calls — every reader re-scans the directory, so
    there is no cached view to invalidate and any process (router,
    replica, operator tooling) can open its own instance over the same
    root.  Announce is an atomic whole-file publish; deregister is an
    unlink; a record whose JSON does not parse (torn by a crashed
    pre-atomic writer, or hand-edited) is skipped, never fatal.
    """

    def __init__(self, root: str,
                 heartbeat_timeout_s: Optional[float] = None):
        from ..config import get_config

        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.heartbeat_timeout_s = float(
            heartbeat_timeout_s if heartbeat_timeout_s is not None
            else get_config().fleet_heartbeat_timeout_s)

    # -- write side ----------------------------------------------------
    def announce(self, info: ReplicaInfo,
                 heartbeat: Optional[float] = None) -> str:
        """Publish (or refresh) one replica record; returns its path."""
        if info.state not in FLEET_STATES:
            raise ValueError(f"unknown fleet state {info.state!r} "
                             f"(expected one of {FLEET_STATES})")
        # stamp the published record, not the caller's object — announce
        # may run from a heartbeat thread while the owner reads its copy
        stamp = time.time() if heartbeat is None else heartbeat
        path = _record_path(self.root, info.replica_id)
        blockio.atomic_publish(
            path, json.dumps(dict(info.to_dict(), heartbeat=stamp),
                             sort_keys=True).encode())
        telemetry.gauge("fleet_replica_state",
                        replica=info.replica_id).set(
            float(_STATE_CODE[info.state]))
        return path

    def deregister(self, replica_id: str) -> bool:
        """Remove a replica's record (drain completion / shutdown);
        True when a record existed."""
        try:
            os.unlink(_record_path(self.root, replica_id))
        except FileNotFoundError:
            return False
        return True

    # -- read side -----------------------------------------------------
    def replicas(self, fresh_only: bool = False) -> List[ReplicaInfo]:
        """Every parseable record, sorted by id.  ``fresh_only`` drops
        records whose heartbeat is older than the freshness window —
        the router's definition of "exists"."""
        out: List[ReplicaInfo] = []
        now = time.time()
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in sorted(names):
            if not _REC_RE.match(name):
                continue
            try:
                with open(os.path.join(self.root, name), "rb") as f:
                    info = ReplicaInfo.from_dict(json.loads(f.read()))
            except FileNotFoundError:
                # unlinked between listdir and open (deregister racing
                # a scan): the member is simply gone, same treatment as
                # any other unreadable record
                telemetry.counter(
                    "fleet_membership_parse_errors_total").inc()
                continue
            except (OSError, ValueError, KeyError, TypeError):
                # torn/garbage record: a membership scan must never die
                # on one bad file
                telemetry.counter(
                    "fleet_membership_parse_errors_total").inc()
                continue
            if fresh_only and not info.fresh(self.heartbeat_timeout_s, now):
                continue
            out.append(info)
        counts: Dict[str, int] = {s: 0 for s in FLEET_STATES}
        for info in out:
            if info.state in counts and info.fresh(
                    self.heartbeat_timeout_s, now):
                counts[info.state] += 1
        for state, n in counts.items():
            telemetry.gauge("fleet_replicas_total", state=state).set(
                float(n))
        return out

    def get(self, replica_id: str) -> Optional[ReplicaInfo]:
        for info in self.replicas():
            if info.replica_id == replica_id:
                return info
        return None

    def leader(self) -> Optional[ReplicaInfo]:
        """The fresh leader record, if any — the one with the highest
        fencing epoch.

        During a failover there is a window where a deposed leader's
        still-fresh record coexists with the successor's: the epoch is
        the authority (the fence guarantees the higher epoch owns the
        WAL), with heartbeat recency only as a tiebreak for epoch-less
        legacy records.  Observing more than one fresh leader ticks
        ``fleet_leader_conflicts_total`` — a conflict the fence makes
        harmless but operators still want to see."""
        leaders = [r for r in self.replicas(fresh_only=True)
                   if r.role == "leader"]
        if not leaders:
            return None
        if len(leaders) > 1:
            telemetry.counter("fleet_leader_conflicts_total").inc()
        return max(leaders, key=lambda r: (r.epoch, r.heartbeat))

    def status(self) -> dict:
        """JSON view for ``/debug/fleet``."""
        now = time.time()
        return {
            "root": self.root,
            "heartbeat_timeout_s": self.heartbeat_timeout_s,
            "replicas": [
                dict(r.to_dict(),
                     fresh=r.fresh(self.heartbeat_timeout_s, now),
                     # quiverlint: ignore[QT012] -- heartbeat ages are
                     # cross-process, so wall clock is the only shared
                     # clock; freshness windows absorb small NTP steps
                     heartbeat_age_s=round(max(now - r.heartbeat, 0.0), 3))
                for r in self.replicas()
            ],
        }
