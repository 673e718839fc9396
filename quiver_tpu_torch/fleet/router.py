"""Partition-aware fleet router: hash, health-gate, dispatch, re-dispatch
(counterpart of ``quiver_tpu/fleet/router.py``).

The router is the thin tier in front of the replica fleet.  It holds no
graph state — only three views it can rebuild at any moment:

  * **membership** — the shared directory's fresh ``serving`` records
    (:class:`~quiver_tpu_torch.fleet.membership.MembershipDirectory`);
  * **health** — each replica's ``/healthz`` readiness document, polled
    on a cadence and cached, so a wedged process whose heartbeat file
    is still fresh ages out of routing anyway;
  * **breakers** — one :class:`~quiver_tpu_torch.resilience.breaker.
    CircuitBreaker` per replica, so a replica that eats requests
    (connect timeout, garbage reply) stops receiving them after
    ``failure_threshold`` strikes and is re-probed half-open.

With mesh-native sharded serving (docs/SHARDING.md) the routable unit
may be a *shard group*: N processes that together hold one logical
replica.  A complete, fully healthy group enters the ring as
``group:<gid>`` (breaker key ``fleet.group:<gid>``) and requests land
on its shard-0 coordinator; any missing or unhealthy member removes the
WHOLE group from the ring, so callers get a typed
:class:`NoReplicaAvailable` instead of a partial answer.

Placement is consistent hashing over *partitions*, not raw ids: the
partition of a request is ``ids[0] % config.fleet_partitions`` (the
locality-partition shape GNNSampler argues for — requests for the same
neighbourhood hit the same replica's warm caches), and the ring only
reshuffles ``1/N`` of partitions when a replica joins or leaves.  Hot
tenants (QoS class priority ≥ ``config.fleet_hot_priority``) use
power-of-two-choices between the partition's top two preference-list
replicas, trading a little cache affinity for not letting one replica
melt under a zipfian head key.

The failure contract is the fleet-wide version of "answered, never
dropped": a transport failure or an ``unavailable`` reply re-dispatches
the request to the next replica on the preference list (bounded by
``config.fleet_route_retries``, backoff between attempts); a typed
``shed`` reply is an **answer** and is returned as-is — retrying a shed
would defeat admission control.  When the budget is exhausted the
caller gets a typed :class:`~quiver_tpu_torch.resilience.errors.
NoReplicaAvailable`, and ``fleet_router_unroutable_total`` ticks.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence
from weakref import ref as weakref

from .. import telemetry
from ..resilience import chaos
from ..resilience.breaker import get_breaker
from ..resilience.errors import NoReplicaAvailable
from ..resilience.retry import Backoff
from ..telemetry import flightrec
from ..telemetry import timeline as _timeline
from .membership import (MembershipDirectory, ReplicaInfo, group_complete,
                         shard_groups)

__all__ = ["ConsistentHashRing", "FleetRouter", "fleet_status"]

log = logging.getLogger("quiver_tpu_torch.fleet")

_CHAOS_ROUTE = chaos.point("fleet.route")


def _hash(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Consistent hashing with virtual nodes.

    Deterministic across processes (blake2b, no PYTHONHASHSEED
    dependence): every router instance over the same membership set
    computes the same partition → replica preference lists.
    """

    def __init__(self, vnodes: Optional[int] = None):
        from ..config import get_config

        self.vnodes = int(vnodes if vnodes is not None
                          else get_config().fleet_vnodes)
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")
        self._members: tuple = ()
        self._points: List[int] = []
        self._owners: List[str] = []

    @property
    def members(self) -> tuple:
        return self._members

    def set_members(self, members: Sequence[str]) -> None:
        members = tuple(sorted(set(members)))
        if members == self._members:
            return
        ring = []
        for m in members:
            for v in range(self.vnodes):
                ring.append((_hash(f"{m}#{v}"), m))
        ring.sort()
        self._members = members
        self._points = [p for p, _ in ring]
        self._owners = [m for _, m in ring]

    def preference(self, key, n: Optional[int] = None) -> List[str]:
        """The first ``n`` *distinct* members clockwise of ``key`` —
        the dispatch order for that partition."""
        if not self._members:
            return []
        n = len(self._members) if n is None else min(n, len(self._members))
        i = bisect.bisect(self._points, _hash(str(key))) % len(self._points)
        out: List[str] = []
        for step in range(len(self._points)):
            owner = self._owners[(i + step) % len(self._points)]
            if owner not in out:
                out.append(owner)
                if len(out) >= n:
                    break
        return out


class FleetRouter:
    """Routes serving requests into the fleet; owns no graph state."""

    _guarded_by = {
        "_eligible": "_lock", "_health_ok": "_lock", "_inflight": "_lock",
        "_last_scan": "_lock", "_hops": "_lock", "_hop_ids": "_lock",
        "_groups": "_lock", "_write_path": "_lock",
    }

    def __init__(self, directory: MembershipDirectory,
                 partitions: Optional[int] = None,
                 vnodes: Optional[int] = None,
                 route_retries: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 hot_priority: Optional[int] = None,
                 health_poll_s: float = 0.25,
                 scan_ttl_s: float = 0.1,
                 backoff: Optional[Backoff] = None,
                 federation: Optional[bool] = None,
                 origin: Optional[str] = None):
        from ..config import get_config

        cfg = get_config()
        self.directory = directory
        self.partitions = int(partitions if partitions is not None
                              else cfg.fleet_partitions)
        self.route_retries = int(route_retries if route_retries is not None
                                 else cfg.fleet_route_retries)
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else cfg.fleet_request_timeout_s)
        self.hot_priority = int(hot_priority if hot_priority is not None
                                else cfg.fleet_hot_priority)
        self.health_poll_s = float(health_poll_s)
        self.scan_ttl_s = float(scan_ttl_s)
        self.backoff = backoff if backoff is not None else Backoff(
            base_s=0.005, cap_s=0.1, jitter=0.2)
        self.ring = ConsistentHashRing(vnodes)
        self._lock = threading.Lock()
        self._eligible: Dict[str, ReplicaInfo] = {}
        self._groups: Dict[str, List[ReplicaInfo]] = {}
        self._health_ok: Dict[str, bool] = {}
        self._inflight: Dict[str, int] = {}
        self._last_scan = 0.0
        self._write_path = None       # (leader_id, epoch) last resolved
        self._hp_stop = threading.Event()
        self._hp_thread: Optional[threading.Thread] = None
        # fleet observability plane (docs/OBSERVABILITY.md): the flag is
        # resolved ONCE here, so the off path costs exactly one
        # attribute read per request — no config lookup, no trace, no
        # payload stamp, no new metric keys
        self.federation_enabled = (
            bool(federation) if federation is not None
            else str(cfg.fleet_federation).lower()
            in ("on", "1", "true", "yes"))
        self.origin = str(origin) if origin else f"rtr-{os.getpid():x}"
        self.hop_capacity = max(int(cfg.fleet_trace_ring), 1)
        self._hops: Dict[str, dict] = {}
        self._hop_ids: List[str] = []
        self.federation = None
        if self.federation_enabled:
            from .federation import FleetFederation

            self.federation = FleetFederation(directory, router=self)
        _set_active(self)

    # -- fleet view ----------------------------------------------------
    def refresh(self, force: bool = False) -> None:
        """Re-scan membership (rate-limited by ``scan_ttl_s``) and
        rebuild the routable set: fresh + ``serving`` + health-gated +
        breaker-admitted candidates enter the hash ring."""
        now = time.monotonic()
        with self._lock:
            if not force and (now - self._last_scan) < self.scan_ttl_s:
                return
            self._last_scan = now
        fresh = {r.replica_id: r
                 for r in self.directory.replicas(fresh_only=True)
                 if r.state == "serving"}
        with self._lock:
            health = dict(self._health_ok)
        # shard groups (docs/SHARDING.md) route as ONE unit: a complete,
        # fully healthy group enters the ring as "group:<gid>" with its
        # shard-0 member as the dispatch coordinator; an incomplete or
        # partially unhealthy group takes NO traffic — one dead shard
        # makes the whole logical replica unavailable, never a partial
        # answer.  Whole-graph replicas still route as singletons.
        eligible = {rid: r for rid, r in fresh.items()
                    if r.shard_group is None and health.get(rid, True)}
        groups: Dict[str, List[ReplicaInfo]] = {}
        for gid, members in shard_groups(list(fresh.values())).items():
            telemetry.gauge("fleet_shard_group_members", group=gid).set(
                float(len(members)))
            if group_complete(members) and all(
                    health.get(m.replica_id, True) for m in members):
                groups[gid] = members
                eligible[f"group:{gid}"] = members[0]
        with self._lock:
            self._eligible = eligible
            self._groups = groups
        self.ring.set_members(eligible.keys())
        telemetry.gauge("fleet_router_eligible_total").set(
            float(len(eligible)))

    def _poll_health_once(self) -> None:
        # http.server stays out of library modules; the CLIENT
        # side (urllib) is fine and is how the router consumes the
        # ladder each replica's MetricsServer already sells
        import urllib.request

        with self._lock:
            infos = list(self._eligible.values())
            # group units carry only the coordinator in _eligible; poll
            # EVERY member so a wedged non-coordinator shard still takes
            # the whole group off the ring on the next refresh
            for members in self._groups.values():
                infos.extend(members)
            down = {rid for rid, ok in self._health_ok.items() if not ok}
        if down:
            # a member gated out by a failed dispatch or poll is polled
            # too (at the endpoint its fresh record names now), so one
            # that recovers, or rejoins under its id, routes again; JAX's
            # router polls only the eligible set and never re-admits it
            infos.extend(r for r in self.directory.replicas(fresh_only=True)
                         if r.replica_id in down and r.state == "serving")
        targets = sorted({(r.replica_id, r.host,
                           int(r.detail.get("metrics_port", 0)))
                          for r in infos})
        for rid, host, mport in targets:
            if mport <= 0:
                continue  # no health endpoint: membership state governs
            ok = False
            try:
                with urllib.request.urlopen(
                        f"http://{host}:{mport}/healthz",
                        timeout=self.request_timeout_s) as resp:
                    ok = resp.status == 200 and bool(
                        json.loads(resp.read()).get("ready"))
            except (OSError, ValueError):
                ok = False
            with self._lock:
                self._health_ok[rid] = ok

    def start_health_poller(self) -> "FleetRouter":
        """Background ``/healthz`` poll loop (optional — tests may call
        :meth:`_poll_health_once` deterministically instead)."""

        def _loop():
            while not self._hp_stop.wait(self.health_poll_s):
                try:
                    self._poll_health_once()
                except Exception as e:
                    # the poller must outlive flaky replicas; a failed
                    # sweep leaves the previous health view in place
                    log.warning("fleet health poll failed: %s", e)

        self._hp_stop.clear()
        self._hp_thread = threading.Thread(
            target=_loop, daemon=True, name="quiver-fleet-health")
        self._hp_thread.start()
        return self

    # -- write path (leader resolution) --------------------------------
    def write_path(self) -> Optional[ReplicaInfo]:
        """The current write endpoint: the fleet's fresh leader record,
        epoch-aware.

        Keyed by ``(leader_id, epoch)`` — when a fenced failover moves
        the epoch, the next call observes the change, ticks
        ``fleet_router_write_path_changes_total`` and hands back the
        successor, so writers re-resolve instead of appending at a
        deposed leader's endpoint (whose fence would refuse them
        anyway; this avoids even sending the bytes).  Returns None
        while no fresh leader exists (mid-failover window).  The metric
        is only created once a write path actually moves — a read-only
        fleet never grows a key."""
        leader = self.directory.leader()
        if leader is None:
            with self._lock:
                self._write_path = None
            return None
        key = (leader.replica_id, leader.epoch)
        with self._lock:
            prev = self._write_path
            self._write_path = key
        if prev is not None and prev != key:
            telemetry.counter(
                "fleet_router_write_path_changes_total").inc()
            log.warning("fleet write path moved: %s (epoch %d) -> %s "
                        "(epoch %d)", prev[0], prev[1], key[0], key[1])
        return leader

    # -- placement -----------------------------------------------------
    def partition_of(self, ids) -> int:
        try:
            first = int(ids[0])
        except (IndexError, TypeError, ValueError):
            first = 0
        return first % self.partitions

    def _is_hot(self, tenant: Optional[str]) -> bool:
        if tenant is None:
            return False
        from ..resilience.qos import get_qos

        controller = get_qos()
        if controller is None:
            return False
        klass = controller.resolve(tenant)
        return klass is not None and klass.priority >= self.hot_priority

    def candidates(self, partition: int,
                   tenant: Optional[str] = None) -> List[str]:
        """Dispatch order for a partition.  Hot tenants use power-of-
        two-choices between the top two preferred replicas (least
        in-flight wins) so a zipfian head key cannot melt one replica;
        everyone else gets plain preference order (cache affinity)."""
        prefs = self.ring.preference(partition)
        if len(prefs) >= 2 and self._is_hot(tenant):
            with self._lock:
                a, b = (self._inflight.get(prefs[0], 0),
                        self._inflight.get(prefs[1], 0))
            if b < a:
                prefs[0], prefs[1] = prefs[1], prefs[0]
        return prefs

    # -- dispatch ------------------------------------------------------
    def request(self, ids, tenant: Optional[str] = None,
                seq: Optional[int] = None,
                sleep: Callable[[float], None] = time.sleep) -> dict:
        """Route one serving request; returns the replica's reply dict.

        Transport failures and ``unavailable`` replies re-dispatch to
        the next candidate (bounded); ``ok``/``shed``/``error`` replies
        are answers and return immediately.  Raises
        :class:`NoReplicaAvailable` when the budget is exhausted —
        never returns silence.
        """
        _CHAOS_ROUTE()
        self.refresh()
        partition = self.partition_of(ids)
        prefs = self.candidates(partition, tenant)
        budget = 1 + max(self.route_retries, 0)
        req = {"ids": list(map(int, ids)), "tenant": tenant}
        if seq is not None:
            req["seq"] = seq
        ctx = hop = None
        if self.federation_enabled:
            ctx, hop = self._trace_begin(req, tenant, partition)
        attempts = 0
        tried: set = set()
        try:
            for attempt in range(budget):
                if attempt >= 1:
                    # the fleet may have changed under us (that is the
                    # point of re-dispatch) — rebuild the candidate
                    # list, but never hand the request back to a
                    # replica that already refused it: "unavailable"
                    # keeps the replica eligible (honest refusal, not a
                    # health strike), so without the exclusion the
                    # recomputed preference order re-picks the same
                    # replica instead of the NEXT one
                    self.refresh(force=True)
                    prefs = [p for p
                             in self.candidates(partition, tenant)
                             if p not in tried]
                target = self._pick(prefs)
                if target is None:
                    break
                attempts += 1
                tried.add(target)
                t_attempt = time.perf_counter()
                reply = self._dispatch(target, req)
                if hop is not None:
                    self._hop_attempt(hop, ctx, target, t_attempt, reply)
                if reply is not None:
                    telemetry.counter("fleet_router_requests_total",
                                      replica=target,
                                      status=reply.get("status",
                                                       "ok")).inc()
                    if hop is not None:
                        hop["status"] = reply.get("status", "ok")
                    return reply
                # transport-level failure: the request is still ours to
                # answer — re-dispatch after a short breather
                telemetry.counter("fleet_router_redispatch_total",
                                  replica=target).inc()
                prefs = [p for p in prefs if p != target]
                if attempt + 1 < budget:
                    sleep(self.backoff.delay(attempt))
            telemetry.counter("fleet_router_unroutable_total").inc()
            raise NoReplicaAvailable(partition, attempts)
        finally:
            if hop is not None:
                self._trace_finish(hop, ctx)

    def _pick(self, prefs: List[str]) -> Optional[str]:
        for rid in prefs:
            if get_breaker(f"fleet.{rid}").allow():
                return rid
        return None

    def _dispatch(self, replica_id: str, req: dict) -> Optional[dict]:
        """One attempt against one replica.  Returns the reply dict, or
        None for a transport-level failure / ``unavailable`` (both mean
        "try another replica")."""
        with self._lock:
            info = self._eligible.get(replica_id)
            self._inflight[replica_id] = \
                self._inflight.get(replica_id, 0) + 1
        breaker = get_breaker(f"fleet.{replica_id}")
        try:
            if info is None:
                raise OSError(f"replica {replica_id} left the fleet")
            with socket.create_connection(
                    (info.host, info.port),
                    timeout=self.request_timeout_s) as conn:
                conn.sendall((json.dumps(req) + "\n").encode())
                with conn.makefile("rb") as f:
                    line = f.readline()
            if not line:
                raise OSError(f"replica {replica_id} closed mid-request")
            reply = json.loads(line)
            if reply.get("status") == "unavailable":
                # honest refusal (booting/draining): not a strike worth
                # a full breaker trip, but not an answer either
                breaker.record_failure()
                return None
            breaker.record_success()
            return reply
        except (OSError, ValueError):
            breaker.record_failure()
            with self._lock:
                self._health_ok[replica_id] = False
            return None
        finally:
            with self._lock:
                self._inflight[replica_id] -= 1

    # -- cross-process tracing (only reached with federation on) -------
    def _priority(self, tenant: Optional[str]) -> int:
        if tenant is None:
            return 0
        from ..resilience.qos import get_qos

        controller = get_qos()
        if controller is None:
            return 0
        klass = controller.resolve(tenant)
        return int(klass.priority) if klass is not None else 0

    def _trace_begin(self, req: dict, tenant: Optional[str],
                     partition: int):
        """Stamp the active TraceContext into the wire payload and open
        a hop record.  The trace_id is fleet-qualified in place
        (``<origin>:<local>``) so the router-side record, the replica's
        rehydrated record, and every timeline event join on ONE id and
        per-process ``_next_trace_id`` sequences never collide."""
        ctx = flightrec.current()
        if ctx is None:
            ctx = flightrec.new_trace()
        if ctx is None:  # telemetry disabled: nothing to propagate
            return None, None
        if ":" not in ctx.trace_id:
            ctx.trace_id = f"{self.origin}:{ctx.trace_id}"
        trace = {"trace_id": ctx.trace_id, "origin": self.origin,
                 "tenant": tenant, "priority": self._priority(tenant)}
        deadline = self._deadline_remaining()
        if deadline is not None:
            # ship the REMAINING budget, not the absolute deadline —
            # perf_counter epochs are per-process; the replica
            # re-anchors it on its own clock
            trace["deadline_s"] = deadline
        req["trace"] = trace
        hop = {"trace_id": ctx.trace_id, "origin": self.origin,
               "partition": partition, "tenant": tenant,
               "priority": trace["priority"],
               "wall_start": time.time(),
               "t_start": time.perf_counter(),
               "attempts": [], "status": "unroutable"}
        ctx.add("fleet.route", {"partition": partition,
                                "router": self.origin})
        return ctx, hop

    @staticmethod
    def _deadline_remaining() -> Optional[float]:
        from ..resilience.deadline import ambient_deadline

        deadline = ambient_deadline()
        if deadline is None:
            return None
        return max(deadline - time.perf_counter(), 0.0)

    def _hop_attempt(self, hop: dict, ctx, target: str,
                     t_attempt: float, reply: Optional[dict]) -> None:
        dt = time.perf_counter() - t_attempt
        outcome = ("redispatch" if reply is None
                   else reply.get("status", "ok"))
        hop["attempts"].append({
            "replica": target, "outcome": outcome,
            "t_offset_s": round(t_attempt - hop["t_start"], 6),
            "seconds": round(dt, 6),
        })
        ctx.add("fleet.dispatch", {"replica": target, "outcome": outcome,
                                   "seconds": dt})
        if _timeline._ON:  # one global read when the timeline is off
            _timeline.emit("fleet.dispatch", cat="fleet", dur_s=dt,
                           t0=t_attempt,
                           attrs={"replica": target, "outcome": outcome},
                           trace=ctx)

    def _trace_finish(self, hop: dict, ctx) -> None:
        e2e = time.perf_counter() - hop["t_start"]
        hop["e2e_seconds"] = round(e2e, 6)
        if _timeline._ON:  # one global read when the timeline is off
            _timeline.emit("fleet.route", cat="fleet", dur_s=e2e,
                           t0=hop["t_start"],
                           attrs={"partition": hop["partition"],
                                  "status": hop["status"],
                                  "attempts": len(hop["attempts"])},
                           trace=ctx)
        with self._lock:
            while len(self._hop_ids) >= self.hop_capacity:
                self._hops.pop(self._hop_ids.pop(0), None)
            if hop["trace_id"] not in self._hops:
                self._hop_ids.append(hop["trace_id"])
            self._hops[hop["trace_id"]] = hop

    def hop_record(self, trace_id: str) -> Optional[dict]:
        """The router-side record for one fleet trace_id (what
        ``/debug/fleet/trace/<id>`` joins with the replica's flight
        record), or None when it aged out of the ring."""
        with self._lock:
            hop = self._hops.get(trace_id)
            return dict(hop) if hop is not None else None

    def hop_records(self, limit: int = 50) -> List[dict]:
        """The newest retained hop records, oldest first."""
        with self._lock:
            ids = self._hop_ids[-max(int(limit), 0):]
            return [dict(self._hops[i]) for i in ids if i in self._hops]

    def hop_count(self) -> int:
        with self._lock:
            return len(self._hop_ids)

    # -- introspection -------------------------------------------------
    def status(self) -> dict:
        """JSON view for ``/debug/fleet``."""
        from ..resilience.breaker import breakers_status

        with self._lock:
            eligible = sorted(self._eligible)
            inflight = dict(self._inflight)
            health = dict(self._health_ok)
            groups = {gid: [m.replica_id for m in members]
                      for gid, members in self._groups.items()}
        return {
            "partitions": self.partitions,
            "shard_groups": groups,
            "route_retries": self.route_retries,
            "federation": self.federation_enabled,
            "origin": self.origin,
            "hop_records": self.hop_count(),
            "eligible": eligible,
            "ring_members": list(self.ring.members),
            "inflight": inflight,
            "health_ok": health,
            "breakers": {name: st for name, st in
                         breakers_status().items()
                         if name.startswith("fleet.")},
            "membership": self.directory.status(),
        }

    def start_federation(self) -> "FleetRouter":
        """Start the federation's background sweep (no-op with
        federation off; tests may call
        ``router.federation.scrape_once()`` deterministically
        instead)."""
        if self.federation is not None:
            self.federation.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self._hp_stop.set()
        if self._hp_thread is not None:
            join_and_reap([self._hp_thread], timeout,
                          component="fleet.route")
            self._hp_thread = None
        if self.federation is not None:
            self.federation.stop(timeout)
            self.federation = None
        _clear_active(self)


# -- /debug/fleet plumbing (weakref, same pattern as recovery.manager) --
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[Callable] = None


def _set_active(router: FleetRouter) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = weakref(router)


def _clear_active(router: FleetRouter) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE() is router:
            _ACTIVE = None


def fleet_status() -> dict:
    """Status of the most recently constructed router in this process
    (the ``/debug/fleet`` document); ``{"active": False}`` when none."""
    with _ACTIVE_LOCK:
        router = _ACTIVE() if _ACTIVE is not None else None
    if router is None:
        return {"active": False}
    return dict(router.status(), active=True)
