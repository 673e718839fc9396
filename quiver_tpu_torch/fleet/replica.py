"""Fleet replica lifecycle: warm join, serve, drain, rejoin (counterpart
of ``quiver_tpu/fleet/replica.py``).

One :class:`FleetReplica` is one serving process in the fleet.  Two
roles share the same lifecycle and differ only in how state arrives:

  * **leader** (exactly one) — owns the WAL.  Boots through
    :class:`~quiver_tpu_torch.recovery.manager.RecoveryManager` (checkpoint
    restore + tail replay), attaches an
    :class:`~quiver_tpu_torch.stream.ingest.IngestLane` so every write is
    durable-before-ack, and runs the periodic checkpointer that lets
    followers resync and the log truncate.
  * **follower** (N) — read replica.  Restores the newest *shared*
    checkpoint, then tails the leader's WAL through
    :class:`~quiver_tpu_torch.fleet.shipping.WALFollower`; never opens the
    log for writing.

Both climb the same readiness ladder the single-node tier defined
(``booting → replaying → warming → serving``) and announce every rung
into the shared :class:`~quiver_tpu_torch.fleet.membership.
MembershipDirectory`, so the router's view of "who can take traffic"
is the same contract ``/healthz`` sells.  The join path IS the warm-boot
path: with ``config.recovery_cache_dir`` set, a joining replica makes
that directory the build directory of its kernel and native libraries
before building anything (the port's counterpart of a persistent
compilation cache: a library found there built is loaded, not
compiled, and counted in ``registry_persistent_cache_hits_total``),
runs its warmup against them, and can ``seal`` its program registry —
a rejoin that builds is a loud budget violation, not a silent p99
cliff.

The port's replica takes ``device=``: the card by default, where its
graph (a restored checkpoint, or the leader's ``RecoveryManager``
boot) is placed; tests pass ``device="cpu"``.

Serving transport is a deliberately small TCP JSON-lines protocol
(stdlib ``socketserver``; the metrics/health HTTP endpoint stays in
``telemetry.export``): one JSON object per line in, one per line out,
multiple requests per connection.  Answers are ``status: ok``, a typed
``shed`` (still an *answer* — the router never re-dispatches it), or
``unavailable`` (booting/draining — the router treats it as a
transport failure and re-dispatches).  Drain is explicit: announce
``draining``, refuse new admissions, finish in-flight requests,
deregister, stop — the inverse of join, and chaos-tested on the card by
``chip_smoke.py``'s fleet phase.
"""

from __future__ import annotations

import json
import logging
import os
import socketserver
import threading
import time
from typing import Callable, Optional

from .. import telemetry
from ..recovery.checkpoint import load_checkpoint, restore_graph
from ..recovery.errors import RecoveryError
from ..resilience import chaos
from ..resilience.errors import (ChaosFault, DeadlineExceeded, LoadShed,
                                 QuotaExceeded)
from ..telemetry import flightrec
from .membership import FLEET_STATES, MembershipDirectory, ReplicaInfo
from .shipping import WALFollower

__all__ = ["FleetReplica"]

log = logging.getLogger("quiver_tpu_torch.fleet")

_CHAOS_JOIN = chaos.point("fleet.join")
# fires inside the serving handler after trace rehydration: an injected
# fault models a replica that accepted the connection but cannot answer
# (honest `unavailable`, the router re-dispatches) — how the fleet-chaos
# harness proves one trace_id lands on two replica timelines
_CHAOS_SERVE = chaos.point("fleet.serve")

# typed sheds cross the wire as answers; everything else is an error
_SHED_TYPES = (LoadShed, DeadlineExceeded, QuotaExceeded)


class _ReplicaTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FleetReplica:
    """One fleet member: boot → announce → serve → drain/stop."""

    _guarded_by = {
        "_state": "_lock", "_stale": "_lock", "_inflight": "_lock",
        "_draining": "_lock", "_boot_seconds": "_lock",
        "manager": "_lock", "graph": "_lock", "follower": "_lock",
        "_server": "_lock", "metrics_server": "_lock", "epoch": "_lock",
        "role": "_lock", "walstream_server": "_lock",
    }

    def __init__(self, replica_id: str, fleet_dir: Optional[str] = None,
                 root: Optional[str] = None,
                 graph_factory: Optional[Callable] = None,
                 role: str = "follower", host: str = "127.0.0.1",
                 port: int = 0,
                 service_fn: Optional[Callable] = None,
                 heartbeat_s: Optional[float] = None,
                 warmup: Optional[Callable] = None, seal: bool = False,
                 catchup_timeout_s: float = 30.0,
                 shard_group: Optional[str] = None,
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None, device=None):
        from ..config import get_config

        cfg = get_config()
        if role not in ("leader", "follower"):
            raise ValueError(f"role must be leader|follower, got {role!r}")
        self.replica_id = str(replica_id)
        self.role = role
        fleet_dir = str(fleet_dir if fleet_dir is not None
                        else cfg.fleet_dir)
        if not fleet_dir:
            raise RecoveryError(
                "no fleet directory: pass fleet_dir= or set "
                "QUIVER_TPU_FLEET_DIR / config.fleet_dir")
        root = str(root if root is not None else cfg.recovery_dir)
        if not root:
            raise RecoveryError(
                "no durability root: pass root= or set "
                "QUIVER_TPU_RECOVERY_DIR / config.recovery_dir")
        self.root = root
        self.wal_dir = os.path.join(root, "wal")
        self.ckpt_dir = os.path.join(root, "ckpt")
        self.directory = MembershipDirectory(fleet_dir)
        self.graph_factory = graph_factory
        self.device = device
        self.host = host
        self._requested_port = int(port)
        self.service_fn = service_fn
        self.warmup = warmup
        self.seal = bool(seal)
        self.catchup_timeout_s = float(catchup_timeout_s)
        self.heartbeat_s = float(heartbeat_s if heartbeat_s is not None
                                 else cfg.fleet_heartbeat_s)
        # mesh shard-group membership (docs/SHARDING.md): defaults come
        # from the mesh_* config knobs so every member of a sharded
        # launch announces the same group without per-process plumbing;
        # unsharded replicas (no group) announce exactly as before
        self.shard_group = str(shard_group if shard_group is not None
                               else cfg.mesh_group)
        self.shard_index = int(shard_index if shard_index is not None
                               else cfg.mesh_shard_index)
        self.shard_count = int(shard_count if shard_count is not None
                               else cfg.mesh_shards)
        self.graph = None
        self.manager = None           # leader only (RecoveryManager)
        self.lane = None              # leader only (IngestLane)
        self.follower = None          # follower only (TailFollower)
        self.metrics_server = None
        # fleet-autonomy flags resolved ONCE at construction: the off
        # path must stay byte-identical — no election/walstream import,
        # no extra threads, no new metric keys
        self._election_enabled = str(cfg.fleet_election).lower() in (
            "on", "1", "true", "yes")
        self._walstream_enabled = str(cfg.fleet_walstream).lower() in (
            "on", "1", "true", "yes")
        self.elector = None           # LeaderElector when election is on
        self.fence = None             # EpochFence while leading, fenced
        self.epoch = -1               # the fencing epoch currently held
        self.walstream_server = None  # WALStreamServer while leading
        self._lock = threading.Lock()
        self._state = "booting"
        self._stale = True
        self._inflight = 0
        self._draining = False
        self._boot_seconds: Optional[float] = None
        self._server: Optional[_ReplicaTCPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- readiness ladder ---------------------------------------------
    def _set_state(self, state: str, stale: Optional[bool] = None) -> None:
        assert state in FLEET_STATES
        with self._lock:
            self._state = state
            if stale is not None:
                self._stale = stale
        self._announce()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def health(self) -> dict:
        """Per-replica ``/healthz`` document (instance-scoped, NOT the
        process-global recovery view — N replicas on one host each
        report their own ladder)."""
        with self._lock:
            state, stale = self._state, self._stale
        out = {
            "replica_id": self.replica_id,
            "role": self.role,
            "state": state,
            "ready": state == "serving",
            "stale": stale,
            "managed": True,
        }
        if self.graph is not None:
            out["graph_version"] = int(self.graph.version)
        if self._boot_seconds is not None:
            out["boot_seconds"] = round(self._boot_seconds, 3)
        if self.follower is not None:
            st = self.follower.status()
            out["staleness_lsn"] = st["staleness_lsn"]
            out["staleness_seconds"] = st["staleness_seconds"]
            out["applied_lsn"] = st["applied_lsn"]
        if self.manager is not None and self.manager.wal is not None:
            out["wal_next_lsn"] = self.manager.wal.next_lsn
        return out

    # -- boot ----------------------------------------------------------
    def boot(self) -> "FleetReplica":
        """Join the fleet: warm-boot state, reach ``serving``, open the
        TCP endpoint, start heartbeats."""
        _CHAOS_JOIN()
        t0 = time.perf_counter()
        if self.role == "leader":
            self._boot_leader()
        else:
            self._boot_follower()
        self._start_server()
        boot_seconds = time.perf_counter() - t0
        with self._lock:
            self._boot_seconds = boot_seconds
        telemetry.gauge("fleet_join_seconds",
                        replica=self.replica_id).set(boot_seconds)
        self._set_state("serving", stale=False)
        self._start_heartbeat()
        if self._election_enabled:
            # leaders already claimed in _boot_leader; followers get a
            # fresh elector.  The loop watches for leader death
            # (followers) and deposition (leaders) from here on.
            if self.elector is None:
                self.elector = self._make_elector()
            self.elector.start()
        return self

    def _boot_leader(self) -> None:
        from ..recovery.manager import RecoveryManager
        from ..stream import IngestLane

        self._set_state("booting", stale=True)
        with self._lock:
            self.manager = RecoveryManager(
                self.root, graph_factory=self.graph_factory,
                device=self.device)
        with self._lock:
            self.graph = self.manager.boot_degraded()
        self._set_state("replaying", stale=True)
        self.manager.finish_boot(warmup=self.warmup, seal=self.seal)
        if self._election_enabled:
            # claim an epoch BEFORE the first fenced append: a booting
            # configured leader outranks any dead predecessor's claim
            self.elector = self._make_elector()
            self._install_fence(self.elector.claim_initial())
        self.lane = IngestLane(self.graph).start()
        self.manager.attach_lane(self.lane)
        if self._walstream_enabled:
            self._start_walstream()
        self._set_state("warming", stale=False)

    def _boot_follower(self) -> None:
        from ..config import get_config

        cfg = get_config()
        self._set_state("booting", stale=True)
        if cfg.recovery_cache_dir:
            # the warm-boot path IS the fleet join path: the kernel and
            # native libraries come off the shared build cache, not nvcc
            from ..recovery.registry import get_program_registry

            get_program_registry().enable_persistent_cache(
                cfg.recovery_cache_dir)
        start_lsn = self._restore_from_checkpoint()
        self._set_state("replaying", stale=True)
        self._start_follower(start_lsn)
        self._await_catchup()
        self._set_state("warming", stale=False)
        if self.warmup is not None:
            self.warmup(self.graph)
        if self.seal:
            from ..recovery.registry import get_program_registry

            get_program_registry().seal()

    def _start_follower(self, start_lsn: int) -> None:
        """Start the WAL tail — file tail over the shared directory, or
        the socket tail when ``fleet_walstream`` is on (no shared WAL
        filesystem required; the endpoint is re-resolved from membership
        on every reconnect, so a failover moves the tail by itself)."""
        if self._walstream_enabled:
            from .walstream import WALStreamFollower

            follower = WALStreamFollower(
                self._walstream_endpoint, apply_fn=self._apply_shipped,
                start_lsn=start_lsn,
                resync_fn=self._resync_from_checkpoint,
                name=self.replica_id)
        else:
            follower = WALFollower(
                self.wal_dir, apply_fn=self._apply_shipped,
                start_lsn=start_lsn,
                resync_fn=self._resync_from_checkpoint,
                name=self.replica_id)
        with self._lock:
            self.follower = follower.start()

    def _walstream_endpoint(self):
        """The current leader's stream endpoint per membership, or None
        while there is no fresh leader (the follower just re-polls)."""
        leader = self.directory.leader()
        if leader is None:
            return None
        port = leader.detail.get("walstream_port")
        if not port:
            return None
        return (leader.host, int(port))

    def _restore_from_checkpoint(self) -> int:
        """Restore the newest shared checkpoint into ``self.graph``;
        returns its WAL watermark (-1 for a fresh factory graph)."""
        ckpt = load_checkpoint(self.ckpt_dir)
        if ckpt is not None:
            with self._lock:
                self.graph = restore_graph(ckpt, device=self.device)
            log.info("replica %s restored checkpoint %s (version %d, "
                     "watermark %d)", self.replica_id, ckpt.path,
                     ckpt.graph_version, ckpt.wal_lsn)
            return ckpt.wal_lsn
        if self.graph_factory is None:
            raise RecoveryError(
                f"no checkpoint under {self.ckpt_dir} and no "
                "graph_factory to build a fresh follower graph from")
        with self._lock:
            self.graph = self.graph_factory()
        return -1

    def _resync_from_checkpoint(self) -> int:
        """WALFollower strand handler: rebuild follower state from the
        newest shared checkpoint; returns the next LSN to tail from."""
        watermark = self._restore_from_checkpoint()
        return watermark + 1

    def _apply_shipped(self, lsn: int, op, src, dst, ts) -> None:
        from ..stream.compactor import compact

        graph = self.graph
        if op == "add":
            try:
                graph.add_edges(src, dst, ts if graph.has_ts else None)
            except BufferError:
                compact(graph)
                graph.add_edges(src, dst, ts if graph.has_ts else None)
        elif op == "remove":
            graph.remove_edges(src, dst)

    def _await_catchup(self) -> None:
        """Block until the follower has folded in everything visible
        (staleness 0) — the join equivalent of ``finish_boot`` replay."""
        deadline = time.monotonic() + self.catchup_timeout_s
        while time.monotonic() < deadline:
            st = self.follower.status()
            if st["records"] >= 0 and st["staleness_lsn"] == 0 \
                    and st["last_error"] is None:
                # one caught-up observation after at least one poll ran
                return
            time.sleep(min(self.follower.poll_interval_s, 0.05))
        raise RecoveryError(
            f"replica {self.replica_id} not caught up within "
            f"{self.catchup_timeout_s}s: {self.follower.status()}")

    # -- election / failover ------------------------------------------
    def _applied_lsn(self) -> int:
        """Candidacy currency: the newest LSN this replica has folded in
        (followers: the tail's commit cursor; leaders: the append
        frontier)."""
        follower = self.follower
        if follower is not None:
            return int(follower.applied_lsn)
        manager = self.manager
        if manager is not None and manager.wal is not None:
            return int(manager.wal.next_lsn) - 1
        return -1

    def _make_elector(self):
        from .election import LeaderElector

        return LeaderElector(
            self.directory, self.replica_id,
            applied_lsn_fn=self._applied_lsn,
            role_fn=lambda: self.role,
            promote_fn=self._promote, demote_fn=self._step_down)

    def _install_fence(self, claim) -> None:
        """Wrap the manager's WAL in the epoch fence — every append /
        roll / truncate from here on carries the claimed epoch, and a
        deposed write raises before a byte lands."""
        from .election import EpochFence, FencedWAL

        self.fence = EpochFence(self.elector.election_dir, claim.epoch,
                                self.replica_id)
        # quiverlint: ignore[QT008] -- atomic reference publish: the
        # heartbeat thread only reads
        # `.next_lsn`, which both the raw WAL and the FencedWAL wrapper
        # (delegating __getattr__) answer identically; the checkpointer of
        # this manager starts only after this call (happens-before via
        # Thread.start)
        self.manager.wal = FencedWAL(self.manager.wal, self.fence)
        with self._lock:
            self.epoch = int(claim.epoch)

    def _start_walstream(self) -> None:
        from .walstream import WALStreamServer

        server = WALStreamServer(
            self.wal_dir, host=self.host, name=self.replica_id,
            fence=self.fence)
        with self._lock:
            self.walstream_server = server

    def _promote(self, claim) -> None:
        """Election won (elector thread): adopt the WAL this replica has
        been tailing and become the leader.  The follower's holdback
        semantics carry straight through — its commit cursor is the
        adopt watermark, so a record it was still holding back is folded
        (or aborted) by the manager's two-pass replay, never twice."""
        from ..recovery.manager import RecoveryManager
        from ..stream import IngestLane

        log.warning("replica %s promoting to leader (epoch %d)",
                    self.replica_id, claim.epoch)
        follower = self.follower
        applied = -1
        if follower is not None:
            follower.stop()
            applied = int(follower.applied_lsn)
            with self._lock:
                self.follower = None
        with self._lock:
            self.role = "leader"
        manager = RecoveryManager(self.root,
                                  graph_factory=self.graph_factory,
                                  device=self.device)
        manager.adopt(self.graph, applied)
        with self._lock:
            # adopt may have fallen back to a checkpoint boot (late
            # abort across the failover) and built a fresh graph
            self.manager = manager
            self.graph = manager.graph
        self._install_fence(claim)
        self.lane = IngestLane(self.graph).start()
        manager.attach_lane(self.lane)
        manager.start_checkpointer()
        if self._walstream_enabled:
            self._start_walstream()
        self._announce()

    def _step_down(self, claim) -> None:
        """Deposed (elector thread): a higher epoch exists.  Stop every
        write-side component — the fence already refuses appends, this
        makes the stop graceful — and rejoin as a follower of the new
        leader from the exact frontier this process reached."""
        log.warning("replica %s deposed by %s (epoch %d); rejoining as "
                    "follower", self.replica_id, claim.leader_id,
                    claim.epoch)
        telemetry.counter("fleet_election_demotions_total",
                          replica=self.replica_id).inc()
        if self.walstream_server is not None:
            self.walstream_server.stop()
            with self._lock:
                self.walstream_server = None
        if self.lane is not None:
            self.lane.stop()
            self.lane = None
        manager = self.manager
        applied = -1
        if manager is not None:
            if manager.wal is not None:
                applied = int(manager.wal.next_lsn) - 1
            manager.close()
            with self._lock:
                self.manager = None
        self.fence = None
        with self._lock:
            self.role = "follower"
            self.epoch = -1
        self._start_follower(applied)
        self._announce()

    # -- serving endpoint ---------------------------------------------
    def _start_server(self) -> None:
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    resp = outer._serve_line(line)
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode())

        with self._lock:
            self._server = _ReplicaTCPServer(
                (self.host, self._requested_port), _Handler)
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"quiver-fleet-replica-{self.replica_id}")
        self._server_thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def _serve_line(self, line: bytes) -> dict:
        t_recv = time.perf_counter()
        try:
            req = json.loads(line)
        except ValueError:
            telemetry.counter("fleet_replica_requests_total",
                              status="unparsable").inc()
            return {"status": "error", "error": "BadRequest",
                    "reason": "unparsable request line"}
        tctx = self._rehydrate(req.get("trace"))
        with self._lock:
            admitted = self._state == "serving" and not self._draining
            if admitted:
                self._inflight += 1
        if not admitted:
            self._finish_trace(tctx, time.perf_counter() - t_recv,
                               "unavailable")
            return {"status": "unavailable", "state": self.state,
                    "replica": self.replica_id}
        t0 = time.perf_counter()
        try:
            with flightrec.activate(tctx):
                if tctx is not None:
                    # the admission gap is the replica-side queue span
                    flightrec.event("replica.queue",
                                    {"seconds": t0 - t_recv})
                _CHAOS_SERVE()
                out = self._deadline_service(req, t0)
                out.setdefault("status", "ok")
        except ChaosFault as e:
            # injected serve fault: accepted the connection, cannot
            # answer — honest refusal, the router re-dispatches
            out = {"status": "unavailable", "state": self.state,
                   "error": type(e).__name__}
        except _SHED_TYPES as e:
            # a typed shed is an ANSWER — the router must not retry it
            out = {"status": "shed", "error": type(e).__name__,
                   "reason": str(e)}
        except Exception as e:
            out = {"status": "error", "error": type(e).__name__,
                   "reason": str(e)}
        finally:
            with self._lock:
                self._inflight -= 1
        e2e = time.perf_counter() - t0
        status = out.get("status", "ok")
        if status in ("ok", "shed", "error"):
            telemetry.counter("fleet_replica_requests_total",
                              status=status).inc()
            telemetry.histogram(
                "fleet_replica_request_seconds").observe(e2e)
        self._finish_trace(tctx, e2e, status)
        out["replica"] = self.replica_id
        out["latency_ms"] = round(e2e * 1e3, 3)
        if tctx is not None:
            out["trace_id"] = tctx.trace_id
        if "seq" in req:
            out["seq"] = req["seq"]
        return out

    def _deadline_service(self, req: dict, t0: float) -> dict:
        """Run the service under the request's shipped deadline budget
        (re-anchored on THIS process's perf_counter — absolute
        deadlines do not survive the hop, remaining seconds do)."""
        trace = req.get("trace")
        deadline_s = (trace.get("deadline_s")
                      if isinstance(trace, dict) else None)
        if deadline_s is None:
            return self._service(req.get("ids", ()), req.get("tenant"))
        from ..resilience.deadline import check_ambient, deadline_scope

        with deadline_scope(t0 + float(deadline_s), t0):
            check_ambient("fleet")  # dead on arrival → typed shed
            return self._service(req.get("ids", ()), req.get("tenant"))

    def _rehydrate(self, trace):
        """Adopt the router-stamped TraceContext, so replica-side stage
        events join the fleet-wide trace_id.  The id arrives already
        origin-qualified (``<origin>:<local>``), which keeps it
        disjoint from this process's own ``<pid>-<seq>`` ids.  Costs
        nothing when no trace rides the payload."""
        if not isinstance(trace, dict):
            return None
        tid = trace.get("trace_id")
        if not tid:
            return None
        tctx = flightrec.new_trace(trace_id=str(tid))
        if tctx is None:  # telemetry disabled in this process
            return None
        tenant = trace.get("tenant")
        if tenant is not None:
            tctx.tenant = str(tenant)
        # fleet-dispatched requests are always retained (the recorder
        # ring is bounded): /debug/fleet/trace/<id> must find the
        # replica-side record, not just the slow/errored tail
        tctx.flag()
        return tctx

    def _finish_trace(self, tctx, e2e: float, status: str) -> None:
        if tctx is None:
            return
        flightrec.get_recorder().finish(tctx, e2e, status=status,
                                        lane="fleet")

    def _service(self, ids, tenant) -> dict:
        if self.service_fn is not None:
            return dict(self.service_fn(ids, tenant))
        # default service: a versioned read touch — enough for routing,
        # membership, and chaos proofs; real deployments pass a
        # service_fn that drives their sampler/feature pipeline
        return {"n": len(ids),
                "version": int(self.graph.version)
                if self.graph is not None else -1}

    # -- metrics / health endpoint ------------------------------------
    def expose_metrics(self, port: int = 0):
        """Per-replica ``/metrics`` + ``/healthz`` on an ephemeral port
        (N replicas on one host never collide)."""
        # local import: telemetry.export pulls in http.server
        from ..telemetry.export import MetricsServer

        server = MetricsServer(port=port, health_fn=self.health)
        with self._lock:
            self.metrics_server = server
        return server

    # -- membership / heartbeat ---------------------------------------
    def _info(self) -> ReplicaInfo:
        health = self.health()
        detail = {"metrics_port":
                  self.metrics_server.port if self.metrics_server
                  else 0,
                  # perf_counter↔wall pair stamped back-to-back at
                  # announce time: the federation's clock-offset
                  # estimator aligns per-replica timelines from the
                  # heartbeat stream of these (federation.py)
                  "clock_perf": time.perf_counter(),
                  "clock_wall": time.time()}
        if self.shard_group:
            detail["shard_group"] = self.shard_group
            detail["shard_index"] = self.shard_index
            detail["shard_count"] = self.shard_count
        if self.walstream_server is not None:
            detail["walstream_port"] = self.walstream_server.port
        wal_next = int(health.get("wal_next_lsn", -1))
        if wal_next < 0 and "applied_lsn" in health:
            # followers publish their fold frontier too — it is the
            # candidacy currency the election ranks promotions by
            wal_next = int(health["applied_lsn"]) + 1
        with self._lock:
            epoch = self.epoch
        return ReplicaInfo(
            replica_id=self.replica_id, state=self.state, host=self.host,
            port=self.port, role=self.role, pid=os.getpid(),
            staleness_lsn=int(health.get("staleness_lsn", 0)),
            staleness_seconds=float(health.get("staleness_seconds", 0.0)),
            wal_next_lsn=wal_next, epoch=epoch,
            detail=detail,
        )

    def _announce(self) -> None:
        try:
            self.directory.announce(self._info())
        except OSError as e:
            # a missed heartbeat ages us out of routing; log, don't die
            log.warning("replica %s announce failed: %s",
                        self.replica_id, e)

    def _start_heartbeat(self) -> None:
        self._hb_stop.clear()

        def _beat():
            while not self._hb_stop.wait(self.heartbeat_s):
                self._announce()

        self._hb_thread = threading.Thread(
            target=_beat, daemon=True,
            name=f"quiver-fleet-hb-{self.replica_id}")
        self._hb_thread.start()

    # -- drain / stop --------------------------------------------------
    def drain(self, timeout: float = 30.0) -> None:
        """Graceful exit: stop admitting, finish in-flight, deregister.

        After drain the replica can :meth:`stop` (full shutdown) — or a
        fresh process can rejoin under the same id (warm, through the
        shared caches)."""
        with self._lock:
            self._draining = True
        self._set_state("draining")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        # stop heartbeating BEFORE deregistering: a beat landing after
        # the unlink would resurrect the record as a ghost member
        self._hb_stop.set()
        self.directory.deregister(self.replica_id)

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        if self.elector is not None:
            self.elector.stop(timeout)
            self.elector = None
        if self.walstream_server is not None:
            self.walstream_server.stop(timeout)
            with self._lock:
                self.walstream_server = None
        self._hb_stop.set()
        threads = []
        if self._hb_thread is not None:
            threads.append(self._hb_thread)
            self._hb_thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                threads.append(self._server_thread)
                self._server_thread = None
            with self._lock:
                self._server = None
        if threads:
            join_and_reap(threads, timeout, component="fleet.replica")
        if self.follower is not None:
            self.follower.stop(timeout)
        if self.lane is not None:
            self.lane.stop(timeout)
            self.lane = None
        if self.manager is not None:
            self.manager.close()
            with self._lock:
                self.manager = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            with self._lock:
                self.metrics_server = None
        self.directory.deregister(self.replica_id)
