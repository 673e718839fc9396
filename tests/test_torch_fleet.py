"""Port parity: ``quiver_tpu_torch.fleet`` (membership, WAL shipping,
the router, the replica, the federation's parsers) against the JAX
package's ``tests/test_fleet.py`` and against the JAX objects.

* **JAX's cases** — every case of ``tests/test_fleet.py`` runs against
  the port under its JAX name, with graphs and replicas on the CPU
  (``device="cpu"``); the slow harness case is the port's own: real
  replica processes, one killed with ``kill -9`` mid-burst.
* **Shard groups** — JAX's ``TestShardGroups`` and
  ``TestShardGroupServing`` (``tests/test_mesh.py``) against the port.
* **Parity** — the ring places members as JAX's does; a membership
  record written by either package reads back equal in the other; a
  follower of each package over the same WAL segments (an abort, a torn
  tail) applies the same ``(lsn, op, src, dst, ts)``; the federation's
  parsers, merge, exposition and clock offsets are equal on the same
  inputs.
* **The slice as a whole** — a leader + follower fleet of each package
  on a small streaming graph serves GraphSAGE through its router: after
  the same inserts through the leader's lane and follower catch-up, the
  sampled ``n_id`` is bitwise equal, logits within ``1e-5`` and the
  graph versions equal.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from quiver_tpu import config as jconfig
from quiver_tpu import telemetry as jtel
from quiver_tpu.fleet import federation as jfed
from quiver_tpu.fleet import membership as jmembership
from quiver_tpu.fleet import router as jrouter
from quiver_tpu.fleet import shipping as jshipping
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.resilience.breaker import reset as jbreakers_reset
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import timeline as jtimeline

from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry
from quiver_tpu_torch.fleet import (FLEET_STATES, ConsistentHashRing,
                                    FleetReplica, FleetRouter,
                                    MembershipDirectory, ReplicaInfo,
                                    WALFollower, fleet_status)
from quiver_tpu_torch.fleet import federation as pfed
from quiver_tpu_torch.recovery import blockio
from quiver_tpu_torch.recovery.errors import WALError
from quiver_tpu_torch.recovery.wal import (WriteAheadLog, encode_abort,
                                           encode_edge_op)
from quiver_tpu_torch.resilience import chaos
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.resilience.breaker import reset as breakers_reset
from quiver_tpu_torch.resilience.errors import (ChaosFault, LoadShed,
                                                NoReplicaAvailable)
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.telemetry import flightrec
from quiver_tpu_torch.telemetry import timeline
from quiver_tpu_torch.telemetry.registry import metric_key
from quiver_tpu_torch.utils.topology import CSRTopo

REPO = Path(__file__).resolve().parents[1]
_JAX_TELEMETRY_DEFAULT = jtel.enabled()

pytestmark = pytest.mark.fleet

N_NODES = 64


def _topo():
    src = np.arange(N_NODES, dtype=np.int64)
    dst = (src + 1) % N_NODES
    return CSRTopo(edge_index=np.stack([src, dst]))


def _graph():
    return StreamingGraph(_topo(), delta_capacity=4096, device="cpu")


def counter_value(name, **labels):
    return telemetry.snapshot()["counters"].get(
        metric_key(name, labels), 0)


def gauge_value(name, **labels):
    return telemetry.snapshot()["gauges"].get(metric_key(name, labels))


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' registries, chaos plans, QoS, breakers, flight
    recorders and timelines start and end clean; JAX's telemetry is on
    for the test and back at its process default after."""
    for tel, ch, rec, qos, tl in ((telemetry, chaos, flightrec, pqos,
                                   timeline),
                                  (jtel, jchaos, jflightrec, jqos,
                                   jtimeline)):
        tel.set_enabled(True)
        tel.reset()
        ch.uninstall()
        rec.reset()
        qos.reset()
        tl.disable()
        tl.reset()
    yield
    for tel, ch, rec, qos, tl in ((telemetry, chaos, flightrec, pqos,
                                   timeline),
                                  (jtel, jchaos, jflightrec, jqos,
                                   jtimeline)):
        ch.uninstall()
        rec.reset()
        qos.reset()
        tl.disable()
        tl.reset()
        tl.set_fleet_trace_provider(None)
        tel.reset()
    breakers_reset()
    jbreakers_reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


# ------------------------------------------------------------- ring
class TestConsistentHashRing:
    def test_deterministic_across_instances(self):
        a, b = ConsistentHashRing(vnodes=32), ConsistentHashRing(vnodes=32)
        a.set_members(["r0", "r1", "r2"])
        b.set_members(["r2", "r0", "r1"])  # order must not matter
        for p in range(32):
            assert a.preference(p) == b.preference(p)

    def test_preference_walk_distinct_and_complete(self):
        r = ConsistentHashRing(vnodes=16)
        r.set_members(["a", "b", "c"])
        for p in range(16):
            prefs = r.preference(p)
            assert sorted(prefs) == ["a", "b", "c"]
            assert len(set(prefs)) == 3
        assert r.preference(0, n=2) == r.preference(0)[:2]

    def test_member_change_reshuffles_partially(self):
        r = ConsistentHashRing(vnodes=64)
        r.set_members(["a", "b", "c"])
        before = {p: r.preference(p, 1)[0] for p in range(256)}
        r.set_members(["a", "b", "c", "d"])
        after = {p: r.preference(p, 1)[0] for p in range(256)}
        moved = sum(1 for p in before if after[p] != before[p])
        # consistent hashing: only partitions adopted by the new member
        # move — everything that moved must have moved TO d, and the
        # move fraction stays near 1/N, never a full reshuffle
        assert all(after[p] == "d" for p in before if after[p] != before[p])
        assert 0 < moved < 128

    def test_empty_ring(self):
        assert ConsistentHashRing(vnodes=4).preference(0) == []


# ------------------------------------------------------- membership
class TestMembership:
    def test_announce_scan_deregister(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=5.0)
        d.announce(ReplicaInfo("r0", state="serving", port=1234,
                               role="leader"))
        d.announce(ReplicaInfo("r1", state="booting", port=1235))
        got = d.replicas()
        assert [r.replica_id for r in got] == ["r0", "r1"]
        assert d.get("r0").port == 1234
        assert d.leader().replica_id == "r0"
        assert d.deregister("r1") is True
        assert d.deregister("r1") is False
        assert [r.replica_id for r in d.replicas()] == ["r0"]

    def test_freshness_window(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=0.05)
        d.announce(ReplicaInfo("r0", state="serving"))
        assert [r.replica_id for r in d.replicas(fresh_only=True)] \
            == ["r0"]
        time.sleep(0.1)
        assert d.replicas(fresh_only=True) == []
        # stale records remain visible to operators
        assert [r.replica_id for r in d.replicas()] == ["r0"]
        assert gauge_value("fleet_replicas_total", state="serving") == 0.0

    def test_garbage_record_skipped_not_fatal(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=5.0)
        d.announce(ReplicaInfo("r0", state="serving"))
        (tmp_path / "replica-torn.json").write_bytes(b'{"repl')
        before = counter_value("fleet_membership_parse_errors_total")
        assert [r.replica_id for r in d.replicas()] == ["r0"]
        assert counter_value(
            "fleet_membership_parse_errors_total") == before + 1

    def test_unknown_state_rejected(self, tmp_path):
        d = MembershipDirectory(tmp_path)
        with pytest.raises(ValueError, match="unknown fleet state"):
            d.announce(ReplicaInfo("r0", state="zombie"))

    def test_states_ladder(self):
        assert FLEET_STATES == ("booting", "replaying", "warming",
                                "serving", "draining")

    def test_status_document(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=5.0)
        d.announce(ReplicaInfo("r0", state="serving"))
        doc = d.status()
        assert doc["replicas"][0]["fresh"] is True
        assert doc["replicas"][0]["heartbeat_age_s"] >= 0.0


# ----------------------------------------------------- WAL follower
class _Tail:
    """Follower-side sink recording every applied record."""

    def __init__(self):
        self.applied = []

    def __call__(self, lsn, op, src, dst, ts):
        self.applied.append((lsn, op, list(map(int, src)),
                             list(map(int, dst))))


def _follower(wal_dir, tail, **kw):
    kw.setdefault("grace_s", 30.0)  # holdback resolves via successors
    kw.setdefault("name", "t")
    return WALFollower(str(wal_dir), apply_fn=tail, **kw)


class TestWALFollower:
    def test_ships_committed_records(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        for i in range(5):
            w.append(encode_edge_op("add", [i], [i + 1]))
        tail = _Tail()
        f = _follower(tmp_path / "wal", tail)
        f.poll_once()
        # newest record held back (abort holdback), 4 committed
        assert [lsn for lsn, *_ in tail.applied] == [0, 1, 2, 3]
        assert f.status()["staleness_lsn"] == 1
        w.append(encode_edge_op("add", [9], [10]))
        f.poll_once()  # successor slot proves no abort for lsn 4
        assert [lsn for lsn, *_ in tail.applied] == [0, 1, 2, 3, 4]
        w.close()

    def test_grace_expiry_commits_tail(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        w.append(encode_edge_op("add", [1], [2]))
        tail = _Tail()
        f = _follower(tmp_path / "wal", tail, grace_s=0.02)
        f.poll_once()
        assert tail.applied == []  # inside the grace window
        time.sleep(0.05)
        f.poll_once()
        assert [lsn for lsn, *_ in tail.applied] == [0]
        assert f.status()["staleness_lsn"] == 0
        w.close()

    def test_abort_holdback_skips_aborted_record(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        w.append(encode_edge_op("add", [1], [2]))      # lsn 0: commits
        w.append(encode_edge_op("add", [3], [4]))      # lsn 1: aborted
        w.append(encode_abort(1))                      # lsn 2
        w.append(encode_edge_op("add", [5], [6]))      # lsn 3: commits
        w.append(encode_edge_op("add", [7], [8]))      # lsn 4: successor
        tail = _Tail()
        before = counter_value("fleet_ship_aborted_total", replica="t")
        f = _follower(tmp_path / "wal", tail)
        f.poll_once()
        assert [lsn for lsn, *_ in tail.applied] == [0, 3]
        assert counter_value("fleet_ship_aborted_total",
                             replica="t") == before + 1
        assert f.applied_lsn == 3  # lsn 4 held pending a successor
        w.close()

    def test_late_abort_triggers_resync(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        w.append(encode_edge_op("add", [1], [2]))      # lsn 0
        tail = _Tail()
        resyncs = []

        def resync():
            # a real resync_fn restores the newest checkpoint; here the
            # checkpoint "covers" both records, so resume past them
            resyncs.append(True)
            return 2

        f = _follower(tmp_path / "wal", tail, grace_s=0.0,
                      resync_fn=resync)
        f.poll_once()  # grace 0: lsn 0 commits immediately
        assert [lsn for lsn, *_ in tail.applied] == [0]
        w.append(encode_abort(0))                      # late abort
        before = counter_value("fleet_ship_late_aborts_total",
                               replica="t")
        f.poll_once()
        assert resyncs == [True]
        assert counter_value("fleet_ship_late_aborts_total",
                             replica="t") == before + 1
        assert f.applied_lsn == 1  # resumed at the resync watermark
        w.close()

    def test_torn_tail_waits_instead_of_erroring(self, tmp_path):
        """Satellite: a torn tail is a write in progress — the follower
        must keep its offset and re-poll, never raise or misframe."""
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        w.append(encode_edge_op("add", [1], [2]))
        w.append(encode_edge_op("add", [3], [4]))
        seg = os.path.join(str(tmp_path / "wal"),
                           sorted(os.listdir(tmp_path / "wal"))[0])
        # frame the next record out-of-band and append only half of it:
        # exactly what a reader racing the leader's write() observes
        buf = io.BytesIO()
        blockio.write_record(buf, encode_edge_op("add", [5], [6]))
        frame = buf.getvalue()
        with open(seg, "ab") as fh:
            fh.write(frame[:len(frame) // 2])
        tail = _Tail()
        f = _follower(tmp_path / "wal", tail)
        before = counter_value("fleet_ship_torn_waits_total", replica="t")
        f.poll_once()
        f.poll_once()  # still torn: waits again, no error, no re-count
        assert [lsn for lsn, *_ in tail.applied] == [0]  # lsn 1 held
        assert counter_value("fleet_ship_torn_waits_total",
                             replica="t") == before + 1
        assert f.status()["last_error"] is None
        with open(seg, "ab") as fh:  # the leader finishes its write
            fh.write(frame[len(frame) // 2:])
        f.poll_once()
        assert [lsn for lsn, *_ in tail.applied] == [0, 1]
        w.close()

    def test_opens_mid_segment_rotation(self, tmp_path):
        """Satellite: a follower whose start watermark lands inside a
        sealed middle segment repositions correctly and ships across
        the rotation boundary."""
        w = WriteAheadLog(tmp_path / "wal", fsync="always",
                          segment_bytes=1)  # roll after every record
        for i in range(6):
            w.append(encode_edge_op("add", [i], [i + 1]))
        assert len(os.listdir(tmp_path / "wal")) > 1
        tail = _Tail()
        f = _follower(tmp_path / "wal", tail, start_lsn=2)
        f.poll_once()
        assert [lsn for lsn, *_ in tail.applied] == [3, 4]  # 5 held
        w.append(encode_edge_op("add", [9], [9]))
        f.poll_once()
        assert [lsn for lsn, *_ in tail.applied] == [3, 4, 5]
        w.close()

    def test_truncate_through_resyncs_not_strands(self, tmp_path):
        """Satellite: leader checkpoint + ``truncate_through`` deletes
        segments a lagging follower needed — it must resync from the
        checkpoint watermark, not strand or silently skip."""
        w = WriteAheadLog(tmp_path / "wal", fsync="always",
                          segment_bytes=1)
        for i in range(6):
            w.append(encode_edge_op("add", [i], [i + 1]))
        # barrier checkpoint covered lsns 0..3; the log drops them
        w.truncate_through(3)
        tail = _Tail()
        resyncs = []

        def resync():
            resyncs.append(True)
            return 4  # checkpoint watermark + 1

        f = _follower(tmp_path / "wal", tail, start_lsn=-1,
                      resync_fn=resync)
        before = counter_value("fleet_ship_resyncs_total", replica="t")
        f.poll_once()
        assert resyncs == [True]
        assert counter_value("fleet_ship_resyncs_total",
                             replica="t") == before + 1
        assert [lsn for lsn, *_ in tail.applied] == [4]  # 5 held
        assert f.status()["resyncs"] == 1
        # without a resync_fn the same situation is a loud error
        f2 = _follower(tmp_path / "wal", _Tail(), start_lsn=-1)
        with pytest.raises(WALError, match="stranded"):
            f2.poll_once()
        w.close()

    def test_staleness_gauges_published(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")
        w.append(encode_edge_op("add", [1], [2]))
        f = _follower(tmp_path / "wal", _Tail(), name="stale-t")
        f.poll_once()
        assert gauge_value("fleet_replica_staleness_lsn",
                           replica="stale-t") == 1.0
        assert gauge_value("fleet_replica_staleness_seconds",
                           replica="stale-t") >= 0.0
        w.append(encode_edge_op("add", [3], [4]))
        w.append(encode_edge_op("add", [5], [6]))
        time.sleep(0.0)
        f.poll_once()
        assert f.status()["applied_lsn"] == 1
        w.close()

    def test_thread_loop_survives_apply_errors(self, tmp_path):
        w = WriteAheadLog(tmp_path / "wal", fsync="always")

        def bad_apply(*a):
            raise RuntimeError("apply exploded")

        w.append(encode_edge_op("add", [1], [2]))
        w.append(encode_edge_op("add", [3], [4]))
        f = WALFollower(str(tmp_path / "wal"), apply_fn=bad_apply,
                        grace_s=0.0, poll_interval_s=0.01,
                        name="bad").start()
        deadline = time.time() + 5
        while time.time() < deadline and \
                f.status()["last_error"] is None:
            time.sleep(0.01)
        assert "apply exploded" in (f.status()["last_error"] or "")
        assert f.is_running()
        f.stop()
        assert not f.is_running()
        w.close()


# ------------------------------------------- replica + router (e2e)
@pytest.fixture
def fleet(tmp_path):
    """One in-process leader + one follower over a shared root, plus a
    router; tears everything down in reverse order."""
    root = str(tmp_path / "dur")
    fdir = str(tmp_path / "fleet")
    members = []

    def spawn(rid, role, **kw):
        rep = FleetReplica(rid, fleet_dir=fdir, root=root,
                           graph_factory=_graph, role=role,
                           heartbeat_s=0.1, device="cpu", **kw).boot()
        members.append(rep)
        return rep

    directory = MembershipDirectory(fdir, heartbeat_timeout_s=2.0)
    routers = []

    def make_router(**kw):
        kw.setdefault("scan_ttl_s", 0.0)
        kw.setdefault("request_timeout_s", 1.0)
        r = FleetRouter(directory, **kw)
        routers.append(r)
        return r

    with pconfig.override(fleet_ship_poll_ms=10.0, fleet_ship_grace_ms=60.0):
        yield type("F", (), {"spawn": staticmethod(spawn),
                             "router": staticmethod(make_router),
                             "directory": directory, "root": root,
                             "fleet_dir": fdir, "members": members})
        for r in routers:
            r.close()
        for rep in reversed(members):
            rep.stop()


def _ingest(leader, n, start=0):
    for i in range(start, start + n):
        leader.lane.submit([i % N_NODES], [(i * 7 + 3) % N_NODES])
    for _ in range(n):
        _u, res = leader.lane.results.get(timeout=10)
        assert not isinstance(res, Exception), res


class TestFleetEndToEnd:
    def test_join_ladder_and_replication(self, fleet):
        leader = fleet.spawn("r0", "leader")
        _ingest(leader, 10)
        leader.manager.checkpoint(timeout=10)
        follower = fleet.spawn("r1", "follower")
        assert follower.state == "serving"
        assert follower.graph.version == leader.graph.version
        # live shipping: new leader writes reach the follower
        _ingest(leader, 10, start=10)
        deadline = time.time() + 10
        while time.time() < deadline and \
                follower.graph.version != leader.graph.version:
            time.sleep(0.02)
        assert follower.graph.version == leader.graph.version
        assert gauge_value("fleet_join_seconds", replica="r1") > 0.0
        info = fleet.directory.get("r1")
        assert info.state == "serving" and info.role == "follower"

    def test_two_replicas_metrics_coexist_one_host(self, fleet):
        """Satellite: two replicas' /healthz + /metrics must coexist on
        one host via ephemeral ports, each reporting ITS OWN ladder."""
        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        follower = fleet.spawn("r1", "follower")
        m0, m1 = leader.expose_metrics(), follower.expose_metrics()
        assert m0.port != m1.port and m0.port > 0 and m1.port > 0
        docs = {}
        for port in (m0.port, m1.port):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                doc = json.loads(r.read())
                docs[doc["replica_id"]] = doc
                assert r.status == 200
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                assert r.status == 200
        assert docs["r0"]["role"] == "leader"
        assert docs["r1"]["role"] == "follower"
        assert "staleness_lsn" in docs["r1"]

    def test_router_routes_and_debug_fleet(self, fleet):
        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        fleet.spawn("r1", "follower")
        router = fleet.router()
        for i in range(20):
            reply = router.request([i, i + 1], seq=i)
            assert reply["status"] == "ok"
            assert reply["seq"] == i
            assert reply["replica"] in ("r0", "r1")
        served = {rid: counter_value("fleet_router_requests_total",
                                     replica=rid, status="ok")
                  for rid in ("r0", "r1")}
        assert sum(served.values()) >= 20
        doc = fleet_status()
        assert doc["active"] is True
        assert sorted(doc["eligible"]) == ["r0", "r1"]
        ms = leader.expose_metrics()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ms.port}/debug/fleet",
                timeout=5) as r:
            served_doc = json.loads(r.read())
        assert served_doc["active"] is True
        assert served_doc["membership"]["replicas"]

    def test_dead_replica_redispatch_zero_lost(self, fleet):
        """A replica that vanishes without drain: its requests must be
        re-dispatched and answered, never lost."""
        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        follower = fleet.spawn("r1", "follower")
        # wide partition space so the 2-member ring gives r1 ownership
        # of some partitions (8 partitions can all land on one member)
        router = fleet.router(partitions=64)
        # hard-stop the follower's endpoint WITHOUT deregistering —
        # membership still says serving, exactly like a kill -9
        follower._server.shutdown()
        follower._server.server_close()
        answered = 0
        for i in range(32):
            reply = router.request([i], seq=i)
            assert reply["status"] == "ok"
            assert reply["replica"] == "r0"
            answered += 1
        assert answered == 32
        redis = counter_value("fleet_router_redispatch_total",
                              replica="r1")
        assert redis > 0

    def test_shed_is_an_answer_not_a_retry(self, fleet):
        def shedding_service(ids, tenant):
            raise LoadShed("saturated", lane="test")

        leader = fleet.spawn("r0", "leader",
                             service_fn=shedding_service)
        router = fleet.router()
        before = counter_value("fleet_router_redispatch_total",
                               replica="r0")
        reply = router.request([1])
        assert reply["status"] == "shed"
        assert reply["error"] == "LoadShed"
        # a typed shed is final — no re-dispatch happened for it
        assert counter_value("fleet_router_redispatch_total",
                             replica="r0") == before

    def test_empty_fleet_is_typed_answer(self, fleet):
        router = fleet.router(route_retries=1)
        with pytest.raises(NoReplicaAvailable):
            router.request([1])
        assert counter_value("fleet_router_unroutable_total") >= 1

    def test_drain_stops_admission_then_deregisters(self, fleet):
        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        follower = fleet.spawn("r1", "follower")
        assert fleet.directory.get("r1") is not None
        follower.drain(timeout=5)
        assert follower.state == "draining"
        assert fleet.directory.get("r1") is None
        # direct dispatch to a draining replica is an honest refusal
        with socket.create_connection(("127.0.0.1", follower.port),
                                      timeout=5) as conn:
            conn.sendall(b'{"ids": [1]}\n')
            with conn.makefile("rb") as fh:
                reply = json.loads(fh.readline())
        assert reply["status"] == "unavailable"
        # the router no longer sees it
        router = fleet.router()
        for i in range(8):
            assert router.request([i])["replica"] == "r0"

    def test_chaos_point_route_fires_from_seeded_plan(self, fleet):
        leader = fleet.spawn("r0", "leader")
        router = fleet.router()
        assert router.request([1])["status"] == "ok"
        chaos.install(chaos.ChaosPlan(seed=7).fail(
            "fleet.route", exc=ChaosFault("fleet.route", 0), times=1))
        with pytest.raises(ChaosFault):
            router.request([2])
        # deterministic: the plan spent its single shot
        assert router.request([3])["status"] == "ok"


class TestRouterReadmission:
    def test_router_readmits_a_replica_that_recovers(self, fleet):
        """A replica gated out by a failed dispatch is polled again and
        routes once its ``/healthz`` answers ready; JAX's router polls
        only its eligible set, so it never routes to that replica again
        (ROADMAP §C)."""
        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        follower = fleet.spawn("r1", "follower")
        for rep in (leader, follower):
            rep.expose_metrics()
        deadline = time.time() + 10
        while time.time() < deadline and not all(
                fleet.directory.get(r).detail.get("metrics_port")
                for r in ("r0", "r1")):
            time.sleep(0.02)
        jdir = jmembership.MembershipDirectory(fleet.fleet_dir,
                                               heartbeat_timeout_s=2.0)
        members = {}
        for name, router in (("port", fleet.router(partitions=64)),
                             ("jax", jrouter.FleetRouter(
                                 jdir, scan_ttl_s=0.0,
                                 request_timeout_s=1.0))):
            try:
                router.refresh(force=True)
                assert sorted(router.ring.members) == ["r0", "r1"]
                with router._lock:   # as a failed dispatch leaves it
                    router._health_ok["r1"] = False
                router.refresh(force=True)
                assert router.ring.members == ("r0",)
                router._poll_health_once()
                router.refresh(force=True)
                members[name] = router.ring.members
            finally:
                if name == "jax":
                    router.close()
        assert members == {"port": ("r0", "r1"), "jax": ("r0",)}


# ------------------------------------------------- failover harness
# one child program serves both roles (the port only, on the CPU): the
# leader seeds and checkpoints the shared root, then ingests; followers
# join through the checkpoint and the WAL tail; each prints one ready
# line and serves until killed or until its stop file appears
_REPLICA_CHILD = r"""
import json, os, sys, time
import numpy as np
from quiver_tpu_torch import GraphSageSampler
from quiver_tpu_torch.fleet import FleetReplica
from quiver_tpu_torch.recovery.registry import get_program_registry
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.utils.topology import CSRTopo

root, fleet_dir, rid, role = sys.argv[1:5]
N = 64

def factory():
    src = np.arange(N, dtype=np.int64)
    return StreamingGraph(CSRTopo(edge_index=np.stack([src, (src + 1) % N])),
                          delta_capacity=65536, device="cpu")

held = {}

def warmup(graph):
    held["sampler"] = GraphSageSampler(graph, [3, 2], device="cpu",
                                       gather_mode="xla")
    held["sampler"].sample(np.arange(8))
    held["graph"] = graph

def service(ids, tenant):
    held["sampler"].sample(np.arange(8))
    return {"n": len(ids), "version": int(held["graph"].version)}

t0 = time.perf_counter()
rep = FleetReplica(rid, fleet_dir=fleet_dir, root=root, graph_factory=factory,
                   role=role, warmup=warmup, seal=True, service_fn=service,
                   device="cpu").boot()
rep.expose_metrics()
if role == "leader":
    for i in range(64):
        rep.lane.submit([i % N], [(i * 7 + 3) % N])
    for _ in range(64):
        _u, res = rep.lane.results.get(timeout=30)
        assert not isinstance(res, Exception), res
    rep.manager.checkpoint(timeout=30)
reg = get_program_registry()
print(json.dumps({"ready": True, "boot_seconds": time.perf_counter() - t0,
                  "pcache_hits": reg.persistent_cache_hits}), flush=True)
stop = os.path.join(fleet_dir, "stop-" + rid)
i = 64
while not os.path.exists(stop):
    if rep.role == "leader":
        rep.lane.submit([i % N], [(i * 7 + 3) % N])
        rep.lane.results.get(timeout=30)
        i += 1
    time.sleep(0.02)
rep.stop()
"""


def _spawn(tmp, rid, role):
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1",
               QUIVER_TPU_RECOVERY_CACHE_DIR=str(tmp / "cache"),
               QUIVER_TPU_FLEET_SHIP_POLL_MS="10",
               QUIVER_TPU_FLEET_SHIP_GRACE_MS="60",
               QUIVER_TPU_FLEET_HEARTBEAT_S="0.2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPLICA_CHILD, str(tmp / "dur"),
         str(tmp / "fleet"), rid, role], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for line in proc.stdout:
        doc = json.loads(line)
        if doc.get("ready"):
            return proc, doc
    raise AssertionError(f"replica {rid} died during boot")


@pytest.mark.slow
class TestFleetChaosHarness:
    def test_smoke_report_contract(self, tmp_path):
        """The port's counterpart of JAX's harness: three real replica
        processes (the port only), ``kill -9`` of a follower mid-burst,
        zero lost answers in every phase, and a warm rejoin through the
        shared build cache with its staleness back under the bound."""
        (tmp_path / "cache").mkdir()
        procs = {}
        directory = MembershipDirectory(str(tmp_path / "fleet"),
                                        heartbeat_timeout_s=2.0)
        router = None
        try:
            procs["r0"], _ = _spawn(tmp_path, "r0", "leader")
            for rid in ("r1", "r2"):
                procs[rid], _ = _spawn(tmp_path, rid, "follower")
            router = FleetRouter(directory, partitions=64, scan_ttl_s=0.05,
                                 request_timeout_s=2.0).start_health_poller()
            router.refresh(force=True)
            rng = np.random.default_rng(0)
            phases = {}
            for phase, count in (("baseline", 100), ("burst", 200)):
                counts = dict(offered=0, ok=0, shed=0, error=0,
                              unroutable=0, unanswered=0)
                for i in range(count):
                    if phase == "burst" and i == count // 3:
                        os.kill(procs["r2"].pid, signal.SIGKILL)
                        assert procs["r2"].wait(timeout=30) == -9
                    counts["offered"] += 1
                    try:
                        reply = router.request(
                            [int(rng.integers(64)), 1], seq=i)
                        st = reply.get("status", "error")
                        counts[st if st in ("ok", "shed") else "error"] += 1
                    except NoReplicaAvailable:
                        counts["unroutable"] += 1
                    except Exception:  # noqa: BLE001 -- a lost answer
                        counts["unanswered"] += 1
                phases[phase] = counts
            assert counter_value("fleet_router_redispatch_total",
                                 replica="r2") > 0
            procs["r2"], rejoin = _spawn(tmp_path, "r2", "follower")
            assert rejoin["pcache_hits"] > 0
            bound = pconfig.get_config().fleet_max_staleness_lsn
            deadline = time.time() + 30
            while time.time() < deadline:
                info = directory.get("r2")
                if info is not None and info.staleness_lsn <= bound:
                    break
                time.sleep(0.05)
            assert info.staleness_lsn <= bound
            for p in phases.values():
                assert p["offered"] == p["ok"] + p["shed"] + p["error"] \
                    + p["unroutable"]
                assert p["unanswered"] == 0 and p["error"] == 0
        finally:
            if router is not None:
                router.close()
            for rid, proc in procs.items():
                if proc.poll() is None:
                    (tmp_path / "fleet" / f"stop-{rid}").touch()
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=30)
                proc.stdout.close()


# ------------------------------------------- fleet autonomy satellites
class TestMembershipAutonomy:
    def test_leader_epoch_wins_and_conflict_counted(self, tmp_path):
        """Split-brain window: a deposed leader's still-fresh record
        must lose to the successor's higher epoch, and the overlap must
        be observable."""
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=5.0)
        d.announce(ReplicaInfo("old", state="serving", role="leader",
                               epoch=3))
        d.announce(ReplicaInfo("new", state="serving", role="leader",
                               epoch=4))
        before = counter_value("fleet_leader_conflicts_total")
        leader = d.leader()
        assert leader.replica_id == "new"
        assert counter_value("fleet_leader_conflicts_total") == before + 1
        # single fresh leader: no conflict tick
        d.deregister("old")
        mid = counter_value("fleet_leader_conflicts_total")
        assert d.leader().replica_id == "new"
        assert counter_value("fleet_leader_conflicts_total") == mid

    def test_epoch_roundtrip_and_legacy_default(self):
        info = ReplicaInfo("r0", epoch=7)
        assert ReplicaInfo.from_dict(info.to_dict()).epoch == 7
        legacy = info.to_dict()
        legacy.pop("epoch")  # a record from a pre-election build
        assert ReplicaInfo.from_dict(legacy).epoch == -1

    def test_record_unlinked_between_listdir_and_open(self, tmp_path,
                                                      monkeypatch):
        """Satellite: a record deregistered between the directory scan's
        listdir and its open must be skipped and counted, never fatal."""
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=5.0)
        d.announce(ReplicaInfo("real", state="serving"))
        real_listdir = os.listdir

        def ghost_listdir(path):
            return list(real_listdir(path)) + ["replica-ghost.json"]

        monkeypatch.setattr(os, "listdir", ghost_listdir)
        before = counter_value("fleet_membership_parse_errors_total")
        out = d.replicas()
        assert [r.replica_id for r in out] == ["real"]
        assert counter_value(
            "fleet_membership_parse_errors_total") == before + 1


class TestFleetAutonomySatellites:
    def test_draining_healthz_is_503_with_state(self, fleet):
        """Satellite: /healthz during drain answers 503 with the
        draining state in the body, so load balancers depool while
        operators still see a live, finishing process."""
        import urllib.error

        leader = fleet.spawn("r0", "leader")
        srv = leader.expose_metrics()
        leader.drain(timeout=5)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5)
        assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert body["state"] == "draining"
        assert body["ready"] is False

    def test_simultaneous_join_and_drain_consistent(self, fleet):
        """Satellite: a join stretched across a concurrent drain leaves
        router eligibility and ring membership consistent — the joiner
        in, the drained member out, nothing half-present."""
        import threading

        leader = fleet.spawn("r0", "leader")
        leader.manager.checkpoint(timeout=10)
        f1 = fleet.spawn("r1", "follower")
        router = fleet.router()
        router.refresh(force=True)
        assert sorted(router.ring.members) == ["r0", "r1"]
        # stretch r2's join window across r1's drain
        chaos.install(chaos.ChaosPlan(seed=3).delay(
            "fleet.join", delay_s=0.3, times=1))
        joined = {}

        def join():
            joined["rep"] = fleet.spawn("r2", "follower")

        t = threading.Thread(target=join)
        t.start()
        f1.drain(timeout=5)
        t.join(timeout=30)
        assert "rep" in joined and joined["rep"].state == "serving"
        assert fleet.directory.get("r1") is None
        router.refresh(force=True)
        assert sorted(router.ring.members) == ["r0", "r2"]
        with router._lock:
            eligible = sorted(router._eligible)
        assert eligible == ["r0", "r2"]
        for i in range(8):
            assert router.request([i])["replica"] in ("r0", "r2")


# ------------------------------------------------------ shard groups
class TestShardGroups:
    """JAX's ``tests/test_mesh.py::TestShardGroups`` against the port."""

    def _info(self, rid, gid=None, idx=0, count=0, state="serving"):
        detail = {}
        if gid is not None:
            detail = {"shard_group": gid, "shard_index": idx,
                      "shard_count": count}
        return ReplicaInfo(replica_id=rid, state=state,
                           heartbeat=time.time(), detail=detail)

    def test_grouping_and_completeness(self):
        from quiver_tpu_torch.fleet.membership import (group_complete,
                                                       shard_groups)

        infos = [self._info("b", "g1", 1, 2), self._info("a", "g1", 0, 2),
                 self._info("solo")]
        groups = shard_groups(infos)
        assert list(groups) == ["g1"]
        assert [m.replica_id for m in groups["g1"]] == ["a", "b"]
        assert group_complete(groups["g1"])
        # half-booted, duplicated, or disagreeing groups never route
        assert not group_complete([self._info("a", "g1", 0, 2)])
        assert not group_complete([self._info("a", "g1", 0, 2),
                                   self._info("b", "g1", 0, 2)])
        assert not group_complete([self._info("a", "g1", 0, 2),
                                   self._info("b", "g1", 1, 3)])
        assert not group_complete([])

    def test_router_routes_complete_group_as_unit(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=30.0)
        d.announce(self._info("s0", "g1", 0, 2))
        d.announce(self._info("s1", "g1", 1, 2))
        d.announce(self._info("solo"))
        router = FleetRouter(d, scan_ttl_s=0.0)
        try:
            router.refresh(force=True)
            assert sorted(router.ring.members) == ["group:g1", "solo"]
            assert gauge_value("fleet_shard_group_members",
                               group="g1") == 2
            st = router.status()
            assert st["shard_groups"] == {"g1": ["s0", "s1"]}
        finally:
            router.close()

    def test_incomplete_group_takes_no_traffic(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=30.0)
        d.announce(self._info("s0", "g1", 0, 2))  # shard 1 never joined
        router = FleetRouter(d, scan_ttl_s=0.0, route_retries=1)
        try:
            router.refresh(force=True)
            assert router.ring.members == ()
            with pytest.raises(NoReplicaAvailable):
                router.request([1], sleep=lambda _s: None)
        finally:
            router.close()

    def test_unhealthy_member_removes_whole_group(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=30.0)
        d.announce(self._info("s0", "g1", 0, 2))
        d.announce(self._info("s1", "g1", 1, 2))
        router = FleetRouter(d, scan_ttl_s=0.0)
        try:
            router.refresh(force=True)
            assert "group:g1" in router.ring.members
            with router._lock:
                router._health_ok["s1"] = False   # non-coordinator dies
            router.refresh(force=True)
            assert router.ring.members == ()
        finally:
            router.close()


class TestShardGroupServing:
    """JAX's ``tests/test_mesh.py::TestShardGroupServing`` against the
    port."""

    def _spawn_member(self, tmp_path, members, rid, idx, service_fn):
        def _graph():
            src = np.arange(8, dtype=np.int64)
            return CSRTopo(edge_index=np.stack([src, (src + 1) % 8]))

        rep = FleetReplica(
            rid, fleet_dir=str(tmp_path / "fleet"),
            root=str(tmp_path / f"dur-{rid}"),
            graph_factory=lambda: StreamingGraph(_graph(),
                                                 delta_capacity=64,
                                                 device="cpu"),
            role="leader", heartbeat_s=0.1, service_fn=service_fn,
            shard_group="g1", shard_index=idx, shard_count=2,
            device="cpu").boot()
        members.append(rep)
        return rep

    def test_group_failover_typed_unavailable(self, tmp_path):
        """A 2-member shard group serves as one unit; one member dying
        yields a typed NoReplicaAvailable — answered (with an error),
        never dropped, never partial."""
        members = []
        directory = MembershipDirectory(str(tmp_path / "fleet"),
                                        heartbeat_timeout_s=5.0)
        router = None
        try:
            s0 = self._spawn_member(
                tmp_path, members, "s0", 0,
                lambda ids, tenant: {"answered_by": "s0",
                                     "n": len(ids)})
            self._spawn_member(
                tmp_path, members, "s1", 1,
                lambda ids, tenant: {"answered_by": "s1",
                                     "n": len(ids)})
            router = FleetRouter(directory, scan_ttl_s=0.0,
                                 request_timeout_s=2.0, route_retries=1)
            router.refresh(force=True)
            assert router.ring.members == ("group:g1",)
            # requests land on the shard-0 coordinator of the group
            reply = router.request([1, 2, 3])
            assert reply["status"] == "ok"
            assert reply["replica"] == "s0"
            assert reply["answered_by"] == "s0"
            assert counter_value("fleet_router_requests_total",
                                 replica="group:g1", status="ok") >= 1
            # one member dies -> the group leaves the ring -> typed
            # unavailable for every caller; no request is silently lost
            members[1].stop()
            router.refresh(force=True)
            assert router.ring.members == ()
            with pytest.raises(NoReplicaAvailable):
                router.request([1], sleep=lambda _s: None)
            # the surviving member alone must NOT serve group traffic
            assert directory.get("s0") is not None
            assert s0.state == "serving"
        finally:
            if router is not None:
                router.close()
            for rep in reversed(members):
                rep.stop()

    def test_member_announces_shard_detail(self, tmp_path):
        os.makedirs(tmp_path / "fleet", exist_ok=True)
        rep = FleetReplica("m0", fleet_dir=str(tmp_path / "fleet"),
                           root=str(tmp_path / "dur"),
                           shard_group="g7", shard_index=1,
                           shard_count=4, device="cpu")
        info = rep._info()
        assert info.shard_group == "g7"
        assert info.shard_index == 1
        assert info.shard_count == 4
        # unsharded replicas carry none of the keys (pre-mesh records)
        plain = FleetReplica("m1", fleet_dir=str(tmp_path / "fleet"),
                             root=str(tmp_path / "dur"), device="cpu")
        assert plain._info().shard_group is None
        assert "shard_index" not in plain._info().detail


# ------------------------------------------------ parity against JAX
_MEMBER_SETS = (["r0", "r1", "r2"], ["d", "c", "b", "a"],
                ["group:g1", "solo"], [f"replica-{i}" for i in range(8)])


@pytest.mark.parametrize("vnodes", [None, 7])
def test_ring_preferences_match_jax(vnodes):
    """The ring's full preference list is JAX's for 4 member sets and
    1,000 keys (partitions and string keys), at the configured and an
    odd virtual-node count."""
    for members in _MEMBER_SETS:
        p, j = (ConsistentHashRing(vnodes), jrouter.ConsistentHashRing(vnodes))
        p.set_members(members)
        j.set_members(members)
        assert p.members == j.members
        for key in range(1000):
            k = key if key % 2 else f"tenant-{key}"
            assert p.preference(k) == j.preference(k), (members, k)
        assert p.preference(3, n=2) == j.preference(3, n=2)
    assert ConsistentHashRing().vnodes == jrouter.ConsistentHashRing().vnodes


def _records():
    return [
        ReplicaInfo("r0", state="serving", port=1234, role="leader",
                    pid=11, staleness_lsn=0, wal_next_lsn=42, epoch=3,
                    detail={"metrics_port": 9100, "clock_perf": 1.5,
                            "clock_wall": 1.7e9, "walstream_port": 7001}),
        ReplicaInfo("r1", state="replaying", host="10.0.0.2", port=1235,
                    staleness_lsn=7, staleness_seconds=0.25,
                    wal_next_lsn=35,
                    detail={"shard_group": "g1", "shard_index": 1,
                            "shard_count": 2}),
        ReplicaInfo("r2.b", state="draining"),
    ]


def test_membership_records_cross_read(tmp_path):
    """A record written by either package reads back with equal fields
    in the other, and both write the same bytes for the same record."""
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    pd = MembershipDirectory(str(pdir), heartbeat_timeout_s=1e9)
    jd = jmembership.MembershipDirectory(str(jdir), heartbeat_timeout_s=1e9)
    for info in _records():
        jinfo = jmembership.ReplicaInfo.from_dict(info.to_dict())
        pd.announce(info, heartbeat=1.7e9 + 1)
        jd.announce(jinfo, heartbeat=1.7e9 + 1)
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    for name in names:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    cross_j = jmembership.MembershipDirectory(str(pdir),
                                              heartbeat_timeout_s=1e9)
    cross_p = MembershipDirectory(str(jdir), heartbeat_timeout_s=1e9)
    got_j = [r.to_dict() for r in cross_j.replicas()]
    got_p = [r.to_dict() for r in cross_p.replicas()]
    assert got_j == got_p == [r.to_dict() for r in pd.replicas()]
    assert cross_j.leader().replica_id == cross_p.leader().replica_id \
        == "r0"
    for r in cross_p.replicas():
        j = cross_j.get(r.replica_id)
        assert (r.shard_group, r.shard_index, r.shard_count) == \
            (j.shard_group, j.shard_index, j.shard_count)
    groups = {k: [m.replica_id for m in v] for k, v in
              jmembership.shard_groups(cross_j.replicas()).items()}
    from quiver_tpu_torch.fleet.membership import shard_groups

    assert groups == {k: [m.replica_id for m in v] for k, v in
                      shard_groups(cross_p.replicas()).items()}


def _shipping_wal(wal_dir):
    """Edge ops with timestamps across segment rolls, an abort of one of
    them, and a torn tail: the record the leader is still writing."""
    w = WriteAheadLog(str(wal_dir), fsync="always", segment_bytes=200)
    rng = np.random.default_rng(3)
    for i in range(12):
        n = int(rng.integers(1, 5))
        src, dst = rng.integers(0, 64, n), rng.integers(0, 64, n)
        ts = rng.integers(0, 1 << 30, n)
        op = "remove" if i % 5 == 4 else "add"
        w.append(encode_edge_op(op, src, dst, None if op == "remove"
                                else ts))
        if i == 6:
            w.append(encode_abort(w.next_lsn - 1))
    w.close()
    seg = sorted(os.listdir(wal_dir))[-1]
    buf = io.BytesIO()
    blockio.write_record(buf, encode_edge_op("add", [1], [2], [5]))
    frame = buf.getvalue()
    with open(os.path.join(str(wal_dir), seg), "ab") as fh:
        fh.write(frame[:len(frame) // 2])
    return os.path.join(str(wal_dir), seg), frame[len(frame) // 2:]


def test_wal_shipping_matches_jax(tmp_path):
    """A follower of each package over the same segments — an abort, a
    torn tail finished later, segment rolls — applies the same
    ``(lsn, op, src, dst, ts)`` sequence, held back and counted alike."""
    wal_dir = tmp_path / "wal"
    seg, rest = _shipping_wal(wal_dir)

    def sink(log):
        def apply(lsn, op, src, dst, ts):
            log.append((lsn, op, np.asarray(src).tolist(),
                        np.asarray(dst).tolist(),
                        None if ts is None else np.asarray(ts).tolist()))
        return apply

    logs = {"p": [], "j": []}
    fp = WALFollower(str(wal_dir), apply_fn=sink(logs["p"]), grace_s=30.0,
                     name="t")
    fj = jshipping.WALFollower(str(wal_dir), apply_fn=sink(logs["j"]),
                               grace_s=30.0, name="t")
    for f in (fp, fj):
        f.poll_once()
    assert logs["p"] == logs["j"] and logs["p"]
    assert fp.status()["staleness_lsn"] == fj.status()["staleness_lsn"]
    with open(seg, "ab") as fh:   # the leader finishes its write
        fh.write(rest)
    w = WriteAheadLog(str(wal_dir), fsync="always")
    w.append(encode_edge_op("add", [9], [10], [7]))
    w.close()
    for f in (fp, fj):
        f.poll_once()
    assert logs["p"] == logs["j"]
    assert [e[0] for e in logs["p"]] == sorted(e[0] for e in logs["p"])
    assert fp.applied_lsn == fj.applied_lsn
    for name in ("fleet_ship_aborted_total", "fleet_ship_torn_waits_total",
                 "fleet_ship_records_total"):
        key = metric_key(name, {"replica": "t"})
        assert telemetry.snapshot()["counters"].get(key, 0) == \
            jtel.snapshot()["counters"].get(key, 0), name
    assert counter_value("fleet_ship_aborted_total", replica="t") == 1


def _exposition():
    """Prometheus text from the port's registry: counters, gauges and
    histograms with hostile label values."""
    from quiver_tpu_torch.telemetry import export as pexport
    from quiver_tpu_torch.telemetry.registry import MetricsRegistry

    texts = {}
    for rid, scale in (("r0", 1.0), ("r1", 2.5)):
        reg = MetricsRegistry()
        reg.counter("fleet_replica_requests_total", status="ok").inc(
            10 * scale)
        reg.counter("fleet_replica_requests_total", status="error").inc(
            scale)
        reg.counter("odd_total", tenant='a\\b c:d').inc(3)
        reg.gauge("fleet_replica_staleness_lsn", replica=rid).set(scale * 4)
        h = reg.histogram("fleet_replica_request_seconds")
        for v in (0.001, 0.004 * scale, 0.02, 0.3 * scale):
            h.observe(v)
        texts[rid] = pexport.to_prometheus_text(reg.snapshot())
    texts["r2"] = "garbage{ line\nfleet_x 1 2 3\n# TYPE y counter\ny 4\n"
    return texts


def test_federation_functions_match_jax():
    """``parse_prometheus_text``, ``federate``, ``render_fleet_text`` and
    ``estimate_offsets`` agree with JAX's on the same inputs."""
    texts = _exposition()
    scrapes = {}
    for rid, text in texts.items():
        got, jgot = pfed.parse_prometheus_text(text), \
            jfed.parse_prometheus_text(text)
        assert got == jgot, rid
        scrapes[rid] = got[0]
    view = pfed.federate(scrapes)
    assert view == jfed.federate(scrapes)
    assert pfed.render_fleet_text(view) == jfed.render_fleet_text(view)
    # the re-rendered exposition parses back the same in both packages
    text = pfed.render_fleet_text(view)
    assert pfed.parse_prometheus_text(text) == \
        jfed.parse_prometheus_text(text)
    samples = {"r0": [(1.0, 1000.5), (2.0, 1001.5), (3.0, 1009.0)],
               "r1": [(5.0, 2000.0)], "r2": []}
    assert pfed.estimate_offsets(samples) == jfed.estimate_offsets(samples)


# ------------------------------------------ the slice as a whole (CPU)
SLICE_NODES, SLICE_EDGES, SLICE_DIM = 3000, 24000, 12
SLICE_SIZES, SLICE_HIDDEN, SLICE_OUT = [5, 3], 16, 4
SLICE_TOL = dict(rtol=1e-5, atol=1e-5)


def _slice_world():
    """The graph, table and one GraphSAGE in both packages (the port's
    weights through the converter)."""
    import jax

    from quiver_tpu.feature import Feature as JaxFeature
    from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
    from quiver_tpu.sampler import GraphSageSampler as JaxSampler
    from quiver_tpu.stream import StreamingGraph as JaxGraph
    from quiver_tpu.utils.rng import make_key
    from quiver_tpu.utils.topology import CSRTopo as JaxTopo

    import quiver_tpu_torch as qt

    rng = np.random.default_rng(13)
    ei = np.stack([rng.integers(0, SLICE_NODES, SLICE_EDGES),
                   rng.integers(0, SLICE_NODES, SLICE_EDGES)])
    ei[:, -1] = SLICE_NODES - 1
    feat = rng.standard_normal((SLICE_NODES, SLICE_DIM)).astype(np.float32)
    jfeat = JaxFeature(device_cache_size=feat.nbytes).from_cpu_tensor(feat)
    pfeat = qt.Feature(device_cache_size=feat.nbytes,
                       device="cpu").from_cpu_tensor(feat)
    model = JaxSAGE(hidden=SLICE_HIDDEN, out_dim=SLICE_OUT,
                    num_layers=len(SLICE_SIZES), dropout=0.0)
    g0 = JaxGraph(JaxTopo(edge_index=ei))
    b0 = JaxSampler(g0, sizes=SLICE_SIZES, gather_mode="xla",
                    sample_rng="hash").sample(np.arange(8), key=make_key(0))
    params = model.init(make_key(1), jfeat.lookup_device(b0.n_id),
                        b0.layers)
    port = qt.GraphSAGE(SLICE_DIM, SLICE_HIDDEN, SLICE_OUT,
                        num_layers=len(SLICE_SIZES), device="cpu")
    port.load_state_dict(
        qt.sage_params_from_flax(jax.tree.map(np.asarray, params)))
    port.eval()

    def jax_factory():
        return JaxGraph(JaxTopo(edge_index=ei), delta_capacity=8192)

    def port_factory():
        return StreamingGraph(CSRTopo(edge_index=ei), delta_capacity=8192,
                              device="cpu")

    def jax_service(holder):
        samplers = {}

        def service(ids, tenant):
            g = holder["rep"].graph
            s = samplers.get(id(g))
            if s is None:
                s = samplers[id(g)] = JaxSampler(
                    g, sizes=SLICE_SIZES, gather_mode="xla",
                    sample_rng="hash")
            b = s.sample(np.asarray(ids), key=make_key(int(tenant[1:])))
            out = model.apply(params, jfeat.lookup_device(b.n_id), b.layers)
            return {"n_id": np.asarray(b.n_id).tolist(),
                    "logits": np.asarray(out).tolist(),
                    "version": int(b.version)}
        return service

    def port_service(holder):
        import torch
        from quiver_tpu.ops.sample import _fold_key_words

        samplers = {}

        def service(ids, tenant):
            g = holder["rep"].graph
            s = samplers.get(id(g))
            if s is None:
                s = samplers[id(g)] = qt.GraphSageSampler(
                    g, SLICE_SIZES, device="cpu", gather_mode="xla")
            words = np.array(
                [[int(np.asarray(w)) for w in _fold_key_words(k)]
                 for k in jax.random.split(make_key(int(tenant[1:])),
                                           len(SLICE_SIZES))], np.uint32)
            with torch.inference_mode():
                b = s.sample(np.asarray(ids), key_words=words)
                out = port(pfeat[b.n_id.numpy()], b.layers)
            return {"n_id": b.n_id.numpy().tolist(),
                    "logits": out.numpy().tolist(),
                    "version": int(b.version)}
        return service

    return (dict(factory=jax_factory, service=jax_service),
            dict(factory=port_factory, service=port_service))


def _direct(port, ids, tenant):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as conn:
        conn.sendall((json.dumps({"ids": ids, "tenant": tenant})
                      + "\n").encode())
        with conn.makefile("rb") as fh:
            return json.loads(fh.readline())


def test_fleet_serves_graphsage_as_jax(tmp_path):
    """A leader + follower fleet of each package serves GraphSAGE on a
    3,000-node streaming graph.  After the same inserts through each
    leader's lane and the follower's catch-up, the same requests give
    bitwise equal ``n_id``, logits within 1e-5 and equal graph versions,
    through each router and from each replica directly."""
    from quiver_tpu.fleet import FleetReplica as JaxReplica
    from quiver_tpu.fleet import FleetRouter as JaxRouter

    jworld, pworld = _slice_world()
    rng = np.random.default_rng(17)
    inserts = [(rng.integers(0, SLICE_NODES, 32),
                rng.integers(0, SLICE_NODES, 32)) for _ in range(6)]
    jcfg = jconfig.get_config()
    saved = {k: getattr(jcfg, k) for k in ("fleet_ship_poll_ms",
                                           "fleet_ship_grace_ms")}
    jconfig.update(fleet_ship_poll_ms=10.0, fleet_ship_grace_ms=60.0)
    fleets = {}
    try:
        with pconfig.override(fleet_ship_poll_ms=10.0,
                              fleet_ship_grace_ms=60.0):
            for name, (Replica, Router, world, kw) in {
                    "jax": (JaxReplica, JaxRouter, jworld, {}),
                    "port": (FleetReplica, FleetRouter, pworld,
                             {"device": "cpu"})}.items():
                fdir = str(tmp_path / name / "fleet")
                root = str(tmp_path / name / "dur")
                reps = []
                for rid, role in (("r0", "leader"), ("r1", "follower")):
                    holder = {}
                    rep = Replica(rid, fleet_dir=fdir, root=root,
                                  graph_factory=world["factory"],
                                  role=role, heartbeat_s=0.1,
                                  service_fn=world["service"](holder), **kw)
                    holder["rep"] = rep
                    rep.boot()
                    reps.append(rep)
                    if role == "leader":
                        rep.manager.checkpoint(timeout=10)
                leader, follower = reps
                for src, dst in inserts:
                    leader.lane.submit(src, dst)
                for _ in inserts:
                    _u, res = leader.lane.results.get(timeout=10)
                    assert not isinstance(res, Exception), res
                deadline = time.time() + 10
                while time.time() < deadline and (
                        follower.graph.version != leader.graph.version
                        or follower.follower.status()["staleness_lsn"]):
                    time.sleep(0.02)
                assert follower.graph.version == leader.graph.version
                dirc = (jmembership.MembershipDirectory if name == "jax"
                        else MembershipDirectory)(fdir,
                                                  heartbeat_timeout_s=5.0)
                router = Router(dirc, scan_ttl_s=0.0, request_timeout_s=10.0)
                fleets[name] = (reps, router)
            answers = {}
            for name, (reps, router) in fleets.items():
                got = []
                for k in range(6):
                    ids = rng.integers(0, SLICE_NODES, 8).tolist() \
                        if name == "jax" else answers["jax"][k][0]
                    tenant = f"k{k}"
                    replies = [router.request(ids, tenant=tenant)]
                    replies += [_direct(r.port, ids, tenant) for r in reps]
                    got.append((ids, replies))
                answers[name] = got
            for (ids, jrep), (_ids, prep) in zip(answers["jax"],
                                                  answers["port"]):
                want = jrep[0]
                for reply in jrep + prep:
                    assert reply["status"] == "ok", reply
                    assert reply["n_id"] == want["n_id"]
                    assert reply["version"] == want["version"]
                    np.testing.assert_allclose(
                        np.array(reply["logits"], np.float32),
                        np.array(want["logits"], np.float32), **SLICE_TOL)
                assert {r["replica"] for r in prep[1:]} == {"r0", "r1"}
            assert answers["jax"][0][1][0]["version"] > 0
    finally:
        for reps, router in fleets.values():
            router.close()
            for rep in reversed(reps):
                rep.stop()
        jconfig.update(**saved)


# ---------------------------------------- the pieces outside fleet/
def test_fleet_knobs_match_jax(monkeypatch):
    """Every ``fleet_*`` knob exists under JAX's name and default, and
    reads the same ``QUIVER_TPU_FLEET_*`` variable."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(jconfig.Config)
             if f.name.startswith("fleet_")]
    assert len(names) == 30
    assert names == [f.name for f in dataclasses.fields(pconfig.Config)
                     if f.name.startswith("fleet_")]
    want, got = jconfig.Config(), pconfig.Config()
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    env = {"QUIVER_TPU_FLEET_DIR": "/srv/fleet",
           "QUIVER_TPU_FLEET_PARTITIONS": "32",
           "QUIVER_TPU_FLEET_HEARTBEAT_TIMEOUT_S": "1.5",
           "QUIVER_TPU_FLEET_ELECTION": "on",
           "QUIVER_TPU_FLEET_AUTOSCALER_UP_RATIO": "0.9"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = jconfig.Config(), pconfig.Config()
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert got.fleet_partitions == 32 and got.fleet_election == "on"


def test_fleet_chaos_points_and_error_match_jax():
    """The fleet's chaos points are registered at import, under JAX's
    names and order, and ``NoReplicaAvailable`` answers as JAX's."""
    from quiver_tpu.resilience import errors as jerrors

    assert chaos.FLEET_POINTS == jchaos.FLEET_POINTS
    for name in chaos.FLEET_POINTS:
        assert name in chaos._POINTS
    from quiver_tpu_torch.resilience import errors as perrors

    p, j = NoReplicaAvailable(5, 3), jerrors.NoReplicaAvailable(5, 3)
    assert str(p) == str(j) and (p.partition, p.attempts) == (5, 3)
    assert isinstance(p, perrors.ResilienceError)
    assert "NoReplicaAvailable" in perrors.__all__


def test_export_fleet_through_the_provider(tmp_path):
    """``timeline.export_fleet`` refuses with no federation, as JAX's
    does, and writes the registered provider's document."""
    for tl in (timeline, jtimeline):
        with pytest.raises(RuntimeError, match="no fleet federation"):
            tl.export_fleet(str(tmp_path / "none.json"))
    doc = {"traceEvents": [{"name": "x", "ph": "i", "pid": 0, "tid": 0,
                            "ts": 1.0}], "displayTimeUnit": "ms"}
    for name, tl in (("p", timeline), ("j", jtimeline)):
        tl.set_fleet_trace_provider(lambda: doc)
        tl.export_fleet(str(tmp_path / f"{name}.json"))
        tl.set_fleet_trace_provider(None)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
