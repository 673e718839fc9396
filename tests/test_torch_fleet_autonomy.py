"""Port parity: the fleet's autonomy (``quiver_tpu_torch.fleet``'s
election, WAL streaming and autoscaler) against the JAX package's
``tests/test_fleet_autonomy.py`` and against the JAX objects.

* **JAX's cases** — every case of ``tests/test_fleet_autonomy.py`` runs
  against the port under its JAX name (the eight slow ones stay slow),
  with graphs and replicas on the CPU (``device="cpu"``).
* **Parity** — for the same WAL segments the stream server of each
  package sends the same frame lines; over a scripted claim and expiry
  sequence the claim files and fence decisions are equal; over a
  scripted two-day series with a fake clock the predictor's forecasts
  and the autoscaler's decisions are equal.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.fleet import autoscaler as jautoscaler
from quiver_tpu.fleet import election as jelection
from quiver_tpu.fleet import membership as jmembership
from quiver_tpu.fleet import walstream as jwalstream
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.resilience.breaker import reset as jbreakers_reset
from quiver_tpu.telemetry import flightrec as jflightrec

from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry
from quiver_tpu_torch.fleet import (FleetReplica, MembershipDirectory,
                                    ReplicaInfo)
from quiver_tpu_torch.fleet.autoscaler import (DiurnalPredictor,
                                               FleetAutoscaler)
from quiver_tpu_torch.fleet.election import (ClaimRecord, ElectionDirectory,
                                             EpochFence, FencedWAL,
                                             LeaderElector, StaleEpochError)
from quiver_tpu_torch.fleet.walstream import (WALStreamFollower,
                                              WALStreamServer)
from quiver_tpu_torch.recovery import blockio
from quiver_tpu_torch.recovery.wal import WriteAheadLog, encode_edge_op
from quiver_tpu_torch.resilience import chaos
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.resilience.breaker import reset as breakers_reset
from quiver_tpu_torch.resilience.errors import ChaosFault
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.telemetry import flightrec
from quiver_tpu_torch.telemetry.registry import metric_key
from quiver_tpu_torch.utils.topology import CSRTopo

_JAX_TELEMETRY_DEFAULT = jtel.enabled()

pytestmark = pytest.mark.fleet

N_NODES = 64


def _graph():
    src = np.arange(N_NODES, dtype=np.int64)
    dst = (src + 1) % N_NODES
    return StreamingGraph(CSRTopo(edge_index=np.stack([src, dst])),
                          delta_capacity=4096, device="cpu")


def counter_value(name, **labels):
    return telemetry.snapshot()["counters"].get(
        metric_key(name, labels), 0)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' registries, chaos plans, QoS, breakers and flight
    recorders start and end clean; JAX's telemetry is on for the test
    (``TestElection``'s parity reads JAX counters) and back at its
    process default after."""
    for tel, ch, rec, qos in ((telemetry, chaos, flightrec, pqos),
                              (jtel, jchaos, jflightrec, jqos)):
        tel.set_enabled(True)
        tel.reset()
        ch.uninstall()
        rec.reset()
        qos.reset()
    yield
    for tel, ch, rec, qos in ((telemetry, chaos, flightrec, pqos),
                              (jtel, jchaos, jflightrec, jqos)):
        ch.uninstall()
        rec.reset()
        qos.reset()
        tel.reset()
    breakers_reset()
    jbreakers_reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _fill(wal, n, start=0):
    for i in range(start, start + n):
        wal.append(encode_edge_op("add", [i % N_NODES],
                                  [(i + 1) % N_NODES], None))


# ---------------------------------------------------------- election
class TestElection:
    def test_exclusive_claim_exactly_one_winner(self, tmp_path):
        ed = ElectionDirectory(str(tmp_path))
        results = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            results.append(ed.claim(ClaimRecord(
                epoch=5, leader_id=f"r{i}", wall=time.time())))

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(results) == 1
        assert ed.top().epoch == 5

    def test_fence_refuses_stale_epoch_and_is_sticky(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"))
        ed = ElectionDirectory(str(tmp_path))
        assert ed.claim(ClaimRecord(epoch=1, leader_id="a",
                                    wall=time.time()))
        fence = EpochFence(ed, 1, "a", recheck_s=0.0)
        fenced = FencedWAL(wal, fence)
        lsn = fenced.append(b"ok-at-epoch-1")
        assert lsn == 0
        # delegation: non-write attrs reach the real WAL
        assert fenced.next_lsn == wal.next_lsn
        ed.claim(ClaimRecord(epoch=2, leader_id="b", wall=time.time()))
        before = counter_value("fleet_election_fenced_writes_total",
                               replica="a")
        with pytest.raises(StaleEpochError):
            fenced.append(b"deposed")
        # sticky: refuses again without re-reading the directory
        with pytest.raises(StaleEpochError):
            fenced.roll()
        assert counter_value("fleet_election_fenced_writes_total",
                             replica="a") == before + 2
        # nothing landed after the fence dropped
        assert wal.next_lsn == 1
        wal.close()

    def test_own_higher_claim_does_not_fence(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"))
        ed = ElectionDirectory(str(tmp_path))
        ed.claim(ClaimRecord(epoch=1, leader_id="a", wall=time.time()))
        ed.claim(ClaimRecord(epoch=2, leader_id="a", wall=time.time()))
        fence = EpochFence(ed, 1, "a", recheck_s=0.0)
        FencedWAL(wal, fence).append(b"still-mine")
        wal.close()

    def test_elector_ladder_most_caught_up_claims_first(self, tmp_path):
        d = MembershipDirectory(str(tmp_path),
                                heartbeat_timeout_s=60.0)
        d.announce(ReplicaInfo("a", state="serving", wal_next_lsn=5))
        d.announce(ReplicaInfo("b", state="serving", wal_next_lsn=10))
        promoted = []
        ea = LeaderElector(d, "a", applied_lsn_fn=lambda: 4,
                           role_fn=lambda: "follower",
                           promote_fn=promoted.append,
                           stagger_s=0.5, timeout_s=60.0)
        eb = LeaderElector(d, "b", applied_lsn_fn=lambda: 9,
                           role_fn=lambda: "follower",
                           promote_fn=promoted.append,
                           stagger_s=0.5, timeout_s=60.0)
        # no leader anywhere: first pass only starts the death clock
        assert ea.step(now=0.0) is None
        assert eb.step(now=0.0) is None
        # b (most caught-up) is rank 0 and claims at once; a is rank 1
        # and must still be inside its stagger window
        assert ea.step(now=0.1) is None
        assert eb.step(now=0.1) == "claimed"
        assert [c.leader_id for c in promoted] == ["b"]
        assert eb.epoch == 1
        assert counter_value("fleet_election_promotions_total",
                             replica="b") >= 1
        # a now observes a fresh claim and stands down
        assert ea.step(now=1.0) is None

    def test_elector_claim_race_loser_stands_down(self, tmp_path):
        d = MembershipDirectory(str(tmp_path),
                                heartbeat_timeout_s=60.0)
        d.announce(ReplicaInfo("a", state="serving", wal_next_lsn=5))
        promoted = []
        e = LeaderElector(d, "a", applied_lsn_fn=lambda: 4,
                          role_fn=lambda: "follower",
                          promote_fn=promoted.append,
                          stagger_s=0.0, timeout_s=0.0)
        e.step(now=0.0)
        # a racer lands epoch 1 inside the read-then-claim window: the
        # elector computed its epoch from a ``top()`` that did not yet
        # see the racer, so its own claim of epoch 1 loses the CAS
        e.election_dir.claim(ClaimRecord(epoch=1, leader_id="z",
                                         wall=0.0))
        real_top = e.election_dir.top
        e.election_dir.top = lambda: None
        try:
            assert e.step(now=1.0) == "lost"
        finally:
            e.election_dir.top = real_top
        assert promoted == []
        assert e.epoch == -1

    def test_elector_demotes_on_higher_foreign_epoch(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=60.0)
        demoted = []
        e = LeaderElector(d, "a", applied_lsn_fn=lambda: 0,
                          role_fn=lambda: "leader",
                          demote_fn=demoted.append)
        claim = e.claim_initial()
        assert claim.epoch == 1
        assert e.step(now=0.0) is None  # own claim: still leading
        e.election_dir.claim(ClaimRecord(epoch=2, leader_id="b",
                                         wall=time.time()))
        assert e.step(now=0.1) == "demoted"
        assert demoted[0].epoch == 2

    def test_claim_initial_rides_past_existing_epochs(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=60.0)
        ed = ElectionDirectory(str(tmp_path))
        ed.claim(ClaimRecord(epoch=7, leader_id="dead", wall=0.0))
        e = LeaderElector(d, "a", applied_lsn_fn=lambda: 0,
                          role_fn=lambda: "leader")
        assert e.claim_initial().epoch == 8

    def test_claim_prune_keeps_newest(self, tmp_path):
        ed = ElectionDirectory(str(tmp_path))
        for epoch in range(1, 21):
            ed.claim(ClaimRecord(epoch=epoch, leader_id="a"))
        removed = ed.prune(keep=4)
        assert removed == 16
        assert ed._epochs() == [17, 18, 19, 20]
        assert ed.top().epoch == 20

    def test_chaos_point_claim_fires_from_seeded_plan(self, tmp_path):
        ed = ElectionDirectory(str(tmp_path))
        chaos.install(chaos.ChaosPlan(seed=1).fail(
            "fleet.election.claim",
            exc=ChaosFault("fleet.election.claim", 0), times=1))
        with pytest.raises(ChaosFault):
            ed.claim(ClaimRecord(epoch=1, leader_id="a"))
        # the plan spent its shot; the claim itself still works
        assert ed.claim(ClaimRecord(epoch=1, leader_id="a"))


# --------------------------------------------------------- walstream
def _stream_pair(tmp_path, n_records, start_lsn=-1, resync_fn=None,
                 grace_s=0.02):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    _fill(wal, n_records)
    server = WALStreamServer(str(tmp_path / "wal"), name="L",
                             poll_interval_s=0.01)
    applied = []
    follower = WALStreamFollower(
        lambda: ("127.0.0.1", server.port),
        apply_fn=lambda lsn, op, src, dst, ts: applied.append(lsn),
        start_lsn=start_lsn, resync_fn=resync_fn,
        poll_interval_s=0.01, grace_s=grace_s, name="F")
    return wal, server, follower, applied


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


@pytest.mark.slow  # real sockets + poll loops; covered by `make fleet`
class TestWALStream:
    def test_round_trip_catch_up_and_live_tail(self, tmp_path):
        wal, server, follower, applied = _stream_pair(tmp_path, 40)
        try:
            follower.start()
            assert _wait(lambda: len(applied) == 40)
            assert applied == list(range(40))
            # live appends keep flowing over the same connection
            _fill(wal, 10, start=40)
            assert _wait(lambda: len(applied) == 50)
            assert applied == list(range(50))
            st = follower.status()
            assert st["staleness_lsn"] == 0
            assert st["resyncs"] == 0
            assert counter_value("fleet_walstream_sent_total",
                                 replica="L") >= 50
            assert counter_value("fleet_walstream_connections_total",
                                 replica="L") >= 1
        finally:
            follower.stop()
            server.stop()
            wal.close()

    def test_mid_stream_disconnect_resumes_from_lsn(self, tmp_path):
        wal, server, follower, applied = _stream_pair(tmp_path, 30)
        # the 11th shipped record dies mid-send: connection drops, the
        # follower reconnects with from_lsn = its committed cursor
        chaos.install(chaos.ChaosPlan(seed=2).fail(
            "fleet.walstream.send",
            exc=ChaosFault("fleet.walstream.send", 0),
            after=10, times=1))
        try:
            follower.start()
            assert _wait(lambda: len(applied) == 30)
            # resume-from-LSN: no loss, no duplicates, in order
            assert applied == list(range(30))
            assert counter_value("fleet_walstream_resumes_total",
                                 replica="L") >= 1
            assert counter_value("fleet_walstream_reconnects_total",
                                 replica="F") >= 1
        finally:
            follower.stop()
            server.stop()
            wal.close()

    def test_crc_reverification_rejects_tampered_frame(self, tmp_path):
        wal, server, follower, applied = _stream_pair(tmp_path, 1)
        try:
            before = counter_value("fleet_walstream_crc_errors_total",
                                   replica="F")
            with pytest.raises(Exception):
                follower._verify(b"\x00\x01 definitely not a frame")
            assert counter_value("fleet_walstream_crc_errors_total",
                                 replica="F") == before + 1
            # a frame that carries trailing garbage is rejected too
            good = b"payload-bytes"
            frame = blockio._HEADER.pack(
                blockio.RECORD_MAGIC, len(good),
                blockio.crc32c(good)) + good + b"trailing"
            with pytest.raises(Exception):
                follower._verify(frame)
            # and an intact single frame round-trips
            assert follower._verify(frame[:-len(b"trailing")]) == good
        finally:
            follower.stop()
            server.stop()
            wal.close()

    def test_corrupt_slot_on_leader_disk_skipped_not_applied(
            self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"))
        _fill(wal, 10)
        wal.close()
        # flip one payload byte of record 3 on disk: CRC mismatch that
        # still resyncs (the frame after it is intact)
        seg = sorted(p for p in os.listdir(tmp_path / "wal")
                     if p.endswith(".seg"))[0]
        path = str(tmp_path / "wal" / seg)
        with open(path, "rb") as f:
            data = bytearray(f.read())
        offsets = [off for kind, off, _ in blockio.scan_records(bytes(data))
                   if kind == "ok"]
        data[offsets[3] + blockio.RECORD_HEADER_SIZE] ^= 0xFF
        with open(path, "wb") as f:
            f.write(data)
        server = WALStreamServer(str(tmp_path / "wal"), name="L",
                                 poll_interval_s=0.01)
        applied = []
        follower = WALStreamFollower(
            lambda: ("127.0.0.1", server.port),
            apply_fn=lambda lsn, *a: applied.append(lsn),
            poll_interval_s=0.01, grace_s=0.02, name="F")
        try:
            follower.start()
            assert _wait(lambda: len(applied) == 9)
            # slot 3 consumed its LSN but shipped no op
            assert applied == [0, 1, 2, 4, 5, 6, 7, 8, 9]
        finally:
            follower.stop()
            server.stop()

    def test_truncation_gap_triggers_checkpoint_resync(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "wal"))
        _fill(wal, 10)
        wal.roll()
        _fill(wal, 10, start=10)
        wal.truncate_through(9)  # drops the sealed segment: log starts at 10
        server = WALStreamServer(str(tmp_path / "wal"), name="L",
                                 poll_interval_s=0.01)
        applied = []
        resyncs = []

        def resync():
            resyncs.append(1)
            return 10  # "checkpoint" watermark: resume from LSN 10

        follower = WALStreamFollower(
            lambda: ("127.0.0.1", server.port),
            apply_fn=lambda lsn, *a: applied.append(lsn),
            start_lsn=-1, resync_fn=resync,
            poll_interval_s=0.01, grace_s=0.02, name="F")
        try:
            follower.start()
            assert _wait(lambda: len(applied) == 10)
            assert resyncs  # the gap was answered with a resync
            assert applied == list(range(10, 20))
        finally:
            follower.stop()
            server.stop()
            wal.close()

    def test_no_leader_endpoint_waits_without_error(self, tmp_path):
        applied = []
        follower = WALStreamFollower(
            lambda: None, apply_fn=lambda *a: applied.append(a),
            poll_interval_s=0.01, grace_s=0.02, name="F")
        try:
            follower.start()
            time.sleep(0.1)
            assert follower.is_running()
            assert follower.status()["last_error"] is None
            assert applied == []
        finally:
            follower.stop()


# -------------------------------------------------------- autoscaler
def _snap(total=0.0, eligible=1, staleness=None):
    gauges = {metric_key("fleet_router_eligible_total", None):
              float(eligible)}
    if staleness is not None:
        gauges[metric_key("fleet_replica_staleness_lsn",
                          {"replica": "f1"})] = float(staleness)
    return {"counters": {metric_key("fleet_replica_requests_total",
                                    {"status": "ok"}): float(total)},
            "gauges": gauges, "histograms": {}}


def _scaler(snapshots, spawned, drained, directory=None, **kw):
    snaps = iter(snapshots)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 8)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("rps_per_replica", 10.0)
    kw.setdefault("horizon_s", 10.0)
    kw.setdefault("up_ratio", 0.8)
    kw.setdefault("down_ratio", 0.5)
    return FleetAutoscaler(
        snapshot_fn=lambda: next(snaps),
        spawn_fn=spawned.append, drain_fn=drained.append,
        directory=directory, **kw)


class TestAutoscaler:
    def test_predictive_scale_up_ahead_of_ramp(self):
        spawned, drained = [], []
        # a steepening ramp: rates 10, 20, 30 rps; the 10 s horizon
        # extrapolates far past one replica's 10 rps capacity
        s = _scaler([_snap(0), _snap(10), _snap(30), _snap(60)],
                    spawned, drained)
        for t in (0.0, 1.0, 2.0):
            s.evaluate_once(now=t)
        decision = s.evaluate_once(now=3.0)
        assert decision["action"] == "spawn"
        assert decision["predicted_rps"] > 30.0
        assert spawned and spawned[0] >= 1
        assert drained == []

    def test_hysteresis_holds_inside_band(self):
        spawned, drained = [], []
        # steady 7 rps on one replica (capacity 10): above the 50%
        # shrink threshold, below the 80% up threshold → hold forever
        s = _scaler([_snap(i * 7) for i in range(6)], spawned, drained)
        actions = [s.evaluate_once(now=float(i))["action"]
                   for i in range(6)]
        assert set(actions) == {"hold"}
        assert spawned == [] and drained == []

    def test_staleness_breach_boosts_even_when_rate_is_low(self):
        bound = pconfig.get_config().fleet_max_staleness_lsn
        spawned, drained = [], []
        s = _scaler([_snap(0), _snap(1, staleness=bound * 10 + 1)],
                    spawned, drained)
        s.evaluate_once(now=0.0)
        decision = s.evaluate_once(now=1.0)
        assert decision["action"] == "spawn"
        assert "staleness" in decision["reason"]

    def test_cooldown_allows_one_direction_change_per_window(self):
        spawned, drained = [], []
        s = _scaler([_snap(0)] + [_snap(i * 200) for i in range(1, 8)],
                    spawned, drained, cooldown_s=30.0)
        s.evaluate_once(now=0.0)
        first = s.evaluate_once(now=1.0)
        assert first["action"] == "spawn"
        # the window is hot: every further wish is suppressed to hold
        for t in (2.0, 10.0, 29.0):
            assert s.evaluate_once(now=t)["action"] == "hold"
        # window over: actions flow again
        assert s.evaluate_once(now=32.0)["action"] == "spawn"
        assert len(spawned) == 2

    def test_drain_victim_is_never_the_leader(self, tmp_path):
        d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=60.0)
        d.announce(ReplicaInfo("L", state="serving", role="leader"))
        d.announce(ReplicaInfo("f1", state="serving"))
        d.announce(ReplicaInfo("f2", state="serving"))
        spawned, drained = [], []
        s = _scaler([_snap(0), _snap(0), _snap(0)], spawned, drained,
                    directory=d)
        s.evaluate_once(now=0.0)
        decision = s.evaluate_once(now=1.0)  # 0 rps on 3 replicas
        assert decision["action"] == "drain"
        # the membership directory never shrinks here, so every pick
        # lands on the same victim — and never on the leader
        assert drained and set(drained) == {"f2"}

    def test_predictor_learns_diurnal_profile(self):
        p = DiurnalPredictor(period_s=100.0, buckets=10, window=4)
        # two simulated days: busy at phase 0.25, idle at phase 0.75
        for day in range(2):
            t0 = day * 100.0
            p.observe(t0 + 25.0, 100.0)
            p.observe(t0 + 75.0, 0.0)
        busy = p.predict(225.0)   # next day, busy phase
        idle = p.predict(275.0)   # next day, idle phase
        assert busy > idle
        assert busy >= 50.0

    def test_thread_loop_runs_and_stops(self):
        spawned, drained = [], []
        snaps = [_snap(i * 7) for i in range(1000)]
        s = _scaler(snaps, spawned, drained, interval_s=0.01)
        s.start()
        assert _wait(lambda: s.status()["reason"] != "init")
        s.stop()
        assert "action" in s.status()


# ------------------------------------------------ replica integration
@pytest.fixture
def autonomy_fleet(tmp_path):
    """A fleet with election + walstream ON and fast failover clocks."""
    members = []

    def spawn(rid, role, **kw):
        rep = FleetReplica(rid, fleet_dir=str(tmp_path / "fleet"),
                           root=str(tmp_path / "dur"),
                           graph_factory=_graph, role=role,
                           heartbeat_s=0.1, device="cpu", **kw).boot()
        members.append(rep)
        return rep

    with pconfig.override(
            fleet_election="on", fleet_walstream="on",
            fleet_ship_poll_ms=10.0, fleet_ship_grace_ms=60.0,
            fleet_heartbeat_timeout_s=0.5, fleet_election_poll_s=0.05,
            fleet_election_stagger_s=0.1,
            fleet_election_fence_recheck_s=0.0):
        yield type("F", (), {
            "spawn": staticmethod(spawn), "members": members,
            "directory": MembershipDirectory(str(tmp_path / "fleet"),
                                             heartbeat_timeout_s=0.5)})
        for rep in reversed(members):
            rep.stop()


def _ingest(leader, n, start=0):
    for i in range(start, start + n):
        leader.lane.submit([i % N_NODES], [(i * 7 + 3) % N_NODES])
    for _ in range(n):
        _u, res = leader.lane.results.get(timeout=10)
        assert not isinstance(res, Exception), res


@pytest.mark.slow  # boots two live replicas; covered by `make fleet`
class TestFailoverIntegration:
    def test_leader_death_promotes_follower_with_higher_epoch(
            self, autonomy_fleet):
        leader = autonomy_fleet.spawn("r0", "leader")
        assert leader.epoch >= 1
        old_epoch = leader.epoch
        _ingest(leader, 20)
        leader.manager.checkpoint(timeout=10)
        _ingest(leader, 10, start=20)
        follower = autonomy_fleet.spawn("r1", "follower")
        frontier = leader.manager.wal.next_lsn
        assert _wait(lambda: follower._applied_lsn() >= frontier - 2)
        # "kill" the leader in-process: elector, heartbeat, lane and
        # WAL all stop, but its membership record is NOT deregistered —
        # the follower must detect death by heartbeat age
        leader.elector.stop()
        leader.elector = None
        leader._hb_stop.set()
        leader.walstream_server.stop()
        leader.walstream_server = None
        leader.lane.stop()
        leader.lane = None
        leader.manager.close()
        leader.manager = None
        assert _wait(lambda: follower.role == "leader", timeout=20)
        assert follower.epoch > old_epoch
        assert _wait(lambda: follower.lane is not None
                     and follower.lane.is_running(), timeout=10)
        # zero acked loss: every record the dead leader acked is in the
        # successor's WAL frontier
        assert follower.manager.wal.next_lsn >= frontier
        # writes flow again through the new leader
        _ingest(follower, 5, start=30)
        assert follower.manager.wal.next_lsn >= frontier + 5
        # membership resolves the successor (higher epoch wins)
        lead_rec = autonomy_fleet.directory.leader()
        assert lead_rec is not None
        assert lead_rec.replica_id == "r1"
        assert lead_rec.epoch == follower.epoch


@pytest.mark.slow  # boots a live replica pair; covered by `make fleet`
class TestOffByDefault:
    def test_no_autonomy_threads_or_metrics_when_off(self, tmp_path):
        before = {
            k for snap in (telemetry.snapshot(),)
            for kind in ("counters", "gauges", "histograms")
            for k in snap[kind]}
        leader = follower = None
        with pconfig.override(fleet_ship_poll_ms=10.0,
                              fleet_ship_grace_ms=60.0):
            try:
                leader = FleetReplica(
                    "r0", fleet_dir=str(tmp_path / "fleet"),
                    root=str(tmp_path / "dur"), graph_factory=_graph,
                    role="leader", heartbeat_s=0.1, device="cpu").boot()
                _ingest(leader, 5)
                leader.manager.checkpoint(timeout=10)
                follower = FleetReplica(
                    "r1", fleet_dir=str(tmp_path / "fleet"),
                    root=str(tmp_path / "dur"), graph_factory=_graph,
                    role="follower", heartbeat_s=0.1, device="cpu").boot()
                for rep in (leader, follower):
                    assert rep.elector is None
                    assert rep.walstream_server is None
                    assert rep.fence is None
                    assert rep.epoch == -1
                assert type(follower.follower).__name__ == "WALFollower"
                after = {
                    k for snap in (telemetry.snapshot(),)
                    for kind in ("counters", "gauges", "histograms")
                    for k in snap[kind]}
                grown = {k for k in after - before
                         if k.startswith(("fleet_election",
                                          "fleet_walstream",
                                          "fleet_autoscaler"))}
                assert grown == set()
                thread_names = {t.name for t in threading.enumerate()}
                assert not any("elector" in n or "walstream" in n
                               or "autoscaler" in n for n in thread_names)
            finally:
                for rep in (follower, leader):
                    if rep is not None:
                        rep.stop()


# ------------------------------------------------ parity against JAX
def _read_lines(port, hello, n_eot=1):
    """Raw stream lines from a WAL stream endpoint until ``n_eot``
    end-of-tail markers."""
    lines = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as conn:
        conn.sendall((json.dumps(hello) + "\n").encode())
        with conn.makefile("rb") as fh:
            while n_eot:
                line = fh.readline()
                assert line, lines
                lines.append(line)
                if b'"eot"' in line or b'"error"' in line:
                    n_eot -= 1
    return lines


@pytest.mark.parametrize("from_lsn", [0, 3, 40])
def test_walstream_frames_match_jax(tmp_path, from_lsn):
    """For the same segments (a roll, a corrupt slot) each package's
    stream server sends the same line bytes from the same cursor, and a
    gap past the log is answered alike."""
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_bytes=400)
    _fill(wal, 12)
    wal.close()
    seg = sorted(p for p in os.listdir(tmp_path / "wal")
                 if p.endswith(".seg"))[0]
    path = str(tmp_path / "wal" / seg)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    offsets = [off for kind, off, _ in blockio.scan_records(bytes(data))
               if kind == "ok"]
    data[offsets[2] + blockio.RECORD_HEADER_SIZE] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
    got = {}
    for name, Server in (("p", WALStreamServer),
                         ("j", jwalstream.WALStreamServer)):
        server = Server(str(tmp_path / "wal"), name="L",
                        poll_interval_s=0.01)
        try:
            got[name] = _read_lines(server.port, {"from_lsn": from_lsn})
        finally:
            server.stop()
    assert got["p"] == got["j"]
    last = json.loads(got["p"][-1])
    if from_lsn > 12:
        assert last == {"eot": True, "next_lsn": from_lsn} or \
            "error" in last
    else:
        assert last == {"eot": True, "next_lsn": 12}
        assert any(b'"corrupt"' in x for x in got["p"]) == (from_lsn <= 2)


def _election_script(pkg, root, clock):
    """A scripted election in one package: a leader's heartbeat expires,
    the most caught-up follower claims, the claim expires with no leader
    record, the other follower claims; a fence of each epoch is checked
    after every step.  Returns (actions, fence outcomes, claim files)."""
    mem, ele = pkg
    d = mem.MembershipDirectory(str(root), heartbeat_timeout_s=2.0)
    d.announce(mem.ReplicaInfo("L", state="serving", role="leader",
                               epoch=0), heartbeat=clock[0])
    roles = {"a": "follower", "b": "follower"}
    promoted = []

    def promote(rid):
        def fn(claim):
            roles[rid] = "leader"
            promoted.append((rid, claim.epoch, claim.claim_lsn))
        return fn

    electors = {rid: ele.LeaderElector(
        d, rid, applied_lsn_fn=lambda lsn=lsn: lsn,
        role_fn=lambda rid=rid: roles[rid], promote_fn=promote(rid),
        stagger_s=0.5, timeout_s=2.0) for rid, lsn in (("a", 4), ("b", 9))}
    ed = ele.ElectionDirectory(str(root))
    fences = {}
    actions, outcomes = [], []
    for now, wall in ((0.0, 1.0), (0.1, 5.0), (0.2, 5.1), (0.4, 5.2),
                      (0.8, 5.3), (1.0, 9.0), (1.1, 9.1), (1.9, 9.2),
                      (2.5, 9.3)):
        clock[0] = 1e9 + wall
        if now == 1.0:
            # the new leader dies too: its record never appears, and
            # the follower that is left must claim past it
            roles["b"] = "dead"
            d.deregister("b")
        for rid, nxt in (("a", 5), ("b", 10)):
            if roles[rid] == "follower":   # the followers' heartbeats
                d.announce(mem.ReplicaInfo(rid, state="serving",
                                           wal_next_lsn=nxt))
        for rid in ("a", "b"):
            if roles[rid] != "dead":
                actions.append((now, rid, electors[rid].step(now=now)))
        top = ed.top()
        if top is not None and top.epoch not in fences:
            fences[top.epoch] = ele.EpochFence(ed, top.epoch,
                                               top.leader_id, recheck_s=0.0)
        for epoch in sorted(fences):
            try:
                fences[epoch].check()
                outcomes.append((now, epoch, "ok"))
            except ele.StaleEpochError:
                outcomes.append((now, epoch, "fenced"))
    files = {n: open(os.path.join(ed.root, n), "rb").read()
             for n in sorted(os.listdir(ed.root))}
    return actions, outcomes, promoted, files


def test_election_matches_jax(tmp_path, monkeypatch):
    """Over a scripted claim and expiry sequence on a fake wall clock,
    the electors take the same actions, the claim files are byte for
    byte JAX's, and the fences refuse at the same steps."""
    from quiver_tpu_torch.fleet import election as pelection
    from quiver_tpu_torch.fleet import membership as pmembership

    clock = [1e9]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    got = {}
    for name, pkg in (("p", (pmembership, pelection)),
                      ("j", (jmembership, jelection))):
        clock[0] = 1e9
        got[name] = _election_script(pkg, tmp_path / name, clock)
    assert got["p"] == got["j"]
    actions, outcomes, promoted, files = got["p"]
    assert [p[0] for p in promoted] == ["b", "a"]
    assert [p[1] for p in promoted] == [1, 2]
    assert len(files) == 2
    assert ("fenced" in [o[2] for o in outcomes if o[1] == 1])


def _series(day_s=100.0, days=2, step=2.0):
    """A two-day diurnal request-count series: busy mid-morning, idle at
    night, one burst on the second day."""
    t, total, out = 0.0, 0.0, []
    while t < days * day_s:
        phase = (t % day_s) / day_s
        rate = 40.0 * max(np.sin(2 * np.pi * phase), 0.0) + 2.0
        if days * day_s * 0.7 < t < days * day_s * 0.72:
            rate += 120.0
        total += rate * step
        out.append((t, total))
        t += step
    return out


def test_autoscaler_decisions_match_jax(tmp_path):
    """On a scripted two-day series with a fake clock the predictor's
    forecasts and every autoscaler decision (action, count, target,
    predicted and measured rates, reason) are JAX's."""
    d = MembershipDirectory(str(tmp_path), heartbeat_timeout_s=1e9)
    d.announce(ReplicaInfo("L", state="serving", role="leader"))
    for rid in ("f1", "f2"):
        d.announce(ReplicaInfo(rid, state="serving"))
    jd = jmembership.MembershipDirectory(str(tmp_path),
                                         heartbeat_timeout_s=1e9)
    runs = {}
    for name, mod, directory in (("p", None, d), ("j", jautoscaler, jd)):
        Scaler = FleetAutoscaler if mod is None else mod.FleetAutoscaler
        Predictor = DiurnalPredictor if mod is None else \
            mod.DiurnalPredictor
        series = iter(_series())
        eligible = [3]
        spawned, drained = [], []

        def snap(series=series, eligible=eligible):
            _t, total = next(series)
            return {"counters": {metric_key(
                        "fleet_replica_requests_total", {"status": "ok"}):
                        total},
                    "gauges": {metric_key("fleet_router_eligible_total",
                                          None): float(eligible[0])},
                    "histograms": {}}

        s = Scaler(snapshot_fn=snap, spawn_fn=spawned.append,
                   drain_fn=drained.append, directory=directory,
                   predictor=Predictor(period_s=100.0, buckets=10,
                                       window=8),
                   min_replicas=1, max_replicas=6, cooldown_s=6.0,
                   rps_per_replica=20.0, horizon_s=4.0, up_ratio=0.8,
                   down_ratio=0.5)
        decisions = []
        for t, _total in _series():
            dec = s.evaluate_once(now=t)
            decisions.append(dec)
            if dec["action"] == "spawn":
                eligible[0] += dec["count"]
            elif dec["action"] == "drain":
                eligible[0] -= 1
        forecasts = [s.predictor.predict(t) for t in (10.0, 137.5, 290.0)]
        runs[name] = (decisions, spawned, drained, forecasts)
    assert runs["p"] == runs["j"]
    actions = {dec["action"] for dec in runs["p"][0]}
    assert {"spawn", "drain"} <= actions
