"""Port parity: the fleet's observability plane
(``quiver_tpu_torch/fleet/federation.py``, the router's cross-process
tracing, ``timeline.export_fleet`` and the exporter's fleet routes)
against the JAX package's ``tests/test_federation.py``: every case runs
against the port under its JAX name, with graphs and replicas on the
CPU (``device="cpu"``).  The parsers, merge, exposition and clock
offsets are also held equal to JAX's on the same inputs in
``tests/test_torch_fleet.py``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import quote

import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.resilience.breaker import reset as jbreakers_reset
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import timeline as jtimeline

from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry
from quiver_tpu_torch.fleet import (FleetReplica, FleetRouter,
                                    MembershipDirectory, ReplicaInfo)
from quiver_tpu_torch.fleet.federation import (FleetFederation,
                                               estimate_offsets, federate,
                                               parse_prometheus_text,
                                               render_fleet_text)
from quiver_tpu_torch.resilience import chaos
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.resilience.breaker import reset as breakers_reset
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.telemetry import flightrec, timeline
from quiver_tpu_torch.telemetry.export import (MetricsServer, _fmt_labels,
                                               to_prometheus_text)
from quiver_tpu_torch.telemetry.registry import MetricsRegistry, metric_key
from quiver_tpu_torch.utils.topology import CSRTopo

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


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' registries, chaos plans, QoS, breakers, flight
    recorders and timelines start and end clean; JAX's telemetry is back
    at its process default after."""
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


def _key(name, **labels):
    return name, tuple(sorted(labels.items()))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------- exposition parsing
class TestPrometheusParsing:
    def test_hostile_label_values_round_trip(self):
        # the exact adversarial shapes the exporter escapes: a value
        # that fakes a sample terminator, embedded quotes, backslashes,
        # braces, commas, and '=' — all must come back byte-identical
        hostile = {
            "tenant": 'gold"} 9\n',
            "path": "a\\b\\\\c",
            "expr": 'x{le="0.5",q=1}',
            "kv": "a=b,c=d",
        }
        text = ("# TYPE fleet_demo_total counter\n"
                f"fleet_demo_total{_fmt_labels(hostile)} 3\n")
        parsed, errors = parse_prometheus_text(text)
        assert errors == 0
        assert parsed["counters"][_key("fleet_demo_total", **hostile)] == 3.0

    def test_malformed_lines_count_errors_not_fatal(self):
        text = "\n".join([
            "# TYPE ok_total counter",
            "ok_total 7",
            "broken{unclosed=\"quote 1",     # unterminated label value
            "no_value_here",                 # missing sample value
            'bad_escape{k="a\\qb"} 1',       # \q is not a valid escape
            "name with spaces{} 1",          # invalid metric name
            "not_a_number{} zebra",          # unparsable value
            "\x00\x01\x02",                  # binary garbage
        ])
        parsed, errors = parse_prometheus_text(text)
        assert errors == 6
        assert parsed["counters"][_key("ok_total")] == 7.0

    def test_registry_exposition_round_trips(self):
        reg = MetricsRegistry()
        reg.counter("demo_requests_total", status="ok").inc(5)
        reg.gauge("demo_depth_level").set(3)
        h = reg.histogram("demo_gather_seconds", bounds=[0.1, 1.0])
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
        parsed, errors = parse_prometheus_text(
            to_prometheus_text(reg.snapshot()))
        assert errors == 0
        assert parsed["counters"][_key("demo_requests_total",
                                       status="ok")] == 5.0
        assert parsed["gauges"][_key("demo_depth_level")] == 3.0
        hist = parsed["histograms"][_key("demo_gather_seconds")]
        assert hist["bounds"] == [0.1, 1.0]
        assert hist["counts"] == [1, 1, 1]
        assert hist["sum"] == pytest.approx(2.55)

    def test_untyped_samples_classify_by_suffix(self):
        parsed, errors = parse_prometheus_text(
            "requests_total 3\nqueue_depth 2\n")
        assert errors == 0
        assert _key("requests_total") in parsed["counters"]
        assert _key("queue_depth") in parsed["gauges"]

    def test_inconsistent_histogram_counts_one_error(self):
        # cumulative bucket counts must be monotone; a torn scrape that
        # violates that drops the family and counts ONE error
        text = "\n".join([
            "# TYPE h_seconds histogram",
            'h_seconds_bucket{le="0.1"} 5',
            'h_seconds_bucket{le="1"} 3',
            'h_seconds_bucket{le="+Inf"} 5',
            "h_seconds_sum 1.0",
            "h_seconds_count 5",
        ])
        parsed, errors = parse_prometheus_text(text)
        assert errors == 1
        assert parsed["histograms"] == {}

    def test_histogram_missing_inf_bucket_is_error(self):
        text = "\n".join([
            "# TYPE h_seconds histogram",
            'h_seconds_bucket{le="0.1"} 1',
            "h_seconds_sum 0.05",
            "h_seconds_count 1",
        ])
        parsed, errors = parse_prometheus_text(text)
        assert errors == 1
        assert parsed["histograms"] == {}

    def test_trailing_timestamp_ignored(self):
        parsed, errors = parse_prometheus_text(
            "a_total 5 1712345678000\n")
        assert errors == 0
        assert parsed["counters"][_key("a_total")] == 5.0


# --------------------------------------------------- federation math
def _scrape(counters=None, gauges=None, histograms=None):
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": histograms or {}}


class TestFederate:
    def test_counters_sum_gauges_spread_histograms_merge(self):
        hk = _key("lat_seconds")
        view = federate({
            "r0": _scrape(
                counters={_key("req_total", status="ok"): 3.0},
                gauges={_key("depth_level"): 1.0},
                histograms={hk: {"bounds": [0.1, 1.0], "counts": [1, 0, 0],
                                 "sum": 0.05, "min": None, "max": None}}),
            "r1": _scrape(
                counters={_key("req_total", status="ok"): 5.0},
                gauges={_key("depth_level"): 2.0},
                histograms={hk: {"bounds": [0.1, 1.0], "counts": [0, 1, 1],
                                 "sum": 2.5, "min": None, "max": None}}),
            "r2": _scrape(
                counters={_key("req_total", status="ok"): 7.0},
                gauges={_key("depth_level"): 6.0}),
        })
        assert view["replicas"] == ["r0", "r1", "r2"]
        assert view["counters"][_key("req_total", status="ok")] == 15.0
        agg = view["gauges"][_key("depth_level")]
        assert (agg["min"], agg["max"], agg["avg"]) == (1.0, 6.0, 3.0)
        merged = view["histograms"][hk]
        assert merged["counts"] == [1, 1, 1]
        assert merged["sum"] == pytest.approx(2.55)
        assert view["merge_errors"] == 0
        # every source series is re-exported with replica attribution
        assert view["per_replica"]["counters"][
            _key("req_total", replica="r1", status="ok")] == 5.0
        assert view["per_replica"]["gauges"][
            _key("depth_level", replica="r2")] == 6.0

    def test_bounds_mismatch_drops_family_and_counts_error(self):
        hk = _key("lat_seconds")
        view = federate({
            "r0": _scrape(histograms={
                hk: {"bounds": [0.1, 1.0], "counts": [1, 0, 0],
                     "sum": 0.05, "min": None, "max": None}}),
            "r1": _scrape(histograms={
                hk: {"bounds": [0.5, 5.0], "counts": [1, 0, 0],
                     "sum": 0.2, "min": None, "max": None}}),
        })
        assert hk not in view["histograms"]
        assert view["merge_errors"] == 1

    def test_source_replica_label_wins(self):
        # shipping's staleness gauges are already replica-scoped at the
        # source; federation must not re-attribute them to the scraped
        # member
        view = federate({
            "scraper-side": _scrape(
                gauges={_key("fleet_replica_staleness_lsn",
                             replica="r7"): 42.0}),
        })
        assert view["per_replica"]["gauges"][
            _key("fleet_replica_staleness_lsn", replica="r7")] == 42.0

    def test_render_round_trips_through_parser(self):
        hostile = 'evil"} 1\n'
        view = federate({
            "r0": _scrape(counters={_key("req_total"): 3.0},
                          gauges={_key("depth_level",
                                       tenant=hostile): 1.0}),
            "r1": _scrape(counters={_key("req_total"): 4.0}),
        })
        parsed, errors = parse_prometheus_text(render_fleet_text(view))
        assert errors == 0
        assert parsed["counters"][_key("req_total")] == 7.0
        assert parsed["counters"][_key("req_total", replica="r0")] == 3.0
        # gauge aggregates carry an agg= label; summing gauges is a lie
        assert parsed["gauges"][_key("depth_level", agg="avg",
                                     tenant=hostile)] == 1.0
        assert parsed["gauges"][_key("depth_level", replica="r0",
                                     tenant=hostile)] == 1.0


# --------------------------------------------------- clock alignment
class TestClockOffsets:
    def test_known_skews_recovered(self):
        offsets = {"ra": 1234.5, "rb": -86.25}
        samples = {
            rid: [(p, p + off + jitter)
                  for p, jitter in ((10.0, 0.0002), (11.0, -0.0001),
                                    (12.0, 0.0003))]
            for rid, off in offsets.items()
        }
        got = estimate_offsets(samples)
        for rid, off in offsets.items():
            assert got[rid] == pytest.approx(off, abs=1e-3)

    def test_median_rejects_stalled_pair(self):
        # one heartbeat torn apart by a 5s scheduling stall between the
        # two stamps must not drag the estimate
        got = estimate_offsets({"r0": [(0.0, 100.0), (1.0, 101.0),
                                       (2.0, 102.0), (3.0, 108.0)]})
        assert got["r0"] == pytest.approx(100.0, abs=1e-9)

    def test_empty_samples_skipped(self):
        assert estimate_offsets({"r0": []}) == {}


# ------------------------------------------------- merged timelines
def _timeline_doc(tid, ts_list):
    events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
               "args": {"name": "overwritten"}}]
    for i, ts in enumerate(ts_list):
        events.append({"name": f"stage{i}", "ph": "X", "pid": 1,
                       "tid": tid, "ts": ts, "dur": 2.0,
                       "cat": "serving", "args": {}})
    return {"traceEvents": events}


class TestMergedTimeline:
    def test_tracks_rebased_monotone_and_loadable(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=30.0)
        skews = {"ra": 1000.0, "rb": 2000.0}
        for rid, off in skews.items():
            d.announce(ReplicaInfo(
                rid, state="serving",
                detail={"metrics_port": 1, "clock_perf": 5.0,
                        "clock_wall": 5.0 + off}))
        fed = FleetFederation(d, watchdog=False)
        try:
            fed._harvest_clock_pairs()
            docs = {"ra": _timeline_doc(1, [10.0, 20.0, 30.0]),
                    "rb": _timeline_doc(2, [15.0, 25.0])}

            def fake_fetch(rid, host, mport, path, count_errors=True):
                assert path == "/debug/timeline"
                return docs[rid]

            fed._fetch_json = fake_fetch
            doc = fed.fleet_chrome_trace()
            assert doc["otherData"]["processes"] == ["router", "ra", "rb"]
            # the document must survive a JSON round trip (what
            # export_fleet writes and Perfetto loads)
            doc = json.loads(json.dumps(doc))
            tracks = {e["pid"]: e["args"]["name"]
                      for e in doc["traceEvents"]
                      if e.get("ph") == "M"
                      and e.get("name") == "process_name"}
            assert sorted(tracks.values()) == ["replica ra", "replica rb",
                                               "router"]
            by_pid = {}
            for e in doc["traceEvents"]:
                if e.get("ph") == "M":
                    continue
                by_pid.setdefault(e["pid"], []).append(e["ts"])
            for pid, ts_list in by_pid.items():
                assert ts_list == sorted(ts_list), \
                    f"track {tracks[pid]} not monotone"
            # re-based onto the wall clock: ra's first event lands at
            # its local ts plus the 1000s skew (in microseconds)
            pid_ra = next(p for p, n in tracks.items()
                          if n == "replica ra")
            assert by_pid[pid_ra][0] == pytest.approx(10.0 + 1000.0 * 1e6)
            # the provider hook: export_fleet writes the same document
            out = timeline.export_fleet(str(tmp_path / "fleet.json"))
            with open(out) as f:
                exported = json.load(f)
            assert len(exported["traceEvents"]) \
                == len(doc["traceEvents"])
        finally:
            fed.stop()

    def test_replica_without_offset_is_skipped_not_fatal(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=30.0)
        d.announce(ReplicaInfo("rc", state="serving",
                               detail={"metrics_port": 1}))
        fed = FleetFederation(d, watchdog=False)
        try:
            fed._fetch_json = lambda *a, **k: _timeline_doc(1, [1.0])
            doc = fed.fleet_chrome_trace()
            assert doc["otherData"]["processes"] == ["router"]
            assert doc["otherData"]["skipped"] == ["rc"]
        finally:
            fed.stop()


# ------------------------------------------------------ scrape loop
class TestFederationScrape:
    def test_three_replica_aggregate_matches_hand_sums(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=30.0)
        servers, regs = [], {}
        tracer = telemetry.get_tracer()
        counters = {"m0": 3, "m1": 5, "m2": 7}
        depths = {"m0": 1.0, "m1": 2.0, "m2": 6.0}
        observations = {"m0": 0.05, "m1": 0.5, "m2": 2.0}
        fed = None
        local = None
        try:
            for rid in ("m0", "m1", "m2"):
                reg = MetricsRegistry()
                reg.counter("demo_requests_total",
                            status="ok").inc(counters[rid])
                reg.gauge("demo_depth_level").set(depths[rid])
                reg.histogram("demo_gather_seconds",
                              bounds=[0.1, 1.0]).observe(observations[rid])
                srv = MetricsServer(registry=reg, tracer=tracer)
                servers.append(srv)
                regs[rid] = reg
                d.announce(ReplicaInfo(
                    rid, state="serving",
                    detail={"metrics_port": srv.port,
                            "clock_perf": time.perf_counter(),
                            "clock_wall": time.time()}))
            fed = FleetFederation(d)
            assert fed.scrape_once() == 3
            view = fed.fleet_view()
            assert view["counters"][_key("demo_requests_total",
                                         status="ok")] == 15.0
            agg = view["gauges"][_key("demo_depth_level")]
            assert (agg["min"], agg["max"], agg["avg"]) == (1.0, 6.0, 3.0)
            hist = view["histograms"][_key("demo_gather_seconds")]
            assert hist["counts"] == [1, 1, 1]
            assert hist["sum"] == pytest.approx(2.55)
            # the HTTP surface re-serves the same numbers: GET
            # /metrics/fleet from any MetricsServer in this process
            local = MetricsServer()
            with urllib.request.urlopen(
                    f"{local.url}/metrics/fleet", timeout=5) as r:
                assert r.status == 200
                parsed, errors = parse_prometheus_text(
                    r.read().decode())
            assert errors == 0
            assert parsed["counters"][_key("demo_requests_total",
                                           status="ok")] == 15.0
            assert parsed["counters"][_key("demo_requests_total",
                                           replica="m1",
                                           status="ok")] == 5.0
            with urllib.request.urlopen(
                    f"{local.url}/debug/fleet/summary", timeout=5) as r:
                summary = json.loads(r.read())
            assert summary["active"] is True
            assert all(summary["replicas"][rid]["ok"]
                       for rid in ("m0", "m1", "m2"))
            assert set(summary["offsets_s"]) == {"m0", "m1", "m2"}
            assert "slo" in summary
            for rid in ("m0", "m1", "m2"):
                assert counter_value("fleet_federation_scrapes_total",
                                     replica=rid) >= 1
        finally:
            if fed is not None:
                fed.stop()
            if local is not None:
                local.close()
            for srv in servers:
                srv.close()

    def test_unreachable_target_ticks_scrape_errors(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=30.0)
        d.announce(ReplicaInfo("gone", state="serving",
                               detail={"metrics_port": _free_port()}))
        fed = FleetFederation(d, watchdog=False)
        try:
            before = counter_value("fleet_federation_scrape_errors_total",
                                   replica="gone")
            assert fed.scrape_once() == 0
            assert counter_value("fleet_federation_scrape_errors_total",
                                 replica="gone") == before + 1
            # the sweep completed and left a (empty) view standing
            assert fed.fleet_view()["replicas"] == []
            assert fed.summary()["replicas"]["gone"]["ok"] is False
        finally:
            fed.stop()

    def test_garbage_scrape_ticks_parse_errors_not_crash(self, tmp_path):
        d = MembershipDirectory(tmp_path, heartbeat_timeout_s=30.0)
        d.announce(ReplicaInfo("bad", state="serving",
                               detail={"metrics_port": 1}))
        fed = FleetFederation(d, watchdog=False)
        try:
            fed._fetch = lambda rid, url, count_errors=True: (
                b'this is { not prometheus\nx{y="z 1\n\x00\xff ok_total 1')
            before = counter_value("fleet_federation_parse_errors_total")
            assert fed.scrape_once() == 1  # scraped, degraded, survived
            assert counter_value(
                "fleet_federation_parse_errors_total") > before
            assert fed.summary()["replicas"]["bad"]["parse_errors"] > 0
        finally:
            fed.stop()


# -------------------------------------- cross-process tracing (e2e)
@pytest.fixture
def traced_fleet(tmp_path):
    """One in-process leader behind a federation-enabled router."""
    root = str(tmp_path / "dur")
    fdir = str(tmp_path / "fleet")
    with pconfig.override(fleet_ship_poll_ms=10.0,
                          fleet_ship_grace_ms=60.0):
        leader = FleetReplica("r0", fleet_dir=fdir, root=root,
                              graph_factory=_graph, role="leader",
                              heartbeat_s=0.1, device="cpu").boot()
        directory = MembershipDirectory(fdir, heartbeat_timeout_s=2.0)
        router = FleetRouter(directory, scan_ttl_s=0.0,
                             request_timeout_s=1.0, federation=True)
        routers = [router]

        def make_router(**kw):
            kw.setdefault("scan_ttl_s", 0.0)
            kw.setdefault("request_timeout_s", 1.0)
            r = FleetRouter(directory, **kw)
            routers.append(r)
            return r

        yield type("F", (), {"leader": leader, "router": router,
                             "directory": directory,
                             "make_router": staticmethod(make_router)})
        for r in routers:
            r.close()
        leader.stop()


def _wait_metrics_port(fed, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fed.targets():
            return
        time.sleep(0.05)
    raise AssertionError("replica never published its metrics port")


class TestFleetTraceEndToEnd:
    def test_reply_carries_fleet_qualified_trace_id(self, traced_fleet):
        reply = traced_fleet.router.request([1, 2], seq=0)
        assert reply["status"] == "ok"
        tid = reply["trace_id"]
        assert tid.startswith(traced_fleet.router.origin + ":")

    def test_hop_record_joins_replica_flight_record(self, traced_fleet):
        leader, router = traced_fleet.leader, traced_fleet.router
        ms = leader.expose_metrics()
        _wait_metrics_port(router.federation)
        reply = router.request([3, 4], seq=1)
        tid = reply["trace_id"]
        hop = router.hop_record(tid)
        assert hop is not None
        assert hop["status"] == "ok"
        assert hop["origin"] == router.origin
        assert hop["e2e_seconds"] >= 0.0
        assert [a["replica"] for a in hop["attempts"]] == ["r0"]
        assert hop["attempts"][0]["outcome"] == "ok"
        # the reconstruction joins that hop with the replica-side
        # flight record fetched over the replica's own debug endpoint
        doc = router.federation.reconstruct(tid)
        assert doc["found"] is True
        assert doc["router"]["trace_id"] == tid
        record = doc["replicas"]["r0"]
        assert record["trace_id"] == tid
        names = [e["name"] for e in record["events"]]
        assert "replica.queue" in names
        # ... and is served at GET /debug/fleet/trace/<id> (the id is
        # origin-qualified, so it travels percent-encoded)
        url = f"{ms.url}/debug/fleet/trace/{quote(tid, safe='')}"
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200
            served = json.loads(r.read())
        assert served["trace_id"] == tid
        assert served["found"] is True

    def test_unknown_trace_id_is_404(self, traced_fleet):
        ms = traced_fleet.leader.expose_metrics()
        url = (f"{ms.url}/debug/fleet/trace/"
               f"{quote('rtr-0:dead-beef', safe='')}")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 404

    def test_hop_ring_is_bounded(self, traced_fleet):
        with pconfig.override(fleet_trace_ring=4):
            router = traced_fleet.make_router(federation=True)
            for i in range(10):
                assert router.request([i], seq=i)["status"] == "ok"
            assert router.hop_count() <= 4
            # the newest records survived, the oldest aged out
            kept = [h["trace_id"] for h in router.hop_records()]
            assert len(kept) == 4


# ----------------------------------------------------- the off path
class TestFederationOff:
    def test_off_path_is_inert(self, traced_fleet):
        names_before = {t.name for t in threading.enumerate()}
        snap = telemetry.snapshot()
        keys_before = (set(snap["counters"]) | set(snap["gauges"])
                       | set(snap["histograms"]))
        router = traced_fleet.make_router(federation=False)
        assert router.federation is None
        assert router.federation_enabled is False
        for i in range(5):
            reply = router.request([i, i + 1], seq=i)
            assert reply["status"] == "ok"
            # no trace stamped on the wire, so the replica has nothing
            # to rehydrate and the reply carries no trace_id
            assert "trace_id" not in reply
        assert router.hop_count() == 0
        assert router.start_federation() is router  # documented no-op
        new_threads = {t.name for t in threading.enumerate()} \
            - names_before
        assert not [n for n in new_threads if "federation" in n]
        snap = telemetry.snapshot()
        new_keys = (set(snap["counters"]) | set(snap["gauges"])
                    | set(snap["histograms"])) - keys_before
        assert not [k for k in new_keys
                    if k.startswith("fleet_federation")]

    def test_default_config_is_off(self, traced_fleet):
        # cfg.fleet_federation defaults to "off": a router constructed
        # without the kwarg resolves the flag ONCE and stays inert
        router = traced_fleet.make_router()
        assert router.federation_enabled is False
        assert router.federation is None
