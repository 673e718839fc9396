"""Port parity: the metrics registry, spans, the exporter, the SLO
watchdog, the per-program profile, and the host counters that land in the
registry.

- The same counter, gauge and histogram operations leave equal snapshots,
  ``snapshot_delta``\\ s, merges, summaries and Prometheus text in the
  port's registry and the JAX package's; bad label values raise alike.
- ``QUIVER_TELEMETRY`` off: every helper answers with the shared noop.
- Spans aggregate alike; ``block=`` takes tensors.
- The exporter serves every ported route on ``127.0.0.1:0`` and 404 for
  the routes of modules not ported yet.
- The SLO watchdog scores the same windows alike.
- ``profile`` records the kernel wrappers and the server's forwards, with
  ``device: false`` on the CPU.
- UVA, sampler, feature and mixed operations leave the same counters in
  the port's registry as in JAX's (JAX's telemetry on; the device
  sampler's ``mode`` label is ``gpu`` in the port where JAX's is ``tpu``).
"""

import json
import queue
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.mixed import MixedGraphSageSampler as JaxMixed
from quiver_tpu.mixed import RangeSampleJob as JaxJob
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.telemetry import export as jexport
from quiver_tpu.telemetry import registry as jreg
from quiver_tpu.telemetry import slo as jslo
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.mixed import RangeSampleJob
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.telemetry import export as pexport
from quiver_tpu_torch.telemetry import noop as pnoop
from quiver_tpu_torch.telemetry import profile as pprofile
from quiver_tpu_torch.telemetry import registry as preg
from quiver_tpu_torch.telemetry import slo as pslo

N, SIZES = 700, [4, 3]

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The port's registry, tracer, recorder, timeline, profile, watchdog,
    breakers and QoS controller are process-wide: each test starts and
    ends with them empty.  JAX's telemetry is on for the test and back at
    its process default after, its registry emptied."""
    ptel.set_enabled(True)
    ptel.reset()
    pqos.reset()
    jtel.set_enabled(True)
    jtel.reset()
    yield
    ptel.reset()
    pqos.reset()
    ptel.set_enabled(True)
    jtel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _drive(reg, seed: int):
    """One seeded sequence of registry operations."""
    rng = np.random.default_rng(seed)
    for i in range(200):
        lane = ["device", "cpu", "failover"][rng.integers(3)]
        op = rng.integers(4)
        if op == 0:
            reg.counter("req_total", lane=lane).inc(float(rng.integers(1, 4)))
        elif op == 1:
            reg.gauge("depth", lane=lane).set(float(rng.integers(0, 50)))
        elif op == 2:
            reg.histogram("lat_seconds", lane=lane).observe(
                float(rng.lognormal(-5, 1.5)))
        else:
            reg.histogram("sizes", bounds=(1, 8, 64, 512)).observe(
                float(rng.integers(0, 1000)))
    reg.counter("with_help_total", help="a counter\nwith help").inc()


def test_registry_snapshots_match_jax():
    pr, jr = preg.MetricsRegistry(), jreg.MetricsRegistry()
    _drive(pr, 1)
    _drive(jr, 1)
    ps, js = pr.snapshot(), jr.snapshot()
    assert ps == js
    assert preg.summarize_snapshot(ps) == jreg.summarize_snapshot(js)
    assert pexport.to_prometheus_text(ps) == jexport.to_prometheus_text(js)
    assert pexport.to_json(ps) == jexport.to_json(js)
    # a second window: deltas, then merged into fresh registries
    _drive(pr, 2)
    _drive(jr, 2)
    pd = preg.snapshot_delta(ps, pr.snapshot())
    jd = jreg.snapshot_delta(js, jr.snapshot())
    assert pd == jd and pd["counters"]
    pm, jm = preg.MetricsRegistry(), jreg.MetricsRegistry()
    for snap in (ps, pd):
        pm.merge(snap)
    for snap in (js, jd):
        jm.merge(snap)
    assert pm.snapshot() == jm.snapshot()
    assert pexport.to_prometheus_text(pm.snapshot()) == \
        jexport.to_prometheus_text(jm.snapshot())


@pytest.mark.parametrize("key", ["a{b=1,c=x}", "plain", "a{}", "a{x=}"])
def test_metric_keys_match_jax(key):
    assert preg.parse_metric_key(key) == jreg.parse_metric_key(key)
    name, labels = jreg.parse_metric_key(key)
    assert preg.metric_key(name, labels) == jreg.metric_key(name, labels)


@pytest.mark.parametrize("bad", ["a,b", "a=b", "x}", 'q"'])
def test_bad_label_values_raise_alike(bad):
    with pytest.raises(ValueError) as pe:
        preg.metric_key("m", {"k": bad})
    with pytest.raises(ValueError) as je:
        jreg.metric_key("m", {"k": bad})
    assert str(pe.value) == str(je.value)
    pr, jr = preg.MetricsRegistry(), jreg.MetricsRegistry()
    pr.counter("m").inc()
    jr.counter("m").inc()
    with pytest.raises(TypeError):
        pr.gauge("m")
    with pytest.raises(TypeError):
        jr.gauge("m")


def test_disabled_telemetry_answers_with_the_noop():
    ptel.set_enabled(False)
    assert ptel.counter("x", a=1) is pnoop.METRIC
    assert ptel.histogram("h") is pnoop.METRIC
    assert ptel.span("s") is pnoop.SPAN
    assert ptel.get_registry() is pnoop.REGISTRY
    ptel.counter("x").inc()
    ptel.set_enabled(True)
    assert ptel.snapshot() == {"counters": {}, "gauges": {},
                               "histograms": {}}


def test_spans_aggregate_as_jax():
    pt, jt = ptel.SpanTracer(tracing=True), jtel.SpanTracer(tracing=True)
    for tracer in (pt, jt):
        for _ in range(3):
            with tracer.span("outer"):
                with tracer.span("inner"):
                    pass
    ps, js = pt.summary(), jt.summary()
    assert {k: v["count"] for k, v in ps.items()} == \
        {k: v["count"] for k, v in js.items()} == {"outer": 3, "inner": 3}
    evs = pt.parse_chrome_trace(json.dumps(pt.chrome_trace()))
    assert [e["name"] for e in evs] == [e["name"] for e in pt.events()]
    assert sorted(e["depth"] for e in evs) == [0, 0, 0, 1, 1, 1]
    # block= takes a tensor or a list of them (CPU tensors are ready)
    with pt.span("blocked", block=[torch.ones(3), torch.zeros(2)]):
        pass
    with pt.span("blocked", block=torch.ones(3)):
        pass
    assert pt.summary()["blocked"]["count"] == 2


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def test_exporter_routes():
    ptel.counter("serving_requests_total", lane="device", status="ok").inc(3)
    ptel.histogram("serving_request_seconds", lane="device").observe(0.01)
    health = {"ready": False}
    srv = pexport.MetricsServer(host="127.0.0.1", port=0,
                                health_fn=lambda: dict(health))
    plain = pexport.start_http_server(port=0)
    try:
        code, text = _get(srv.url + "/metrics")
        assert code == 200
        assert text == pexport.to_prometheus_text(ptel.snapshot())
        assert 'serving_requests_total{lane="device",status="ok"} 3' in text
        code, body = _get(srv.url + "/metrics.json")
        assert code == 200 and json.loads(body) == ptel.snapshot()
        for route in ("/debug/requests", "/debug/breakers", "/debug/qos",
                      "/debug/slo", "/debug/timeline", "/debug/programs",
                      "/trace.json"):
            code, body = _get(srv.url + route)
            assert code == 200, route
            json.loads(body)
        assert json.loads(_get(srv.url + "/debug/qos")[1]) == {
            "enabled": False, "installed": False}
        assert _get(srv.url + "/healthz")[0] == 503
        health["ready"] = True
        assert _get(srv.url + "/healthz")[0] == 200
        # without a health_fn, /healthz answers through the recovery
        # manager: no manager is active, so the process is serving
        code, body = _get(plain.url + "/healthz")
        assert code == 200 and json.loads(body) == {
            "state": "serving", "ready": True, "stale": False,
            "managed": False}
        for route in ("/metrics/fleet", "/debug/fleet",
                      "/debug/fleet/summary",
                      "/debug/requests/nope", "/nothing"):
            assert _get(plain.url + route)[0] == 404, route
        # the mesh tier is ported: /debug/mesh answers mesh_status()
        code, body = _get(plain.url + "/debug/mesh")
        assert code == 200 and "active" in json.loads(body)
        req = urllib.request.Request(srv.url + "/metrics", method="HEAD")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200 and r.read() == b""
            assert int(r.headers["Content-Length"]) == len(text.encode())
    finally:
        srv.close()
        plain.close()


def test_slo_watchdog_scores_as_jax():
    pr, jr = preg.MetricsRegistry(), jreg.MetricsRegistry()
    pw = pslo.SLOWatchdog(registry=pr, p99_ms=20, error_ratio=0.1,
                          coldcache_hit_floor=0.5)
    jw = jslo.SLOWatchdog(registry=jr, p99_ms=20, error_ratio=0.1,
                          coldcache_hit_floor=0.5)
    breaches = []
    for tick in range(4):
        for reg in (pr, jr):
            r = np.random.default_rng(tick)
            for _ in range(50):
                reg.histogram("serving_request_seconds", lane="device"
                              ).observe(float(r.lognormal(-4 + tick, 1)))
                reg.counter("serving_requests_total", lane="device",
                            status="ok" if r.random() > 0.05 * tick
                            else "error").inc()
                reg.counter("feature_coldcache_rows_total",
                            result="hit" if r.random() > 0.2 * tick
                            else "miss").inc()
        got = pw.evaluate_once()
        assert got == jw.evaluate_once()
        breaches += [r["objective"] for r in got if r["breaching"]]
    assert {"p99_latency", "error_ratio", "coldcache_hit_rate"} <= set(
        breaches)
    # status() scores the (now empty) window since the last tick
    assert pw.status()["objectives"] == jw.status()["objectives"]
    # the breaches tick the process registry, as JAX's do its own
    assert ptel.snapshot()["counters"] == {
        f"slo_breaches_total{{objective={o}}}": float(breaches.count(o))
        for o in set(breaches)}


def test_profile_records_kernels_and_forwards():
    from quiver_tpu_torch.ops.cuda.gather_rows import gather_rows

    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([3, 1, 9], dtype=torch.int32)
    gather_rows(table, idx)
    assert pprofile.stats() == {}  # off: nothing recorded
    assert pprofile.enable()
    for _ in range(2):
        gather_rows(table, idx)
    indptr, indices = qt.synthetic_csr(200, 1500, seed=3)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    feat = np.random.default_rng(0).standard_normal((200, 6)).astype(
        np.float32)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu")
    model = qt.GraphSAGE(6, 8, 3, num_layers=2, device="cpu")
    server = qt.InferenceServer(sampler, feature, model, queue.Queue())
    server.BUCKETS = (8, 16)
    server._run_bucketed(np.arange(11))
    rows = {(r["subsystem"], r["key"]): r for r in pprofile.top_programs()}
    g = rows[("kernel", "'gather_rows'")]
    assert g["calls"] == 2 + 1 and g["device"] is False
    assert g["device_mean_ms"] is None
    assert ("kernel", "'window_sample_frontier'") in rows
    assert rows[("serving", "('fused', 16)")]["calls"] == 1
    hists = ptel.snapshot()["histograms"]
    assert hists["program_time_seconds{subsystem=kernel}"]["counts"]
    payload = pprofile.debug_payload()
    assert payload["enabled"] and payload["programs"] == len(rows)
    pprofile.disable()
    gather_rows(table, idx)
    assert pprofile.stats()[("kernel", "'gather_rows'")][0] == 3


# -- the host counters in the registry --------------------------------------

def _port_counters(prefixes):
    return {k: v for k, v in ptel.snapshot()["counters"].items()
            if k.startswith(prefixes) and v}


def _jax_counters(prefixes):
    return {k.replace("mode=tpu", "mode=gpu"): v
            for k, v in jtel.snapshot()["counters"].items()
            if k.startswith(prefixes) and v}


def _hop_words(key, n):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n)], np.uint32)


@pytest.fixture(scope="module")
def graph():
    indptr, indices = qt.synthetic_csr(N, 8_000, seed=23)
    return indptr, indices


def test_sampler_and_uva_counters_match_jax(graph):
    indptr, indices = graph
    jt, pt = (JaxTopo(indptr=indptr, indices=indices),
              qt.CSRTopo(indptr=indptr, indices=indices))
    e = int(indptr[-1])
    juva = JaxSampler(jt, SIZES, mode="UVA", uva_budget=e * 4 // 3,
                      gather_mode="xla", sample_rng="hash")
    puva = qt.GraphSageSampler(pt, SIZES, mode="UVA", uva_budget=e * 4 // 3,
                               device="cpu")
    jcpu = JaxSampler(jt, SIZES, mode="CPU")
    pcpu = qt.GraphSageSampler(pt, SIZES, mode="CPU", device="cpu")
    caps = [None, 60]
    jhop = JaxSampler(jt, SIZES, gather_mode="xla", sample_rng="hash",
                      dedup="hop", frontier_caps=caps)
    phop = qt.GraphSageSampler(pt, SIZES, device="cpu", dedup="hop",
                               frontier_caps=caps)
    rng = np.random.default_rng(2)
    for i in range(3):
        seeds = rng.integers(0, N, 24)
        key = make_key(40 + i)
        keys = jax.random.split(key, len(SIZES))
        juva.sample(seeds, key=key)
        puva.sample(seeds, key_words=_hop_words(key, len(SIZES)),
                    host_seeds=np.asarray(jax.random.key_data(keys))[:, -1])
        jcpu.sample(seeds)
        pcpu.sample(seeds)
        jhop.sample(seeds, key=key)
        phop.sample(seeds, key_words=_hop_words(key, len(SIZES)))
        np.testing.assert_array_equal(phop.overflow_stats(),
                                      jhop.overflow_stats())
    prefixes = ("uva_", "sampler_")
    got, want = _port_counters(prefixes), _jax_counters(prefixes)
    assert got == want
    assert got["sampler_frontier_drops_total{mode=gpu}"] > 0
    assert got["uva_seeds_total{tier=cold}"] > 0
    ph, jh = ptel.snapshot()["histograms"], jtel.snapshot()["histograms"]
    for key in ("uva_host_tier_seconds", "sampler_sample_seconds{mode=cpu}",
                "sampler_sample_seconds{mode=uva}"):
        assert sum(ph[key]["counts"]) == sum(jh[key]["counts"]), key
    assert puva._uva.counters == {k: v for k, v in got.items()
                                  if k.startswith("uva_seeds_total")}


def test_feature_counters_match_jax(graph):
    indptr, indices = graph
    feat = np.random.default_rng(1).standard_normal((N, 8)).astype(
        np.float32)
    jf = JaxFeature(device_cache_size=200 * 32, csr_topo=JaxTopo(
        indptr=indptr, indices=indices)).from_cpu_tensor(feat)
    pf = qt.Feature(device_cache_size=200 * 32, csr_topo=qt.CSRTopo(
        indptr=indptr, indices=indices), device="cpu").from_cpu_tensor(feat)
    jf.enable_cold_cache(64)
    pf.enable_cold_cache(64)
    rng = np.random.default_rng(4)
    for _ in range(4):
        ids = rng.integers(0, N, 90)
        np.testing.assert_array_equal(pf[ids].numpy(), np.asarray(jf[ids]))
    prefixes = ("feature_rows_total", "feature_coldcache_",
                "feature_gather_batches_total")
    got = _port_counters(prefixes)
    assert got == _jax_counters(prefixes)
    assert got == {k: float(v) for k, v in pf.stats()["counters"].items()
                   if k.startswith(prefixes) and v}
    assert got["feature_coldcache_rows_total{result=hit}"] > 0
    assert "feature_h2d_bytes_total" in ptel.snapshot()["counters"]
    assert ptel.snapshot()["histograms"][
        "feature_gather_seconds{tier=mixed}"]["counts"]


@pytest.mark.parametrize("mode", ["TPU_ONLY", "CPU_ONLY"])
def test_mixed_counters_match_jax(graph, mode):
    indptr, indices = graph
    jm = JaxMixed(JaxTopo(indptr=indptr, indices=indices), SIZES,
                  JaxJob(np.arange(300), 64), mode=mode, num_workers=2)
    pm = qt.MixedGraphSageSampler(
        qt.CSRTopo(indptr=indptr, indices=indices), SIZES,
        RangeSampleJob(np.arange(300), 64), device="cpu", mode=mode,
        num_workers=2)
    assert len(list(jm)) == len(list(pm)) == 5
    got = _port_counters(("mixed_",))
    assert got == _jax_counters(("mixed_",))
    lane = "tpu" if mode == "TPU_ONLY" else "cpu"
    assert got == {f"mixed_tasks_total{{lane={lane}}}": 5.0}
    pg, jg = ptel.snapshot()["gauges"], jtel.snapshot()["gauges"]
    key = f"mixed_avg_task_seconds{{lane={lane}}}"
    assert set(k for k in pg if k.startswith("mixed_")) == \
        set(k for k in jg if k.startswith("mixed_")) == {key}
    assert pg[key] == pytest.approx(pm.avg_tpu_time if lane == "tpu"
                                    else pm.avg_cpu_time)


def test_thread_leak_is_counted():
    import threading

    from quiver_tpu_torch.utils.shutdown import join_and_reap

    gate = threading.Event()
    t = threading.Thread(target=gate.wait, daemon=True)
    t.start()
    try:
        assert join_and_reap([t], 0.01, component="test") == [t]
    finally:
        gate.set()
        t.join(timeout=5)
    assert ptel.snapshot()["counters"] == {
        "serving_thread_leak_total{component=test}": 1.0}


def test_server_starts_and_stops_its_watchdog_and_exporter():
    """``start_slo_watchdog`` and ``expose_metrics`` run until the server
    stops; the watchdog ticks on its own thread meanwhile."""
    from quiver_tpu_torch import config

    indptr, indices = qt.synthetic_csr(100, 600, seed=1)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    feat = np.zeros((100, 4), np.float32)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    server = qt.InferenceServer(qt.GraphSageSampler(topo, [2], device="cpu"),
                                feature, qt.GraphSAGE(4, 4, 2, num_layers=1,
                                                      device="cpu"),
                                queue.Queue())
    with config.override(slo_interval_s=0.01):
        server.start()
        try:
            wd = server.start_slo_watchdog()
            srv = server.expose_metrics(port=0)
            assert _get(srv.url + "/debug/slo")[0] == 200
            deadline = 200
            while wd.status()["ticks"] < 3 and deadline:
                deadline -= 1
                threading.Event().wait(0.01)
            assert wd.status()["running"] and wd.status()["ticks"] >= 3
        finally:
            assert server.stop() == []
    assert not wd.status()["running"]
    with pytest.raises(OSError):
        _get(srv.url + "/metrics")
