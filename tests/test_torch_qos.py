"""Port parity: multi-tenant QoS (``quiver_tpu_torch/resilience/qos.py``)
against the JAX package.

- ``parse_tenant_spec`` gives the same classes, and malformed specs raise
  the same errors.
- Token buckets under one scripted clock take and refuse alike, with the
  same retry-after hints; ``QoSController.admit`` stamps, admits, rejects
  and sheds the same requests with the same answers and counters.
- The degradation ladder steps down and up at the same ticks; the
  serving ladder scales the host sampler's fanout, pauses the overlay's
  admission (``ColdRowCache.admission_paused``), routes the floor class to
  the CPU lane and sheds it, as JAX's does.
- ``RequestBatcher(qos=)`` answers the same requests on the same lanes.
"""

import queue

import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.ops.coldcache import ColdRowCache as JaxColdCache
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.serving import RequestBatcher as JaxBatcher
from quiver_tpu.serving import ServingRequest as JaxRequest

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.ops.coldcache import ColdRowCache
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.telemetry import slo as pslo

_JAX_TELEMETRY_DEFAULT = jtel.enabled()
SPEC = ("gold:rate=4,burst=3,weight=8,priority=3;"
        "silver:rate=2,burst=2,weight=4,priority=2;"
        "bronze:rate=1,burst=1,weight=1,priority=0;"
        "ingest:rate=5,burst=5,weight=1,priority=0")


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """The registries and installed controllers are process-wide in both
    packages: each test starts and ends with them empty; JAX's telemetry
    is on for the test and back at its process default after."""
    for tel, qos in ((ptel, pqos), (jtel, jqos)):
        tel.set_enabled(True)
        tel.reset()
        qos.reset()
    yield
    for tel, qos in ((ptel, pqos), (jtel, jqos)):
        qos.reset()
        tel.reset()
    ptel.set_enabled(True)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


class Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _counters(tel, prefix="serving_"):
    return {k: v for k, v in tel.snapshot()["counters"].items()
            if k.startswith(prefix)}


def test_tenant_specs_parse_as_jax():
    assert pqos.parse_tenant_spec(SPEC) == {
        k: pqos.TenantClass(**vars(v))
        for k, v in jqos.parse_tenant_spec(SPEC).items()}
    for bad in ("", ";;", ":rate=1", "a:speed=3", "a:rate=0",
                "a:burst=-1", "a:rate=x"):
        with pytest.raises(ValueError) as pe:
            pqos.parse_tenant_spec(bad)
        with pytest.raises(ValueError) as je:
            jqos.parse_tenant_spec(bad)
        assert str(pe.value) == str(je.value), bad
    with pytest.raises(ValueError, match="default tenant"):
        pqos.QoSController(pqos.parse_tenant_spec(SPEC), default="nobody")


def test_token_buckets_match_jax():
    pc, jc = Clock(), Clock()
    pb = pqos.TokenBucket(3.0, 2.0, clock=pc)
    jb = jqos.TokenBucket(3.0, 2.0, clock=jc)
    for dt, n in ((0, 1), (0, 1), (0, 1), (0.1, 1), (0.2, 1), (1.0, 2),
                  (0.05, 0.5), (0, 3)):
        pc.t += dt
        jc.t += dt
        assert pb.try_take(n) == jb.try_take(n)
        assert pb.tokens == jb.tokens


def _admit_run(qos_mod, make, tel):
    clock = Clock()
    ctl = qos_mod.QoSController(qos_mod.parse_tenant_spec(SPEC),
                                default="bronze", ingest="ingest",
                                clock=clock)
    results = queue.Queue()
    out = []
    tenants = ["gold", "silver", "bronze", None, "mallory", "gold"]
    for i in range(30):
        if i % 7 == 6:
            clock.t += 0.4
        if i == 20:
            ctl.shed_floor = True
        r = make(ids=np.arange(2), client=0, seq=i, tenant=tenants[i % 6])
        ok = ctl.admit(r, results)
        out.append((i, ok, r.tenant_class, r.priority))
    answers = []
    while not results.empty():
        req, exc = results.get_nowait()
        answers.append((req.seq, type(exc).__name__,
                        round(getattr(exc, "retry_after_s", 0.0), 9)))
    return out, answers, _counters(tel), ctl.floor, ctl.status()


def test_admission_matches_jax():
    port = _admit_run(pqos, qt.ServingRequest, ptel)
    ref = _admit_run(jqos, JaxRequest, jtel)
    assert port == ref
    kinds = {a[1] for a in port[1]}
    assert kinds == {"QuotaExceeded", "LoadShed"} and port[3] == "bronze"


def _ladder_run(qos_mod, tel, sampler, cache):
    ctl = qos_mod.QoSController(qos_mod.parse_tenant_spec(SPEC),
                                default="bronze", ingest="ingest")
    ladder = qos_mod.serving_ladder(ctl, sampler=sampler, cold_cache=cache,
                                    fanout_frac=0.5, breach_ticks=2,
                                    recover_ticks=3)
    seen = []
    for breaching in [1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0,
                      0, 0, 0, 0, 0, 0, 0]:
        level = ladder.observe(bool(breaching))
        seen.append((level, sampler._fanout_frac, cache.admission_paused,
                     ctl.route_floor_to_cpu, ctl.shed_floor))
    hist = [(h["direction"], h["step"], h["level"])
            for h in ladder.status()["history"]]
    gauges = {k: v for k, v in tel.snapshot()["gauges"].items()
              if k.startswith("serving_")}
    return seen, hist, _counters(tel), gauges


def test_serving_ladder_matches_jax():
    from quiver_tpu.sampler import GraphSageSampler as JaxSampler
    from quiver_tpu.utils.topology import CSRTopo as JaxTopo

    indptr, indices = qt.synthetic_csr(200, 1200, seed=2)
    ps = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             [4, 3], mode="CPU", device="cpu")
    js = JaxSampler(JaxTopo(indptr=indptr, indices=indices), [4, 3],
                    mode="CPU")
    port = _ladder_run(pqos, ptel, ps, ColdRowCache(8, 100))
    ref = _ladder_run(jqos, jtel, js, JaxColdCache(8, 100))
    assert port == ref
    levels = [s[0] for s in port[0]]
    assert max(levels) == 4 and levels[-1] == 0


def test_paused_overlay_admits_nothing():
    for cache in (ColdRowCache(4, 50), JaxColdCache(4, 50)):
        ids = np.array([1, 2, 3])
        for _ in range(2):
            cache.probe(ids)
        cache.admission_paused = True
        slots, evicted = cache.admit(ids)
        assert (slots == -1).all() and evicted == 0
        cache.admission_paused = False
        slots, _ = cache.admit(ids)
        assert (slots >= 0).all()


def test_ladder_attaches_to_the_watchdog():
    ctl = pqos.QoSController(pqos.parse_tenant_spec(SPEC), default="bronze",
                             ingest="ingest")
    ladder = pqos.serving_ladder(ctl, breach_ticks=1, recover_ticks=1)
    wd = pslo.SLOWatchdog(p99_ms=1.0, error_ratio=0.5)
    ladder.attach(wd, objectives=("p99_latency",))
    ptel.histogram("serving_request_seconds", lane="device").observe(0.5)
    wd.evaluate_once()
    assert ladder.level == 1
    wd.evaluate_once()  # an empty window is healthy
    assert ladder.level == 0
    assert pqos.install_qos(ctl) is pqos.get_qos() is ctl
    st = pqos.qos_status()
    assert st["installed"] and st["ladder"]["max_level"] == 4


def _batcher_run(make, batcher_cls, qos_mod, tel, route_floor: bool):
    ctl = qos_mod.QoSController(qos_mod.parse_tenant_spec(SPEC),
                                default="bronze", ingest="ingest",
                                clock=Clock())
    ctl.route_floor_to_cpu = route_floor
    results = queue.Queue()
    rb = batcher_cls([queue.Queue()], neighbour_num=np.ones(100),
                     threshold=2.0, mode="Auto", result_queue=results,
                     qos=ctl)
    for i in range(12):
        rb._route(make(ids=np.arange(1 + i % 4), client=0, seq=i,
                       tenant=["gold", "bronze", "silver"][i % 3]))
    lanes = {}
    for name in ("device", "cpu"):
        q = getattr(rb, f"{name}_batched_queue")
        lanes[name] = [q.get_nowait().seq for _ in range(q.qsize())]
    answered = []
    while not results.empty():
        req, exc = results.get_nowait()
        answered.append((req.seq, type(exc).__name__))
    return lanes, answered, _counters(tel)


@pytest.mark.parametrize("route_floor", [False, True])
def test_batcher_admission_matches_jax(route_floor):
    port = _batcher_run(qt.ServingRequest, qt.RequestBatcher, pqos, ptel,
                        route_floor)
    ref = _batcher_run(JaxRequest, JaxBatcher, jqos, jtel, route_floor)
    assert port == ref
    assert port[1]  # someone was over quota
