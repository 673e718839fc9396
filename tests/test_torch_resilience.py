"""Port parity: ``quiver_tpu_torch.resilience`` (errors, backoff, chaos,
breakers, deadlines, bounded and weighted-fair lanes) and the server's
failover, against the JAX package on the same inputs.

- ``ChaosPlan`` fire logs, ``_hash01`` and the injection counters are
  equal for the same seed, points and hits.
- Breakers step through the same states, answer ``allow`` alike and tick
  the same metrics under one scripted clock.
- ``BoundedLane`` and ``WeightedFairLane`` shed the same requests, with
  the same typed answers, and drain in the same order.
- The server on a 1,500-node graph with ``max_coalesce=1`` and one
  ``ChaosPlan`` on ``serving.device_lane``: the same request sequence
  through JAX's and the port's servers gives the same (seq, status, lane,
  error type) answers and the same ``serving_*`` counters; the failover
  answers' logits agree within ``rtol = atol = 1e-5`` (both native host
  samplers fresh, called in the same order).
"""

import queue
import random
import time

import jax
import numpy as np
import pytest

from quiver_tpu import config as jconfig
from quiver_tpu import telemetry as jtel
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
from quiver_tpu.resilience import breaker as jbreaker
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import errors as jerrors
from quiver_tpu.resilience import lanes as jlanes
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.resilience import retry as jretry
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.serving import InferenceServer as JaxServer
from quiver_tpu.serving import ServingRequest as JaxRequest
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.resilience import breaker as pbreaker
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.resilience import errors as perrors
from quiver_tpu_torch.resilience import lanes as planes
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.resilience import retry as pretry
from quiver_tpu_torch.telemetry import flightrec as pflightrec

TOL = dict(rtol=1e-5, atol=1e-5)
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Breakers, chaos plans, QoS, the recorder and the registries are
    process-wide in both packages: each test starts and ends with them
    empty.  JAX's telemetry is on for the test and back at its process
    default after."""
    for tel, chaos, qos in ((ptel, pchaos, pqos), (jtel, jchaos, jqos)):
        tel.set_enabled(True)
        tel.reset()
        chaos.uninstall()
        qos.reset()
    yield
    for tel, chaos, qos in ((ptel, pchaos, pqos), (jtel, jchaos, jqos)):
        chaos.uninstall()
        qos.reset()
        tel.reset()
    ptel.set_enabled(True)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _counters(tel, prefixes):
    return {k: v for k, v in tel.snapshot()["counters"].items()
            if k.startswith(prefixes)}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_errors_read_alike():
    for name, args in (("DeadlineExceeded", (12.5, 10.0, "device")),
                       ("LoadShed", ("watermark", "cpu")),
                       ("QuotaExceeded", ("gold", 0.25)),
                       ("LaneUnavailable", ("device",)),
                       ("ChaosFault", ("p", 3))):
        pe, je = getattr(perrors, name)(*args), getattr(jerrors, name)(*args)
        assert str(pe) == str(je) and isinstance(pe, perrors.ResilienceError)


def test_backoff_and_retry_match_jax():
    for kw in (dict(base_s=0.1), dict(base_s=0.05, cap_s=0.3, jitter=0.2),
               dict(base_s=1.0, multiplier=3.0, jitter=0.5)):
        pb = pretry.Backoff(rng=random.Random(4), **kw)
        jb = jretry.Backoff(rng=random.Random(4), **kw)
        assert [pb.delay(a) for a in range(8)] == \
            [jb.delay(a) for a in range(8)]
    for bad in (dict(base_s=-1), dict(base_s=1, multiplier=0.5),
                dict(base_s=1, jitter=1.0)):
        with pytest.raises(ValueError):
            pretry.Backoff(**bad)
    slept = {"p": [], "j": []}

    def flaky(n):
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] < n:
                raise OSError(calls[0])
            return calls[0]
        return fn

    for mod, k in ((pretry, "p"), (jretry, "j")):
        assert mod.retry_call(flaky(3), attempts=4,
                              backoff=mod.Backoff(0.01),
                              retry_on=(OSError,),
                              sleep=slept[k].append) == 3
        with pytest.raises(OSError):
            mod.retry_call(flaky(9), attempts=2, retry_on=(OSError,),
                           sleep=slept[k].append)
    assert slept["p"] == slept["j"] == [0.01, 0.02]


def test_chaos_plans_replay_as_jax():
    for seed in (0, 7, 123):
        for name in ("serving.device_lane", "x", "fleet.route"):
            for idx in range(50):
                assert pchaos._hash01(seed, name, idx) == \
                    jchaos._hash01(seed, name, idx)
    logs = []
    for chaos, tel in ((pchaos, ptel), (jchaos, jtel)):
        plan = (chaos.ChaosPlan(seed=11)
                .fail("serving.device_lane", times=2, after=1)
                .fail("serving.cpu_lane", rate=0.3, times=None)
                .fail("serving.hybrid_sampler", exc=KeyError, every=3,
                      times=3)
                .delay("serving.cpu_lane", 1e-4, times=2, after=40))
        raised = []
        with chaos.active(plan):
            for i in range(60):
                for name in ("serving.device_lane", "serving.cpu_lane",
                             "serving.hybrid_sampler"):
                    try:
                        chaos.point(name)()
                    except Exception as e:  # noqa: BLE001
                        raised.append((name, i, type(e).__name__))
        assert chaos.current_plan() is None
        chaos.point("serving.device_lane")()  # disarmed: a no-op
        logs.append((plan.log(), raised,
                     _counters(tel, ("chaos_injections_total",)),
                     plan.hits("serving.cpu_lane")))
    assert logs[0] == logs[1]
    assert logs[0][2]["chaos_injections_total{point=serving.cpu_lane}"] > 2


SCRIPT = ["allow", "fail", "allow", "fail", "allow", "fail", "allow",
          ("tick", 5.0), "allow", ("tick", 6.0), "allow", "allow", "fail",
          "allow", ("tick", 10.5), "allow", ("tick", 10.0), "allow", "fail",
          ("tick", 25.0), "allow", "ok", "allow", "ok", "fail", "allow"]


def test_breakers_step_as_jax():
    traces = []
    for mod, tel in ((pbreaker, ptel), (jbreaker, jtel)):
        clock = Clock()
        br = mod.CircuitBreaker("serving.device", failure_threshold=3,
                                reset_timeout_s=10.0, half_open_probes=1,
                                clock=clock)
        out = []
        for step in SCRIPT:
            if isinstance(step, tuple):
                clock.t += step[1]
            elif step == "allow":
                out.append(br.allow())
            elif step == "ok":
                br.record_success()
            else:
                br.record_failure()
            out.append((br.state, br.status()))
        reg = tel.snapshot()
        traces.append((out, mod.breakers_status(),
                       _counters(tel, ("serving_breaker",)),
                       {k: v for k, v in reg["gauges"].items()
                        if k.startswith("serving_breaker")}))
        assert mod.get_breaker("serving.device") is br
    assert traces[0] == traces[1]
    states = [o[0] for o in traces[0][0] if isinstance(o, tuple)]
    assert {"open", "half_open", "closed"} <= set(states)


def _requests(make, n=14):
    """``n`` requests of varied size, priority and class; two already past
    their deadline."""
    reqs = []
    for i in range(n):
        r = make(ids=np.arange(1 + (i * 5) % 9), client=0, seq=i,
                 priority=int((i * 7) % 4), tenant=None)
        r.tenant_class = ("gold", "bronze", "silver")[i % 3]
        if i in (4, 9):
            r.deadline = time.perf_counter() - 1.0
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("fair", [False, True])
def test_lanes_shed_and_drain_as_jax(fair):
    runs = []
    for lanes, make in ((planes, qt.ServingRequest), (jlanes, JaxRequest)):
        results = queue.Queue()
        kw = dict(maxsize=6, high=0.8, low=0.5, result_queue=results)
        lane = (lanes.WeightedFairLane(
            "device", {"gold": 4, "silver": 2, "bronze": 1},
            default_class="bronze", quantum=3, **kw) if fair
            else lanes.BoundedLane("device", **kw))
        ctrl = object()
        drained, shed = [], []
        for i, r in enumerate(_requests(make)):
            lane.put(r)
            if i == 6:
                lane.put(ctrl)
                for _ in range(3):
                    item = lane.get_nowait()
                    drained.append("ctrl" if item is ctrl else item.seq)
        while True:
            try:
                item = lane.get_nowait()
            except queue.Empty:
                break
            drained.append("ctrl" if item is ctrl else item.seq)
        while not results.empty():
            req, exc = results.get_nowait()
            shed.append((req.seq, type(exc).__name__,
                         getattr(exc, "reason", None), exc.lane))
        runs.append((drained, shed, lane.qsize(), lane.shedding))
    assert runs[0] == runs[1]
    assert runs[0][1] and "ctrl" in runs[0][0]
    assert _counters(ptel, ("serving_shed_total",)) == \
        _counters(jtel, ("serving_shed_total",))
    with pytest.raises(ValueError):
        planes.BoundedLane("x", maxsize=0)
    with pytest.raises(ValueError):
        planes.BoundedLane("x", maxsize=4, high=0.3, low=0.6)


def test_deadlines_shed_as_jax():
    from quiver_tpu.resilience import deadline as jdl
    from quiver_tpu_torch.resilience import deadline as pdl

    assert pdl.deadline_for(10.0, 250) == jdl.deadline_for(10.0, 250)
    assert pdl.deadline_for(10.0, 0) is None
    with pconfig.override(serving_deadline_ms=50.0):
        r = qt.ServingRequest(ids=np.arange(3), client=0, seq=0)
        assert r.deadline == pytest.approx(r.t_enqueue + 0.05)
    for dl, make in ((pdl, qt.ServingRequest), (jdl, JaxRequest)):
        q = queue.Queue()
        live = make(ids=np.arange(2), client=0, seq=1,
                    deadline=time.perf_counter() + 60)
        dead = make(ids=np.arange(2), client=0, seq=2,
                    deadline=time.perf_counter() - 1)
        assert not dl.shed_if_expired(live, q, "device")
        assert not dl.shed_if_expired(dead, None, "device")  # unanswerable
        assert dl.shed_if_expired(dead, q, "device")
        req, exc = q.get_nowait()
        assert req is dead and type(exc).__name__ == "DeadlineExceeded"
        with dl.deadline_scope(time.perf_counter() - 1):
            with pytest.raises(Exception, match="deadline exceeded"):
                dl.check_ambient("dist")
        dl.check_ambient("dist")  # no scope: free
    assert _counters(ptel, ("serving_shed",)) == \
        _counters(jtel, ("serving_shed",))


# -- the server under a chaos plan ------------------------------------------

N, DIM, HIDDEN, OUT, SIZES = 1500, 12, 16, 5, [4, 3]


@pytest.fixture(scope="module")
def world():
    indptr, indices = qt.synthetic_csr(N, 15_000, seed=31)
    feat = np.random.default_rng(8).standard_normal((N, DIM)).astype(
        np.float32)
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    jfeat = JaxFeature(device_cache_size=feat.nbytes,
                       csr_topo=jt).from_cpu_tensor(feat)
    pfeat = qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                       device="cpu").from_cpu_tensor(feat)
    jsamp = JaxSampler(jt, SIZES, gather_mode="xla", sample_rng="hash")
    jb = jsamp.sample(np.arange(8), key=make_key(0))
    model = JaxSAGE(hidden=HIDDEN, out_dim=OUT, num_layers=2)
    params = model.init(make_key(1), jfeat.lookup_device(jb.n_id),
                        jb.layers)
    port = qt.GraphSAGE(DIM, HIDDEN, OUT, num_layers=2, device="cpu")
    port.load_state_dict(qt.sage_params_from_flax(
        jax.tree.map(np.asarray, params)))
    return dict(jt=jt, pt=pt, jfeat=jfeat, pfeat=pfeat, model=model,
                params=params, port=port.eval(), jsamp=jsamp)


# request i: a device pass fails on hits 1 and 2 (the breaker opens at
# the second); 3 and 4 meet the open breaker; the clock then passes the
# reset timeout, the probe (request 5) succeeds and closes the breaker
PLAN_SEED, N_REQ, TICK_BEFORE = 5, 7, 5


def _serve(world, jax_side: bool, cpu_lane: bool):
    """Send N_REQ requests one at a time through one package's server;
    returns the answers, the retained flight records' (status, lane), the
    counters, the plan's log and the logits of the ok answers by seq."""
    tel = jtel if jax_side else ptel
    chaos = jchaos if jax_side else pchaos
    make = JaxRequest if jax_side else qt.ServingRequest
    clock = Clock()
    q = queue.Queue()
    if jax_side:
        cpu = JaxSampler(world["jt"], SIZES, mode="CPU") if cpu_lane else None
        server = JaxServer(world["jsamp"], world["jfeat"], world["model"].apply,
                           world["params"], q, max_coalesce=1,
                           cpu_sampler=cpu)
        breaker = jbreaker.CircuitBreaker
    else:
        cpu = (qt.GraphSageSampler(world["pt"], SIZES, mode="CPU",
                                   device="cpu") if cpu_lane else None)
        dev = qt.GraphSageSampler(world["pt"], SIZES, device="cpu")
        server = qt.InferenceServer_Debug(dev, world["pfeat"], world["port"],
                                          q, max_coalesce=1, cpu_sampler=cpu)
        breaker = pbreaker.CircuitBreaker
    server.BUCKETS = (8, 16)
    server._breakers["device"] = breaker(
        "serving.device", failure_threshold=2, reset_timeout_s=10.0,
        half_open_probes=1, clock=clock)
    plan = chaos.ChaosPlan(seed=PLAN_SEED).fail("serving.device_lane",
                                                times=2, after=1)
    rng = np.random.default_rng(9)
    answers, logits = [], {}
    server.start()
    try:
        with chaos.active(plan):
            for seq in range(N_REQ):
                if seq == TICK_BEFORE:
                    clock.t += 11.0
                ids = rng.integers(0, N, 3 + seq)
                q.put(make(ids=ids, client=0, seq=seq))
                req, out = server.result_queue.get(timeout=120)
                if isinstance(out, Exception):
                    answers.append((req.seq, "error", type(out).__name__))
                else:
                    answers.append((req.seq, "ok", out.shape))
                    logits[req.seq] = np.asarray(out)
    finally:
        assert server.stop() == []
    recorder = (jflightrec if jax_side else pflightrec).get_recorder()
    records = [(r["status"], r["lane"]) for r in recorder.records()]
    counters = _counters(tel, ("serving_", "chaos_"))
    return answers, records, counters, plan.log(), logits


@pytest.mark.parametrize("cpu_lane", [True, False])
def test_server_failover_matches_jax(world, cpu_lane):
    prev = jconfig.get_config().flightrec_slow_ms
    jconfig.update(flightrec_slow_ms=0.0)
    jtel.reset()
    try:
        with pconfig.override(flightrec_slow_ms=0.0):
            ptel.reset()
            port = _serve(world, False, cpu_lane)
        ref = _serve(world, True, cpu_lane)
    finally:
        jconfig.update(flightrec_slow_ms=prev)
        jtel.reset()
    p_answers, p_records, p_counters, p_log, p_out = port
    j_answers, j_records, j_counters, j_log, j_out = ref
    assert p_answers == j_answers
    assert p_records == j_records
    assert p_counters == j_counters
    assert p_log == j_log
    lanes = [lane for _, lane in p_records]
    if cpu_lane:
        assert lanes.count("failover") == 4
        assert p_counters[
            "serving_failover_total{direction=device_to_cpu}"] == 4
        for (seq, status, _), lane in zip(p_answers, lanes):
            assert status == "ok"
            if lane == "failover":
                np.testing.assert_allclose(p_out[seq], j_out[seq], **TOL)
    else:
        kinds = [a[2] for a in p_answers if a[1] == "error"]
        assert kinds == ["ChaosFault", "ChaosFault", "LaneUnavailable",
                         "LaneUnavailable"]
    assert p_counters[
        "serving_breaker_transitions_total{lane=serving.device,to=open}"] == 1
    assert p_counters["serving_breaker_transitions_total"
                      "{lane=serving.device,to=closed}"] == 1


# -- faults of the program are not lane faults (the port's own rule) ---------

def _port_server(world, cpu_q=None):
    """The port's CPU server on ``world`` with a native host sampler as its
    failover route and a scripted-clock device breaker that opens at one
    failure; returns the server and the clock."""
    clock = Clock()
    dev = qt.GraphSageSampler(world["pt"], SIZES, device="cpu")
    cpu = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    server = qt.InferenceServer_Debug(dev, world["pfeat"], world["port"],
                                      queue.Queue(), cpu_sampled_queue=cpu_q,
                                      max_coalesce=1, cpu_sampler=cpu)
    server.BUCKETS = (8, 16)
    server._breakers["device"] = pbreaker.CircuitBreaker(
        "serving.device", failure_threshold=1, reset_timeout_s=10.0,
        half_open_probes=1, clock=clock)
    return server, clock


def _ask(server, seq, q=None):
    ids = np.arange(seq, N, 97)[:5]
    (q or server.device_q).put(qt.ServingRequest(ids=ids, client=0, seq=seq))
    return server.result_queue.get(timeout=120)


def test_kernel_fault_hands_back_the_half_open_probe(world, monkeypatch):
    """open -> half_open -> a pass that meets a KernelError: the request is
    answered with the error, the breaker counts nothing and hands the
    probe back, so the next request is served by the device lane (not
    failed over) and closes the breaker; stop() raises the fault."""
    from quiver_tpu_torch.ops.cuda.build import KernelError

    server, clock = _port_server(world)
    br = server._breakers["device"]
    br.record_failure()
    assert br.state == "open"
    clock.t += 11.0
    real = server._infer_coalesced
    calls = []

    def broken_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise KernelError("window_sample launch: an injected fault")
        return real(*a, **k)

    monkeypatch.setattr(server, "_infer_coalesced", broken_once)
    server.start()
    try:
        _, first = _ask(server, 0)
        assert isinstance(first, KernelError)
        assert br.state == "half_open"
        assert br.status()["probe_inflight"] is False
        _, second = _ask(server, 1)
    finally:
        with pytest.raises(KernelError):
            server.stop()
    assert not isinstance(second, Exception), second
    assert br.state == "closed"
    assert not server.failover_log
    c = _counters(ptel, ("serving_",))
    assert c["serving_requests_total{lane=device,status=ok}"] == 1
    assert c["serving_requests_total{lane=device,status=error}"] == 1
    assert not any(k.startswith("serving_failover_total") for k in c)


def test_wrapper_refusal_is_not_failed_over(world, monkeypatch):
    """A kernel wrapper that refuses its arguments raises
    KernelArgumentError (a KernelError and a ValueError): the device
    lane answers it as itself, the breaker counts nothing, no failover
    serves around it and stop() raises it."""
    from quiver_tpu_torch.ops.cuda import window_sample as b1
    from quiver_tpu_torch.ops.cuda.build import KernelArgumentError

    server, _ = _port_server(world)
    monkeypatch.setattr(b1, "_MAX_K", 1)  # every fanout is now refused
    server.start()
    try:
        _, out = _ask(server, 0)
    finally:
        with pytest.raises(KernelArgumentError):
            server.stop()
    assert isinstance(out, KernelArgumentError)
    assert isinstance(out, ValueError)
    assert "fanout" in str(out)
    br = server._breakers["device"]
    assert br.state == "closed" and br.status()["failures"] == 0
    assert not server.failover_log
    assert not any(k.startswith("serving_failover_total")
                   for k in _counters(ptel, ("serving_",)))


def test_cpu_to_device_failover_resolves_its_probe(world):
    """A CPU-lane fault fails over through the device forward while the
    device breaker is half-open: that pass takes the probe and its
    success closes the breaker, so a later device request is served by
    the device lane."""
    cpu_q = queue.Queue()
    server, clock = _port_server(world, cpu_q)
    br = server._breakers["device"]
    br.record_failure()
    clock.t += 11.0
    host = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    ids = np.arange(3, N, 211)[:6]
    req = qt.ServingRequest(ids=ids, client=1, seq=0)
    batch = host.sample(np.concatenate([ids, np.full(2, ids[0])]))
    server.start()
    try:
        with pchaos.active(pchaos.ChaosPlan().fail("serving.cpu_lane")):
            cpu_q.put((req, batch, 0.0))
            _, out = server.result_queue.get(timeout=120)
        assert not isinstance(out, Exception), out
        assert br.state == "closed"
        _, later = _ask(server, 1)
    finally:
        assert server.stop() == []
    assert not isinstance(later, Exception), later
    c = _counters(ptel, ("serving_",))
    assert c["serving_failover_total{direction=cpu_to_device}"] == 1
    assert c["serving_requests_total{lane=failover,status=ok}"] == 1
    assert c["serving_requests_total{lane=device,status=ok}"] == 1
