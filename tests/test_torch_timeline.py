"""Port parity: the unified timeline (``quiver_tpu_torch/telemetry/
timeline.py``) against the JAX package.

- Off, nothing is recorded; ``enable`` refuses while telemetry is off.
- The same emissions (slices, instants, span closes, flight-recorder
  events) give the same Chrome trace events (name, phase, category,
  arguments) and the same per-subsystem counters as JAX's.
- A thread's ring overwrites its oldest events past its capacity and the
  export reports the overwrites.
- One served pass with the timeline on holds the request's slices.
"""

import json
import queue
import threading

import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.telemetry import flightrec as jfr
from quiver_tpu.telemetry import timeline as jtl

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.telemetry import flightrec as pfr
from quiver_tpu_torch.telemetry import timeline as ptl

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, tracers and timelines are process-wide:
    each test starts and ends with them empty and the timelines off;
    JAX's telemetry is on for the test and back at its default after."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    yield
    for tel in (ptel, jtel):
        tel.reset()
    ptel.set_enabled(True)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _emit_all(tel, tl, fr):
    if tl.on():  # direct emit sites guard, as the subsystems do
        tl.emit("chaos.inject", cat="chaos", attrs={"point": "p"})
        tl.emit("feature.fault", dur_s=0.002, attrs={"pages": 3})
        tl.instant("qos.ladder", attrs={"level": 1})
        tl.emit("sample", dur_s=0.001)
        tl.emit("whatever")
    with tel.span("outer"):
        with tel.span("inner"):
            pass
    ctx = fr.TraceContext()
    ctx.tenant = "gold"
    with fr.activate(ctx):
        fr.event("infer", {"seconds": 0.004})
        fr.event("dequeue", {"coalesced": 2})
    return ctx


def _events(doc):
    return [(e["name"], e["ph"], e.get("cat"),
             {k: v for k, v in e["args"].items() if k != "trace_id"})
            for e in doc["traceEvents"] if e["ph"] != "M"]


def test_timeline_records_as_jax():
    runs = []
    for tel, tl, fr in ((ptel, ptl, pfr), (jtel, jtl, jfr)):
        _emit_all(tel, tl, fr)
        assert tl.events() == []  # off: nothing recorded
        assert tl.enable(capacity=64)
        ctx = _emit_all(tel, tl, fr)
        doc = json.loads(json.dumps(tl.chrome_trace()))
        traced = [e for e in doc["traceEvents"]
                  if e["args"].get("trace_id") == ctx.trace_id]
        counters = {k: v for k, v in tel.snapshot()["counters"].items()
                    if k.startswith("timeline_")}
        runs.append((_events(doc), len(traced), counters,
                     {k: v for k, v in tl.status().items()
                      if k != "threads"}))
        tl.disable()
    assert runs[0] == runs[1]
    assert runs[0][1] == 2


def test_enable_refused_while_telemetry_is_off():
    ptel.set_enabled(False)
    assert not ptl.enable()
    assert not ptl.on()


def test_ring_overwrites_its_oldest():
    ptl.enable(capacity=8)
    jtl.enable(capacity=8)

    def burst(tl):
        for i in range(20):
            tl.emit("e", attrs={"i": i})

    for tl in (ptl, jtl):
        t = threading.Thread(target=burst, args=(tl,))
        t.start()
        t.join(timeout=30)
    pe, je = ptl.events(), jtl.events()
    assert [e["attrs"]["i"] for e in pe] == [e["attrs"]["i"] for e in je] \
        == list(range(12, 20))
    assert ptl.chrome_trace()["otherData"] == {"dropped_events": 12}
    assert ptl.status()["dropped"] == jtl.status()["dropped"] == 12


def test_served_pass_lands_on_the_timeline(tmp_path):
    indptr, indices = qt.synthetic_csr(300, 2400, seed=5)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    feat = np.random.default_rng(3).standard_normal((300, 6)).astype(
        np.float32)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu")
    model = qt.GraphSAGE(6, 8, 3, num_layers=2, device="cpu")
    q = queue.Queue()
    server = qt.InferenceServer(sampler, feature, model, q)
    server.BUCKETS = (8,)
    assert ptl.enable()
    server.start()
    try:
        req = qt.ServingRequest(ids=np.arange(5), client=0, seq=0)
        q.put(req)
        _, out = server.result_queue.get(timeout=60)
    finally:
        assert server.stop() == []
    assert out.shape == (5, 3)
    doc = json.load(open(ptl.export(str(tmp_path / "t.json"))))
    mine = [(e["name"], e["ph"]) for e in doc["traceEvents"]
            if e["args"].get("trace_id") == req.trace.trace_id]
    assert ("request.enqueue", "i") in mine
    assert ("infer", "X") in mine and ("request", "X") in mine
    assert ("sampler.sample", "X") not in mine  # fused: no host sample
