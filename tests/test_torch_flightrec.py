"""Port parity: the flight recorder (``quiver_tpu_torch/telemetry/
flightrec.py``) against the JAX package.

- Trace contexts log events alike, cap them alike and fan a coalesced
  activation out to every member.
- ``FlightRecorder`` classifies (error > shed > rejected > flagged > slow)
  and retains, evicts and summarizes the same requests as JAX's for the
  same sequence of finishes, with the same retention counters.
- With telemetry off no trace is made.
- A served request: the slow and the errored are retained with their
  stage events, the fast one is dropped.
"""

import queue

import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.telemetry import flightrec as jfr

import quiver_tpu_torch as qt
from quiver_tpu_torch import config as pconfig
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.resilience import ChaosPlan, chaos
from quiver_tpu_torch.telemetry import flightrec as pfr

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries and recorders are process-wide: each test
    starts and ends with them empty; JAX's telemetry is on for the test
    and back at its process default after."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    chaos.uninstall()
    yield
    chaos.uninstall()
    for tel in (ptel, jtel):
        tel.reset()
    ptel.set_enabled(True)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _strip(rec: dict) -> dict:
    """A record without its process-unique ids and clock readings."""
    out = {k: v for k, v in rec.items()
           if k not in ("trace_id", "wall_start", "e2e_seconds")}
    out["events"] = [(e["name"], e["attrs"]) for e in rec["events"]]
    return out


FINISHES = [  # (e2e seconds, status, flagged, lane, stages)
    (0.001, "ok", False, "device", {"infer": 0.001}),
    (0.2, "ok", False, "device", {"infer": 0.15, "queue_wait": 0.05}),
    (0.003, "error", False, "cpu", None),
    (0.002, "ok", True, "cpu", {"gather": 0.001}),
    (0.5, "shed", False, "batcher", None),
    (0.004, "rejected", False, "qos", None),
    (0.3, "ok", False, "failover", {"sample": 0.2, "infer": 0.1}),
    (0.01, "ok", False, "device", None),
]


def _run(fr, tel):
    rec = fr.FlightRecorder(capacity=4, slow_threshold_s=0.1)
    reasons, ids = [], []
    for i, (e2e, status, flagged, lane, stages) in enumerate(FINISHES):
        ctx = fr.TraceContext()
        ctx.add("enqueue", {"i": i})
        with fr.activate([ctx, None]):
            assert fr.tracing() and fr.current() is ctx
            fr.event("stage", {"seconds": e2e / 2})
            if flagged:
                fr.flag()
        ctx.add("finish")
        reasons.append(rec.finish(ctx, e2e, status=status, lane=lane,
                                  stages=stages))
        ids.append(ctx.trace_id)
    kept = [_strip(r) for r in rec.records()]
    summaries = [{k: v for k, v in s.items()
                  if k not in ("trace_id", "wall_start")}
                 for s in rec.summaries()]
    assert rec.get(ids[-2]) is not None and rec.get(ids[0]) is None
    counters = {k: v for k, v in tel.snapshot()["counters"].items()
                if k.startswith("flightrec_")}
    parts = [fr.partition_check(r, rel_tol=0.25) for r in rec.records()]
    return reasons, kept, summaries, counters, parts


def test_recorder_retains_as_jax():
    got, want = _run(pfr, ptel), _run(jfr, jtel)
    assert got == want
    assert got[0] == [None, "slow", "error", "flagged", "shed", "rejected",
                      "slow", None]


def test_trace_contexts_match_jax():
    for fr in (pfr, jfr):
        ctx = fr.TraceContext()
        for i in range(fr._MAX_EVENTS_PER_TRACE + 5):
            ctx.add("e", {"i": i})
        assert ctx.dropped == 5
        a, b = fr.TraceContext(), fr.TraceContext()
        with fr.activate([a, b]):
            fr.event("coalesced")
        assert [e[1] for e in a.events] == [e[1] for e in b.events] == [
            "coalesced"]
        assert fr.activate(None) is fr.activate([]) is fr._NOOP_ACTIVATION
        assert not fr.tracing()
        fr.event("nowhere")  # no active trace: a no-op
    assert pfr.graph_version() is None
    ptel.set_enabled(False)
    assert pfr.new_trace() is None
    assert qt.ServingRequest(ids=np.arange(2), client=0, seq=0).trace is None


def test_served_requests_are_retained_by_reason():
    """A device pass that fails (chaos) is retained as ``error`` with its
    error event; with the slow threshold at 0 every served request is
    retained as ``slow`` with its stage events; at 60 s none is."""
    indptr, indices = qt.synthetic_csr(300, 2400, seed=4)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    feat = np.random.default_rng(2).standard_normal((300, 6)).astype(
        np.float32)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu")
    model = qt.GraphSAGE(6, 8, 3, num_layers=2, device="cpu")
    for slow_ms, want in ((0.0, "slow"), (60_000.0, None)):
        with pconfig.override(flightrec_slow_ms=slow_ms):
            ptel.reset()
            q = queue.Queue()
            server = qt.InferenceServer_Debug(sampler, feature, model, q,
                                              max_coalesce=1)
            server.BUCKETS = (8,)
            server.start()
            try:
                with chaos.active(ChaosPlan().fail("serving.device_lane",
                                                   times=1)):
                    for seq in range(3):
                        q.put(qt.ServingRequest(ids=np.arange(3 + seq),
                                                client=0, seq=seq))
                        server.result_queue.get(timeout=60)
            finally:
                assert server.stop() == []
            recs = server.flight_records()
            assert [r["reason"] for r in recs] == (
                ["error", want, want] if want else ["error"])
            names = [e["name"] for e in recs[0]["events"]]
            assert names[:3] == ["enqueue", "dequeue", "error"]
            if want:
                names = [e["name"] for e in recs[1]["events"]]
                assert names == ["enqueue", "dequeue", "infer", "finish"]
                assert pfr.partition_check(recs[1])
