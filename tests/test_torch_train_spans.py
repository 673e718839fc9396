"""The training step's spans (``train.*``) in the port's tracer.

- Retained, a fused step records ``train.step`` and under it
  ``train.sample``, ``train.lookup``, ``train.forward``,
  ``train.backward`` and ``train.optimizer`` in that order, each with its
  parent's name and the root's id; the Chrome export keeps both.
- ``make_train_step`` alone (the two-stage lane) records its three.
- Not retained, a step makes no ``Span`` and calls nothing of the
  telemetry package: each site reads the one global ``spans._HOT``,
  which follows retention and the telemetry switch.
- Under ``torch.profiler`` the spans appear as nested ``quiver.train.*``
  ranges.
- Losses and parameters are bitwise the same with the spans on and off.
"""

import dis
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.telemetry import spans as pspans
from quiver_tpu_torch.utils import trace as ptrace

N, D, HIDDEN, CLASSES, B = 600, 8, 16, 4, 32
SIZES = [4, 3, 2]
PHASES = ["train.sample", "train.lookup", "train.forward", "train.backward",
          "train.optimizer"]
MODEL_PHASES = PHASES[2:]

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, tracers, recorders and timelines, and the
    port's QoS controller, start and end empty, with retention off; JAX's
    telemetry is back at its process default after."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    pqos.reset()
    ptel.get_tracer().set_tracing(False)
    yield
    ptel.get_tracer().set_tracing(False)
    ptel.set_enabled(True)
    pqos.reset()
    for tel in (ptel, jtel):
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, 6_000, seed=3)
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int64)
    return indptr, indices, feat, labels


def _objects(data, dropout=0.5):
    indptr, indices, feat, _ = data
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    sampler = qt.GraphSageSampler(topo, SIZES, device="cpu",
                                  gather_mode="pallas")
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    torch.manual_seed(0)
    model = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=len(SIZES),
                         dropout=dropout, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    return sampler, feature, model, opt


def _batches(data, n):
    labels = data[3]
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(0, N, B)
        words = rng.integers(0, 2**32, (len(SIZES), 2), dtype=np.uint32)
        out.append((ids, torch.from_numpy(labels[ids]),
                    torch.ones(B, dtype=torch.bool), words))
    return out


def _fused(data, steps=2, dropout=0.5):
    sampler, feature, model, opt = _objects(data, dropout)
    step = qt.make_fused_train_step(sampler, feature, model, opt, seed=7)
    losses = [step(*b) for b in _batches(data, steps)]
    return losses, model


def _self_seconds(events):
    """Each event's duration less the part its children cover."""
    out = {}
    for e in events:
        kids = sum(c["dur_us"] for c in events
                   if c["root"] == e["root"] and c["parent"] == e["name"]
                   and c["depth"] == e["depth"] + 1)
        out.setdefault(e["name"], []).append(e["dur_us"] - kids)
    return out


def test_fused_step_records_its_phases(data):
    ptel.get_tracer().set_tracing(True)
    assert pspans._HOT
    _fused(data, steps=2)
    evs = sorted(ptel.get_tracer().events(), key=lambda e: e["ts_us"])
    roots = [e for e in evs if e["name"] == "train.step"]
    assert len(roots) == 2 and len({e["root"] for e in roots}) == 2
    for root in roots:
        assert root["depth"] == 0 and root["parent"] is None
        kids = [e for e in evs if e["root"] == root["root"]
                and e["name"] != "train.step"]
        assert [e["name"] for e in kids] == PHASES
        for e in kids:
            assert e["parent"] == "train.step" and e["depth"] == 1
            assert root["ts_us"] <= e["ts_us"]
            assert e["ts_us"] + e["dur_us"] <= root["ts_us"] + root["dur_us"]
    selfs = _self_seconds(evs)
    assert all(v >= 0 for vs in selfs.values() for v in vs)
    doc = ptel.get_tracer().chrome_trace()
    assert pspans.SpanTracer.parse_chrome_trace(doc) == \
        ptel.get_tracer().events()


def test_model_step_records_three(data):
    sampler, feature, model, opt = _objects(data)
    step = qt.make_train_step(model, opt, seed=7)
    ids, labels, mask, _ = _batches(data, 1)[0]
    batch = sampler.sample(ids)
    x = feature[batch.n_id]
    ptel.get_tracer().set_tracing(True)
    step(x, batch.layers, labels, mask)
    evs = sorted(ptel.get_tracer().events(), key=lambda e: e["ts_us"])
    evs = [e for e in evs if e["name"].startswith("train.")]
    assert [e["name"] for e in evs] == MODEL_PHASES
    assert all(e["depth"] == 0 and e["parent"] is None for e in evs)
    assert len({e["root"] for e in evs}) == 3


def _site_functions(data):
    sampler, feature, model, opt = _objects(data)
    return [qt.make_fused_train_step(sampler, feature, model, opt),
            qt.make_train_step(model, opt)]


def test_gate_follows_retention_and_telemetry():
    assert not pspans._HOT  # telemetry on, retention off
    ptel.get_tracer().set_tracing(True)
    assert pspans._HOT
    ptel.set_enabled(False)
    assert not pspans._HOT
    ptel.set_enabled(True)
    assert pspans._HOT
    ptrace.set_enabled(False)
    assert not pspans._HOT
    # a tracer of one's own does not move the process-wide gate
    pspans.SpanTracer().set_tracing(True)
    assert not pspans._HOT


def test_off_path_reads_one_global_and_does_nothing_else(data, monkeypatch):
    # each site reads the gate once, as a plain module attribute
    assert type(pspans.__dict__["_HOT"]) is bool
    assert "__getattr__" not in pspans.__dict__
    for fn in _site_functions(data):
        reads = [i for i in dis.get_instructions(fn.__code__)
                 if i.argval == "_HOT"]
        assert len(reads) == 1 and reads[0].opname == "LOAD_ATTR"
    made = []
    init = pspans.Span.__init__
    monkeypatch.setattr(pspans.Span, "__init__",
                        lambda self, *a, **k: (made.append(a),
                                               init(self, *a, **k))[1])
    sampler, feature, model, opt = _objects(data)
    step = qt.make_fused_train_step(sampler, feature, model, opt)
    batches = _batches(data, 2)
    step(*batches[0])  # warm: first-call set-up is not the step's path
    tel_dir = str(Path(pspans.__file__).parent)
    sites = {(str(Path(qt.pipeline.__file__)), "step"),
             (str(Path(qt.pipeline.__file__)), "_sample_rows"),
             (str(Path(qt.parallel.train.__file__)), "step")}
    calls = []

    def prof(frame, event, arg):
        if event == "call":
            caller = frame.f_back
            if caller is not None and (caller.f_code.co_filename,
                                       caller.f_code.co_name) in sites:
                calls.append(frame.f_code.co_filename + ":"
                             + frame.f_code.co_name)
        elif event == "c_call" and (frame.f_code.co_filename,
                                    frame.f_code.co_name) in sites:
            calls.append(getattr(arg, "__qualname__", repr(arg)))

    sys.setprofile(prof)
    try:
        step(*batches[1])
    finally:
        sys.setprofile(None)
    assert calls, "the profile hook saw no call of the step"
    assert made == []
    assert not [c for c in calls if c.startswith(tel_dir)
                or "perf_counter" in c or "record_function" in c], calls
    assert not any(k.startswith("train.") for k in ptel.get_tracer().summary())


def test_profiler_sees_nested_ranges(data):
    from torch.profiler import ProfilerActivity, profile

    sampler, feature, model, opt = _objects(data)
    step = qt.make_fused_train_step(sampler, feature, model, opt)
    batch = _batches(data, 1)[0]
    ptel.get_tracer().set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*batch)
    rng = {}
    for e in prof.events():
        if e.name.startswith(pspans.PROFILER_PREFIX + "train."):
            rng[e.name[len(pspans.PROFILER_PREFIX):]] = (e.time_range.start,
                                                         e.time_range.end)
    assert set(rng) == {"train.step", *PHASES}
    a, b = rng["train.step"]
    for name in PHASES:
        assert a <= rng[name][0] <= rng[name][1] <= b
    # outside a capture a retained span opens no profiler range
    assert not torch.autograd._profiler_enabled()


def test_spans_change_no_bit(data):
    off_losses, off_model = _fused(data, steps=3)
    ptel.get_tracer().set_tracing(True)
    on_losses, on_model = _fused(data, steps=3)
    assert len(ptel.get_tracer().events()) == 3 * (1 + len(PHASES))
    assert [float(x) for x in on_losses] == [float(x) for x in off_losses]
    for (n, p), (_, q) in zip(off_model.named_parameters(),
                              on_model.named_parameters()):
        assert torch.equal(p, q), n
