"""The phase readings: device operations put down to the program span
open at their launch, host self times from retained spans, and the whole
measurement through a tiny cell on the CPU."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import phases, run as prun, trace
from portbench.tests import tiny


def _ev(name, a, b, dev=False, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if dev else
                           DeviceType.CPU, is_user_annotation=False, id=id,
                           thread=thread)


def _capture(with_program=True):
    events = [
        _ev("spin_kernel", 0, 100, dev=True),
        _ev("spin_kernel", 200, 201, dev=True),    # the window opens at 201
        _ev("portbench.step", 190, 900),
        _ev("aten::mm", 220, 240),
        _ev("cudaLaunchKernel", 225, 230, id=11),
        _ev("cudaLaunchKernel", 250, 255, id=12),
        # launched from autograd's thread while the main thread is in the
        # backward span; it runs after the span has closed
        _ev("cudaLaunchKernel", 320, 325, id=13, thread=2),
        _ev("cudaLaunchKernel", 410, 415, id=14),
        _ev("gemm", 230, 300, dev=True, id=11),
        _ev("index_add", 300, 330, dev=True, id=12),
        _ev("mm_backward", 500, 560, dev=True, id=13),
        _ev("adam", 600, 610, dev=True, id=14),
        _ev("memset", 610, 620, dev=True, id=99),  # its launch not captured
        _ev("spin_kernel", 700, 701, dev=True),    # the window closes at 700
    ]
    if with_program:
        events += [
            _ev("quiver.train.step", 210, 450),
            _ev("quiver.train.forward", 215, 260),
            _ev("quiver.train.backward", 300, 400),
        ]
    return events


def test_device_time_goes_to_the_span_open_at_launch():
    got = phases.attribute(_capture())
    assert got["span_s"] == pytest.approx({"train.forward": 100e-6,
                                           "train.backward": 60e-6,
                                           "train.step": 10e-6})
    assert got["outside_s"] == pytest.approx(10e-6)
    assert got["unmatched"] == 1 and got["steps"] == 1
    # every device second is put down somewhere, once
    assert sum(got["span_s"].values()) + got["outside_s"] == \
        pytest.approx(got["device_s"])
    assert got["device_s"] == pytest.approx(
        sum(trace.reduce(_capture())["ops"].values()))
    # the gap 330-500 starts inside the backward span, the host in no
    # operation; 201-230, 560-600 and 620-700 start outside program spans
    assert got["gaps"] == pytest.approx({"step / train.backward": 170e-6,
                                         "step": 149e-6})


def test_without_program_spans_the_gaps_read_as_reduce_labels_them():
    events = _capture(with_program=False)
    got = phases.attribute(events)
    assert got["gaps"] == pytest.approx(trace.reduce(events)["gaps"])
    assert got["span_s"] == {} and got["steps"] == 0
    assert got["outside_s"] == pytest.approx(got["device_s"])


def _span(name, ts, dur, depth, parent, root):
    return dict(name=name, ts_us=ts, dur_us=dur, depth=depth, parent=parent,
                root=root, pid=1, tid=1)


def test_host_self_time():
    evs = []
    for root, t in ((1, 0.0), (2, 1000.0)):
        evs += [_span("train.step", t, 600, 0, None, root),
                _span("train.sample", t + 10, 100, 1, "train.step", root),
                _span("train.backward", t + 200, 300, 1, "train.step", root)]
    evs.append(_span("train.forward", 5000, 50, 0, None, 3))  # a lone root
    got = phases.host_self(evs)
    assert got["steps"] == 2
    assert got["step_s"] == pytest.approx(1200e-6)
    assert got["self_s"] == pytest.approx({
        "train.step": 400e-6, "train.sample": 200e-6,
        "train.backward": 600e-6, "train.forward": 50e-6})
    # the self times of the step's spans add up to the steps' time
    assert sum(got["self_s"][n] for n in ("train.step", "train.sample",
                                          "train.backward")) == \
        pytest.approx(got["step_s"])
    assert phases.host_self(evs[-1:]) is None


@pytest.mark.parametrize("name", tiny.TRAIN)
def test_phases_of_a_tiny_cell(name):
    r = tiny.run(name)
    got = phases.of(r)
    assert "device" not in got  # no card here
    h = got["host"]
    assert h["steps"] == r.cell.mix["trace_steps"]
    spans = {"train.step"} | {f"train.{p}" for p in phases.PHASES}
    assert set(h["self_s"]) == spans
    assert sum(h["self_s"].values()) == pytest.approx(h["step_s"])
    for m in ("sample", "lookup", "forward", "backward", "optimizer",
              "step_self"):
        assert prun.reader(f"{m}_host_ms.train")(r) > 0
    for p in phases.PHASES:
        assert prun.reader(f"{p}_device_ms.train")(r) is None
    # measured once a run, and retention is back off
    assert phases.of(r) is got
    from quiver_tpu_torch import telemetry
    assert not telemetry.get_tracer().tracing


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    from quiver_tpu_torch.telemetry import spans

    r = tiny.run(tiny.TRAIN[0])
    monkeypatch.delattr(spans, "_HOT")
    assert phases.of(r) is None
    assert prun.reader("backward_host_ms.train")(r) is None
    assert prun.reader("backward_device_ms.train")(r) is None
