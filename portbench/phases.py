"""The fused training step by phase, read from the program's ``train.*``
spans: the card's milliseconds a step launched in each phase, and the
host's self milliseconds a step in each.

The readers of the phase metrics call :func:`of`, which works once a run
and keeps what it finds in ``run.keep["phases"]``.  ``drivers/train.py``
has freed the program's objects by the time the readers run, so
:func:`of` builds them again over the run's inputs and takes the same
step through the same warm-up, and then, with the program's span
retention on:

1. ``trace_steps`` steps, unprofiled, each started on an idle card: each
   phase's host self time from the tracer's retained events
   (:func:`host_self`).  Back to back, as the window runs them, a host
   ahead of the card waits in some launch for a free slot of the card's
   queue, and the wait would land in whichever phase hit it;
2. one ``torch.profiler`` capture of ``trace_steps`` more steps that
   records the host and the card (:func:`attribute`): each device
   operation is put down to the innermost program span open when it was
   launched.

Then the tracer is emptied and retention set back as it was.  The run's
own captures, and every number the other readers take, are untouched.
A program without the step spans' gate (``telemetry.spans._HOT``) gives
``None`` and nothing is built.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, List, Optional

import torch

from . import build, trace

PHASES = ("sample", "lookup", "forward", "backward", "optimizer")
STEP = "train.step"
PROGRAM = "quiver."      # the program's spans in the profiler's trace
HARNESS = "portbench."   # the benchmark's own
# the host's CUDA calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
# ``cudaMemcpyAsync``...): a device operation's launch is the one that
# shares its correlation id
LAUNCH_PREFIX = "cu"


def attribute(events) -> Optional[dict]:
    """From a capture's events (``prof.events()``): ``span_s``, the device
    seconds of the operations launched while each program span was the
    innermost one open (compared by time, on any thread: autograd
    launches the backward's kernels from its own thread); ``outside_s``,
    those launched outside every program span (or whose launch the
    capture lacks, counted in ``unmatched``); ``device_s``, their total;
    ``steps``, the ``train.step`` ranges; ``gaps``, the idle seconds of
    the window by harness span, innermost program span and innermost
    other host operation at the gap's start (as ``trace.reduce`` labels
    them, with the program span between)."""
    from torch.autograd import DeviceType

    dev, spins, harness, program, host, launch = [], [], [], [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation:
                continue
            (spins if "spin_kernel" in e.name else dev).append((a, b, e))
        elif e.name.startswith(HARNESS):
            harness.append((a, b, e.name[len(HARNESS):]))
        elif e.name.startswith(PROGRAM):
            program.append((a, b, e.name[len(PROGRAM):]))
        else:
            host.append((a, b, e.name))
            if e.name.startswith(LAUNCH_PREFIX):
                launch[e.id] = a
    if not dev:
        return None
    for items in (harness, program, host):
        items.sort(key=lambda x: (x[0], x[1]))
    pkeys = [p[0] for p in program]
    span_s: Dict[str, float] = {}
    outside, unmatched = 0.0, 0
    for a, b, e in dev:
        t = launch.get(e.id)
        if t is None:
            unmatched += 1
            outside += (b - a) * 1e-6
            continue
        name = trace._innermost(program, pkeys, t)
        if name is None:
            outside += (b - a) * 1e-6
        else:
            span_s[name] = span_s.get(name, 0.0) + (b - a) * 1e-6
    first, last = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    w0 = max([b for _, b, _ in spins if b <= first], default=first)
    w1 = min([a for a, _, _ in spins if a >= last], default=last)
    busy = trace._merge([(a, b) for a, b, _ in dev])
    hkeys, okeys = [h[0] for h in harness], [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        parts = [trace._innermost(harness, hkeys, a) or "outside spans",
                 trace._innermost(program, pkeys, a),
                 trace._innermost(host, okeys, a)]
        key = " / ".join(p for p in parts if p)
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    return dict(span_s=span_s, outside_s=outside, unmatched=unmatched,
                device_s=sum((b - a) for a, b, _ in dev) * 1e-6,
                steps=sum(1 for p in program if p[2] == STEP), gaps=gaps)


def host_self(events: List[dict]) -> Optional[dict]:
    """From the tracer's retained events: each span's self seconds (its
    duration less its children's) summed by name, and the ``train.step``
    roots' count and total seconds."""
    kids: Dict[tuple, float] = {}
    for e in events:
        if e["parent"] is not None:
            k = (e["root"], e["parent"], e["depth"] - 1)
            kids[k] = kids.get(k, 0.0) + e["dur_us"] * 1e-6
    self_s: Dict[str, float] = {}
    for e in events:
        own = e["dur_us"] * 1e-6 - kids.get((e["root"], e["name"],
                                             e["depth"]), 0.0)
        self_s[e["name"]] = self_s.get(e["name"], 0.0) + own
    roots = [e for e in events if e["name"] == STEP and e["depth"] == 0]
    if not roots:
        return None
    return dict(self_s=self_s, steps=len(roots),
                step_s=sum(e["dur_us"] for e in roots) * 1e-6)


def _measure(run) -> Optional[dict]:
    import quiver_tpu_torch as qt
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.telemetry import spans

    from .drivers.train import Feed

    if not hasattr(spans, "_HOT"):
        return None
    cfg, mix, dev = run.cell.cfg, run.cell.mix, run.device
    inp = run.keep["inp"]
    objs = build.port_objects(qt, cfg, inp, dev, train=True)
    model = objs[3]
    opt = torch.optim.Adam(model.parameters(), lr=cfg["optimizer"]["lr"])
    step = qt.make_fused_train_step(objs[2], objs[1], model, opt,
                                    seed=run.keep["dropout_seed"])
    hops = len(cfg["sampling"]["fanouts"])
    feed = Feed(inp, cfg["sampling"]["batch"], run.seed, dev)
    n, s = mix["trace_steps"], mix["check_steps"] + mix["warmup_steps"]
    for i in range(s):
        step(*feed(i, hops))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tracer = telemetry.get_tracer()
    was = tracer.tracing
    tracer.set_tracing(True)
    try:
        out: Dict[str, object] = {}
        fs = [feed(s + i, hops) for i in range(n)]
        s += n
        tracer.reset()
        # the run's captures left events with reference cycles: collected
        # here, not in the middle of a measured step
        gc.collect()
        for f in fs:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step(*f)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["host"] = host_self(tracer.events())
        if dev.type == "cuda":
            fs = [feed(s + i, hops) for i in range(n)]
            tracer.reset()
            out["device"] = attribute(trace._profiled(
                lambda part: [step(*f) for f in part], fs, True, "step"))
    finally:
        tracer.reset()
        tracer.set_tracing(was)
    del step, opt, model, objs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _report(got: dict) -> None:
    d = got.get("device")
    lines = []
    if d and d["steps"]:
        per = 1e3 / d["steps"]
        lines.append(
            "phases: card ms a step by launching span "
            + ", ".join(f"{k} {v * per:.4f}" for k, v in
                        sorted(d["span_s"].items()))
            + f", outside {d['outside_s'] * per:.4f} ({d['unmatched']} ops "
            f"unmatched to a launch), total {d['device_s'] * per:.4f} over "
            f"{d['steps']} steps")
        idle = sum(d["gaps"].values())
        step_idle = sum(v for k, v in d["gaps"].items()
                        if k.split(" / ")[0] == "step")
        named = sum(v for k, v in d["gaps"].items() if k.split(" / ")[0]
                    == "step" and " / train." in f" / {k}")
        lines.append(
            f"phases: idle {idle * 1e3:.4f} ms, {step_idle * 1e3:.4f} under "
            f"the step span, {named * 1e3:.4f} of it under a train.* span "
            f"({100.0 * named / step_idle if step_idle else 0.0:.2f}%); "
            "largest: " + "; ".join(
                f"{k} {v * 1e3:.4f}" for k, v in
                sorted(d["gaps"].items(), key=lambda kv: -kv[1])[:12]))
    h = got.get("host")
    if h:
        per = 1e3 / h["steps"]
        lines.append(
            "phases: host self ms a step, each on an idle card: "
            + ", ".join(f"{k} {v * per:.4f}" for k, v in
                        sorted(h["self_s"].items()))
            + f"; {STEP} {h['step_s'] * per:.4f} over {h['steps']} steps")
    for line in lines:
        print(line, file=sys.stderr)


def of(run) -> Optional[dict]:
    """The run's phase measurements, made at the first call."""
    if "phases" not in run.keep:
        run.keep["phases"] = _measure(run)
        if run.keep["phases"]:
            _report(run.keep["phases"])
    return run.keep["phases"]


def device_ms(run, phase: str) -> Optional[float]:
    """Card milliseconds a step launched inside ``train.<phase>``."""
    d = (of(run) or {}).get("device")
    if not d or not d["steps"]:
        return None
    s = d["span_s"].get(f"train.{phase}")
    return None if s is None else 1e3 * s / d["steps"]


def host_ms(run, span: str) -> Optional[float]:
    """Host self milliseconds a step inside ``span``."""
    h = (of(run) or {}).get("host")
    if not h:
        return None
    s = h["self_s"].get(span)
    return None if s is None else 1e3 * s / h["steps"]
