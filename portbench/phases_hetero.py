"""The hetero cell's fused R-GAT step by phase, read from the program's
``train.*`` spans as ``phases.py`` reads GraphSAGE's: the step is built
again over the run's inputs and taken through the same warm-up, then, with
span retention on, ``trace_steps`` unprofiled steps each on an idle card
give each phase's host self time (``phases.host_self``) and one capture
of ``trace_steps`` more gives each phase's card time by the span open at
each operation's launch (``phases.attribute``).  A program without the
step spans' gate (``telemetry.spans._HOT``) gives ``None``.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

from . import phases, trace


def _measure(run) -> Optional[dict]:
    import quiver_tpu_torch as qt
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.telemetry import spans

    from .drivers.train import Feed
    from .drivers.train_hetero import step_objects

    if not hasattr(spans, "_HOT"):
        return None
    cfg, mix, dev = run.cell.cfg, run.cell.mix, run.device
    inp = run.keep["inp"]
    objs, opt, step, _ = step_objects(qt, cfg, inp, dev, run.seed)
    blocks = objs[2].num_blocks(cfg["sampling"]["batch"])
    feed = Feed(inp, cfg["sampling"]["batch"], run.seed, dev)
    n, s = mix["trace_steps"], mix["check_steps"] + mix["warmup_steps"]
    for i in range(s):
        step(*feed(i, blocks))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tracer = telemetry.get_tracer()
    was = tracer.tracing
    tracer.set_tracing(True)
    try:
        out: Dict[str, object] = {}
        fs = [feed(s + i, blocks) for i in range(n)]
        s += n
        tracer.reset()
        gc.collect()
        for f in fs:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step(*f)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["host"] = phases.host_self(tracer.events())
        if dev.type == "cuda":
            fs = [feed(s + i, blocks) for i in range(n)]
            tracer.reset()
            out["device"] = phases.attribute(trace._profiled(
                lambda part: [step(*f) for f in part], fs, True, "step"))
    finally:
        tracer.reset()
        tracer.set_tracing(was)
    del step, opt, objs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def of(run) -> Optional[dict]:
    """The run's phase measurements, made at the first call."""
    if "phases" not in run.keep:
        run.keep["phases"] = _measure(run)
        if run.keep["phases"]:
            phases._report(run.keep["phases"])
    return run.keep["phases"]


def device_ms(run, phase: str) -> Optional[float]:
    """Card milliseconds a step launched inside ``train.<phase>``."""
    d = (of(run) or {}).get("device")
    if not d or not d["steps"]:
        return None
    s = d["span_s"].get(f"train.{phase}")
    return None if s is None else 1e3 * s / d["steps"]
