"""One run of one cell: set-up, the measured window, the traced capture
when asked, the comparison with the reference, and the result line.

The ``kind`` of the cell's traffic mix names its driver in ``drivers/``
(``train``: ``drivers/train.py``); everything else is found by the names in
``BENCHMARK.json``.  Kernel and build caches stay inside the checkout (the
port builds into ``build/quiver_tpu_torch/``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
from pathlib import Path
from typing import Optional

from . import core, trace

# a library the port may pull in must not load JAX behind it
os.environ.setdefault("USE_FLAX", "0")


def reader(name: str):
    path = core.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: core.Cell, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, qt=None) -> core.Run:
    """Drive ``cell`` on ``device``: the driver of its traffic kind fills
    the run's measurements and checks."""
    import torch

    if qt is None:
        import quiver_tpu_torch as qt
    r = core.Run(cell=cell, seed=seed, seconds=seconds, trace=trace_on,
                 device=torch.device(device), t_start=t_start)
    r.mark("imports")
    if r.device.type == "cuda":
        from quiver_tpu_torch.ops.cuda import KERNELS
        from quiver_tpu_torch.ops.cuda.build import load_libraries

        torch.cuda.init()
        r.mark("card")
        load_libraries(KERNELS)
        r.layer["device_name"] = torch.cuda.get_device_name(r.device)
        r.mark("kernels")
    drv = importlib.import_module(f"portbench.drivers.{cell.mix['kind']}")
    drv.run(r, qt)
    return r


def metrics_of(r: core.Run) -> dict:
    out = {}
    if not r.trace:
        for m in r.cell.end_to_end:
            if m["name"] in r.e2e:
                out[m["name"]] = {"value": r.e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in r.cell.per_layer:
        v = reader(m["name"])(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv, t_start: float, root: Optional[Path] = None) -> int:
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = root or Path.cwd()
    cell = core.find_cell(root, a.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    r = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell.chips, memory_peak_bytes=int(r.memory_peak))
    if r.trace:
        if not r.traced:
            print("portbench: the capture held no device operation",
                  file=sys.stderr)
            return 4
        device.update(busy_s=r.traced["busy_s"],
                      window_s=r.traced["window_s"])
    line = core.result_line(r, metrics_of(r), device,
                            trace.breakdown(r.traced) if r.trace else None)
    core.print_checks(r)
    sys.stderr.flush()
    print(line, flush=True)
    return 0
