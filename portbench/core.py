"""What every cell shares: its definition found by name, the run's
state, the comparison against limits, and the result line."""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "quiver_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files: the
    configuration, the traffic mix, the limits of its comparison, and the
    metrics it reports."""

    name: str
    cfg: dict
    mix: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, cfg=load_json(root / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


@dataclass
class Run:
    """One run of one cell: its arguments, and what the driver measured."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float            # perf_counter at process start
    e2e: Dict[str, float] = field(default_factory=dict)
    layer: Dict[str, object] = field(default_factory=dict)  # readers' input
    checks: Dict[str, tuple] = field(default_factory=dict)  # name: (v, lim)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    traced: Optional[dict] = None  # trace.reduce() of the capture
    marks: List[tuple] = field(default_factory=list)
    keep: Dict[str, object] = field(default_factory=dict)  # for calibrate

    def mark(self, what: str) -> None:
        """Note the seconds since process start at the end of a phase."""
        self.marks.append((what, time.perf_counter() - self.t_start))

    def end_setup(self) -> None:
        """Set-up is over: record ``setup_s``."""
        self.e2e["setup_s"] = time.perf_counter() - self.t_start
        self.mark("set-up")

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` against the cell's limit of that name."""
        self.checks[name] = (float(value), float(self.cell.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def now() -> float:
    return time.perf_counter()


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    out = dict(correct=run.correct, attempted=run.attempted,
               failed=run.failed, metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in run.checks.items()}
    return json.dumps(out)


def print_checks(run: Run) -> None:
    print("phases: " + ", ".join(f"{w} {t:.3f} s" for w, t in run.marks),
          file=sys.stderr)
    for n, (v, lim) in run.checks.items():
        ok = "ok" if math.isfinite(v) and v <= lim else "FAIL"
        print(f"check {n} = {v!r} limit {lim!r} {ok}", file=sys.stderr)
