"""Cells of the benchmark at a size the CPU runs in seconds."""

import copy
import time

from portbench import core, run as prun

ROOT = core.HERE.parent
_BENCH = core.benchmark(ROOT)
_FILES = {c["name"]: c["file"] for c in _BENCH["configs"]}
# every cell of BENCHMARK.json: its configuration's file and traffic mix
CELLS = {w["name"]: (_FILES[w["config"]], w["traffic"])
         for w in _BENCH["workloads"]}
# the training cells, which the tests here drive
TRAIN = sorted(n for n, (_, mix) in CELLS.items() if core.load_json(
    core.HERE / "traffic" / f"{mix}.json")["kind"] == "train")


def cell(name: str) -> core.Cell:
    conf, mix = CELLS[name]
    cfg = copy.deepcopy(core.load_json(ROOT / conf))
    cfg["graph"] = {"nodes": 3000, "edges": 60000}
    cfg["feature_dim"], cfg["train_nodes"] = 24, 1500
    cfg["model"]["hidden"] = 16
    cfg["sampling"]["batch"] = 64
    m = dict(core.load_json(core.HERE / "traffic" / f"{mix}.json"))
    m.update(warmup_steps=1, trace_steps=2)
    return core.Cell(name=name, cfg=cfg, mix=m,
                     limits=core.load_json(core.HERE / "limits"
                                           / f"{name}.json"),
                     chips=1, end_to_end=[], per_layer=[])


def run(name: str, seed: int = 5, seconds: float = 0.4, device="cpu"):
    return prun.run_cell(cell(name), seed, seconds, False, device,
                         time.perf_counter())
