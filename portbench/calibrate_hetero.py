"""Readings that set the limits of the hetero cell's ``correct``; run on
the card, never by the benchmark's own runs.

    python3 -m portbench.calibrate_hetero --workload mag240m-rgat.train \\
        --seeds a,b,...
        For each seed, one run of the cell (a short window): the program's
        readings, the control's (the reference in the program's place with
        TF32 matmuls, the nearest lower precision) and the planted fault's
        (the loss over half of each batch).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check_hetero, core, run as prun
from .calibrate import _look


def _limits(cell: core.Cell, seeds, seconds: float) -> None:
    cfg = cell.cfg
    for seed in seeds:
        t = time.perf_counter()
        r = prun.run_cell(cell, seed, seconds, False, "cuda", t)
        k = r.keep
        out = dict(seed=seed,
                   program=check_hetero.train_readings(k["rec"], k["ref"]),
                   look=_look(k["rec"], k["ref"], k["inp"].weights,
                              cfg["optimizer"]["lr"]),
                   train_seeds_per_s=r.e2e["train_seeds_per_s"],
                   setup_s=r.e2e["setup_s"], memory_peak=r.memory_peak)
        for name, kw in (("control", dict(tf32=True)),
                         ("fault_half", dict(fault="half"))):
            o = check_hetero.reference_train(k["inp"], cfg, k["rec"]["feeds"],
                                             k["dropout_seed"], r.device,
                                             **kw)
            out[name] = check_hetero.train_readings(o, k["ref"], exact=False)
            med = float(np.median(list(k["ref"]["change"].values())))
            out[name]["change_gap_median_leaf"] = float(np.median(
                [abs(o["change"][n] - k["ref"]["change"][n])
                 / max(k["ref"]["change"][n], med) for n in o["change"]]))
            del o
        print(json.dumps(out), flush=True)
        del r, k
        gc.collect()
        torch.cuda.empty_cache()


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate_hetero")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    cell = core.find_cell(Path.cwd(), a.workload)
    if not torch.cuda.is_available():
        print("calibrate_hetero needs a CUDA card", file=sys.stderr)
        return 2
    _limits(cell, [int(s) for s in a.seeds.split(",")], a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
