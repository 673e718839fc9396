"""Readings that set the limits of ``correct``; run on the card, never
by the benchmark's own runs.

    python3 -m portbench.calibrate --workload <cell> --seeds a,b,...
        For each seed, one run of the training cell (a short window): the
        program's readings, the control's (the reference in the program's
        place with TF32 matmuls, the nearest lower precision) and the
        planted fault's (the loss over half of each batch).  One JSON
        line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, core, run as prun


def _limits(cell: core.Cell, seeds, seconds: float) -> None:
    cfg = cell.cfg
    for seed in seeds:
        t = time.perf_counter()
        r = prun.run_cell(cell, seed, seconds, False, "cuda", t)
        k = r.keep
        out = dict(seed=seed,
                   program=check.train_readings(k["rec"], k["ref"]),
                   look=_look(k["rec"], k["ref"], k["inp"].weights,
                              cfg["optimizer"]["lr"]))
        ctl = check.reference_train(k["inp"], cfg, k["rec"]["feeds"],
                                    k["dropout_seed"], r.device, tf32=True)
        half = check.reference_train(k["inp"], cfg, k["rec"]["feeds"],
                                     k["dropout_seed"], r.device,
                                     fault="half")
        out["control"] = check.train_readings(ctl, k["ref"], exact=False)
        out["fault_half"] = check.train_readings(half, k["ref"], exact=False)
        med = float(np.median(list(k["ref"]["change"].values())))
        for name, o in (("control", ctl), ("fault_half", half)):
            out[name]["change_gap_median_leaf"] = float(np.median(
                [abs(o["change"][n] - k["ref"]["change"][n])
                 / max(k["ref"]["change"][n], med)
                 for n in o["change"]]))
        print(json.dumps(out), flush=True)
        del r
        torch.cuda.empty_cache()


def _look(prog: dict, ref: dict, w0: dict, lr: float) -> dict:
    """Where the program's parameter change departs from the reference's:
    for the worst leaf, the elements whose change differs by more than
    half the learning rate (an Adam update of the other sign or size),
    and their first gradients against the leaf's median magnitude; and
    the median leaf's change gap."""
    worst = check.train_readings(prog, ref, exact=False)["change_leaf"]
    dp = prog["params"][worst] - w0[worst]
    dr = ref["params"][worst] - w0[worst]
    diff = (dp - dr).abs()
    far = diff > 0.5 * lr
    g = ref["grad1"][worst].abs()
    med = float(g.median())
    med_leaf = float(np.median(list(ref["change"].values())))
    return dict(
        worst_leaf=worst, leaf_size=int(dp.numel()),
        elements_apart=int(far.sum()),
        largest_apart_over_lr=float(diff.max()) / lr,
        elements_over_1e_3_lr=int((diff > 1e-3 * lr).sum()),
        their_grad_over_median=[float(v) / max(med, 1e-30)
                                for v in g[far][:8]],
        grad_gap_there=[float(v) for v in
                        (prog["grad1"][worst] - ref["grad1"][worst]).abs()[far][:8]],
        change_gap_median_leaf=float(np.median(
            [abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n],
                                                             med_leaf)
             for n in ref["change"]])))


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    cell = core.find_cell(Path.cwd(), a.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    _limits(cell, [int(s) for s in a.seeds.split(",")], a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
