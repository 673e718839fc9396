#!/usr/bin/env python3
"""The sampling pipeline's host cost and device operations under
``gather_mode="pwindow"`` in two trees of this repository, on one CUDA card.

    python3 pipeline_compare.py OTHER_TREE

OTHER_TREE is another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into the git-ignored ``build/``.  Each
tree runs in a process of its own, in the order other, this, this, other
(so that drift on the card or the host falls on both).  Each process
imports the package from its tree, builds kernel B1 from that tree's
sources, makes ``chip_smoke.py``'s Reddit-sized graph and measures
``run_pipeline`` with ``chip_smoke.pipeline_cost`` at each depth of two
batches: the Reddit pass of ``chip_smoke.kernel_phase`` (2,048 seeds,
fanouts [25, 10]) and one of the products batch's shape (1,024 seeds,
fanouts [15, 10, 5]) on the same graph.  It prints the card's name and
power limit, one JSON line per run and last one JSON object with all runs.
Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

HERE = Path(__file__).resolve().parent


def child(tree: str) -> None:
    """One tree's measurements, printed as the last line."""
    sys.path.insert(0, tree)
    import torch

    import quiver_tpu_torch as qt
    from quiver_tpu_torch.ops.cuda import build
    from quiver_tpu_torch.sampler import run_pipeline

    pkg = Path(qt.__file__).resolve().parent
    cs.check(pkg.parent == Path(tree).resolve(),
             f"imported {pkg}, not the package of {tree}")
    build.build_all(["window_sample"])
    indptr, indices = qt.synthetic_csr(cs.N_NODES, cs.N_EDGES, seed=cs.SEED)
    ip, ix = qt.CSRTopo(indptr=indptr, indices=indices).to_device(cs.DEV)
    rng = np.random.default_rng(cs.SEED + 1)  # as kernel_phase draws them
    kw = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)
    seeds = torch.from_numpy(
        rng.integers(0, cs.N_NODES, 2048).astype(np.int32)).to(cs.DEV)
    kw_p = rng.integers(0, 2**32, size=(3, 2), dtype=np.uint32)
    seeds_p = torch.from_numpy(
        rng.integers(0, cs.N_NODES, cs.P_BATCH).astype(np.int32)).to(cs.DEV)
    with torch.inference_mode():
        out = dict(tree=tree, package=str(pkg), reddit=cs.pipeline_cost(
            torch, run_pipeline, ip, ix, seeds, kw, cs.FANOUTS),
            products_shape=cs.pipeline_cost(
                torch, run_pipeline, ip, ix, seeds_p, kw_p, cs.P_FANOUTS))
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("pipeline_compare: no CUDA device available", file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    cs.check((Path(other) / "quiver_tpu_torch").is_dir(),
             f"{other} holds no quiver_tpu_torch")
    print(f"card: {cs.card_line()}", flush=True)
    runs = []
    for tree in (other, str(HERE), str(HERE), other):
        env = dict(os.environ, PYTHONPATH="")
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child", tree], capture_output=True,
                              text=True, env=env, cwd=str(HERE),
                              timeout=600)
        sys.stderr.write(done.stderr[-4000:])
        cs.check(done.returncode == 0, f"the run of {tree} failed "
                 f"(rc {done.returncode})")
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": cs.card_line(), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
