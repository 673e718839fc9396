#!/usr/bin/env python3
"""The walk sweep of kernels B3 and B4 on one CUDA card.

    python3 walk_sweep.py

B3 (``csrc/element_gather.cu``) and B4 (``csrc/lane_select.cu``) walk
their elements with a fixed number of ids a thread per step (V) and
threads a block, set at compile time in ``csrc/element_gather.cuh``
(``QTT_WALK_V``, ``QTT_WALK_THREADS``).  This script builds both libraries
once for each walk in ``WALKS`` (``nvcc`` with those macros set, into
``build/walk_sweep/``, several builds at once), then, at the reads of one
ogbn-products batch as ``chip_smoke.py`` makes them (1,024 seeds, fanouts
[15, 10, 5]), times with CUDA events behind a spin kernel (median of 15):

- B3's pair read of ``indptr`` and its read of ``indices`` at each hop;
- B4's fused entry at hop 3's ``indices`` draws;

after checking each walk's results bitwise against the plain versions.
It prints the card's name and power limit, one JSON line per walk, and
last one JSON object with every walk, the built-in walk and the walk with
the least B3 time summed over the three hops.  Exits non-zero without a
card or on any mismatch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import chip_smoke as cs

# (ids a thread per step, threads a block); the first is the built-in walk
WALKS = [(4, 128)] + [(v, t) for v in (1, 2, 4, 8) for t in (128, 256, 512)
                      if (v, t) != (4, 128)]
LIBS = ("element_gather", "lane_select")
JOBS = 8  # nvcc processes at once

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
ARGTYPES = {
    ("element_gather", "element_gather"): (_P, _I64, _P, _P, _I64, _INT, _P),
    ("element_gather", "element_gather_pair"):
        (_P, _I64, _P, _P, _P, _I64, _INT, _P),
    ("lane_select", "lane_select_rows"):
        (_P, _I64, _P, _P, _P, _I64, _INT, _P),
}


def build_walks(build) -> dict:
    """One library per (walk, kernel), built JOBS at a time; returns
    ``{(v, t, lib): path}``."""
    out_dir = build.BUILD_DIR.parent / "walk_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = []
    for v, t in WALKS:
        for lib in LIBS:
            out = out_dir / f"lib{lib}-v{v}-t{t}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DQTT_WALK_V={v}",
                   f"-DQTT_WALK_THREADS={t}", "-o", str(out),
                   str(build.CSRC / f"{lib}.cu")]
            todo.append(((v, t, lib), out, cmd))
    paths, running = {}, []
    try:
        while todo or running:
            while todo and len(running) < JOBS:
                key, out, cmd = todo.pop(0)
                running.append((key, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            key, out, proc = running.pop(0)
            log = proc.communicate()[0].decode()
            cs.check(proc.returncode == 0, f"nvcc {key}: {log}")
            paths[key] = out
    finally:
        for _, _, proc in running:
            proc.kill()
            proc.wait()
    return paths


def load(paths, v, t):
    """The three C functions of walk ``(v, t)``."""
    fns = {}
    for (lib, fn), argtypes in ARGTYPES.items():
        f = getattr(ctypes.CDLL(str(paths[(v, t, lib)])), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        fns[fn] = f
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("walk_sweep: no CUDA device available", file=sys.stderr)
        return 2
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.ops.cuda import build
    from quiver_tpu_torch.ops.cuda import element_gather as b3
    from quiver_tpu_torch.ops.cuda import lane_select as b4

    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    paths = build_walks(build)
    print(f"built {len(paths)} libraries in {time.perf_counter() - t0:.2f} s",
          flush=True)

    topo, _, _, train = cs.products_data(qt)
    dev = torch.device(cs.DEV)
    ip, ix = topo.to_device(dev)
    ip2d, ix2d = ip.view(-1, 128), ix.view(-1, 128)
    hops = cs.products_hops(torch, ip, ix, train)
    row3, lane3 = hops[-1][1] >> 7, hops[-1][1] & 127
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, *args):
        cs.check(fn(*args, stream) == 0, f"{fn.__name__} launch")

    def pair(fns, n_id):
        lo, hi = torch.empty((2, n_id.shape[0]), dtype=torch.int32,
                             device=dev).unbind(0)
        run(fns["element_gather_pair"], ip2d.data_ptr(), ip.numel(),
            n_id.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_id.numel(), 0)
        return lo, hi

    def single(fns, pos):
        out = torch.empty_like(pos)
        run(fns["element_gather"], ix2d.data_ptr(), ix.numel(),
            pos.data_ptr(), out.data_ptr(), pos.numel(), 0)
        return out

    def fused(fns):
        out = torch.empty_like(row3)
        run(fns["lane_select_rows"], ix2d.data_ptr(), ix2d.shape[0],
            row3.data_ptr(), lane3.data_ptr(), out.data_ptr(), row3.numel(), 0)
        return out

    want = [(b3.element_gather_pair_plain(ip2d, n_id),
             b3.element_gather_plain(ix2d, pos)) for n_id, pos in hops]
    want_b4 = b4.lane_select_plain(ix2d.index_select(0, row3), lane3)
    rows = []
    for v, t in WALKS:
        fns = load(paths, v, t)
        row = dict(per_thread=v, threads=t)
        for h, ((n_id, pos), (w_pair, w_single)) in enumerate(
                zip(hops, want), 1):
            lo, hi = pair(fns, n_id)
            got = single(fns, pos)
            torch.cuda.synchronize()
            cs.check(torch.equal(lo, w_pair[0]) and torch.equal(hi, w_pair[1])
                     and torch.equal(got, w_single),
                     f"walk {v}x{t}: hop {h} differs from the plain version")
            row[f"hop{h}_pair_ms"] = cs.cuda_ms(torch,
                                                lambda: pair(fns, n_id))
            row[f"hop{h}_indices_ms"] = cs.cuda_ms(torch,
                                                   lambda: single(fns, pos))
        row["b3_ms"] = sum(row[f"hop{h}_{r}_ms"] for h in (1, 2, 3)
                           for r in ("pair", "indices"))
        cs.check(torch.equal(fused(fns), want_b4),
                 f"walk {v}x{t}: B4 differs from the plain version")
        row["b4_hop3_indices_ms"] = cs.cuda_ms(torch, lambda: fused(fns))
        print("walk " + json.dumps(row), flush=True)
        rows.append(row)
    best = min(rows, key=lambda r: r["b3_ms"])
    best_b4 = min(rows, key=lambda r: r["b4_hop3_indices_ms"])
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps(dict(
        walks=rows, built_in=dict(per_thread=WALKS[0][0],
                                  threads=WALKS[0][1]),
        best_b3=dict(per_thread=best["per_thread"], threads=best["threads"],
                     b3_ms=best["b3_ms"]),
        best_b4=dict(per_thread=best_b4["per_thread"],
                     threads=best_b4["threads"],
                     ms=best_b4["b4_hop3_indices_ms"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
