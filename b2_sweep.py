#!/usr/bin/env python3
"""The route sweep of kernel B2 on one CUDA card.

    python3 b2_sweep.py

B2 (``csrc/gather_rows.cu``) has two routes, and
``ops/cuda/gather_rows.py::route`` picks one from the call's shapes: the
direct route copies each position's row; the grouped route sorts the
positions by row first and reads each row once a chunk of slots.  This
script times both routes (``gather_rows_route``) at:

- the main path's lookups, made as ``chip_smoke.py`` makes them: Reddit's
  bucket-2048 pass (585,728 frontier ids, 602-wide fp32 and bf16 rows,
  through the feature's row order), the ogbn-products fused step
  (1,081,344 ids, 100-wide fp32 rows, through the row order) and one
  R-GAT batch on the MAG240M schema (the paper, author and institution
  lookups, 768-wide fp32 rows, no order);
- the edges of the rule, each moved on its own from Reddit's fp32 lookup:
  the ids of smaller buckets and a random share of bucket 2048's (fewer
  ids a row), the table cut to fewer columns or widened (shorter and
  longer rows) and the table cut to fewer rows with the ids folded onto
  them (a smaller table, 2.5 ids a row).

Each case is held bitwise against the plain version through both routes
and timed whole (CUDA events behind a spin kernel, median of 15; the
grouped route's counting sort included), beside ``index_select`` on the
mapped ids and the route the rule picks.  For the main-path lookups it
also lists each route's device time by kernel (``torch.profiler``) and
the card's ceilings at the output's size (a fill, a copy, rows scattered
by ``index_copy_``, ``index_select`` of rows in order).  It prints the
card's name and power limit, one JSON line per case, and last one JSON
object with every case.  Exits non-zero without a card or on any
mismatch.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as cs

ROUTES = ("direct", "grouped")
BUCKETS = (512, 1024)            # Reddit ids of smaller serving buckets
SHARES = (0.9, 1.5, 2.0)         # ids a row, drawn from bucket 2048's
WIDTHS = (102, 118, 150, 202, 402, 450, 502, 550, 600, 768)  # fp32, 408-3,072 B
TABLE_ROWS = (20_000, 30_000, 40_000, 80_000, 160_000)  # 48-385 MB
IDS_A_ROW = 2.5


def reddit_ids(torch, ip, ix, batch: int, dev):
    """The frontier of one Reddit pass of ``batch`` seeds."""
    from quiver_tpu_torch.sampler import run_pipeline

    rng = np.random.default_rng(cs.SEED + 1)
    kw = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)
    seeds = torch.from_numpy(
        rng.integers(0, cs.N_NODES, batch).astype(np.int32)).to(dev)
    return run_pipeline("none", ip, ix, seeds, kw, cs.FANOUTS,
                        gather_mode="pwindow")[0]


def reddit_cases(torch, qt, dev):
    """``(name, group, make)`` of the Reddit lookups, ``make()`` giving
    ``(table, ids, order)``; the main ones first, then the rule's edges."""
    indptr, indices = qt.synthetic_csr(cs.N_NODES, cs.N_EDGES, seed=cs.SEED)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    feat = np.random.default_rng(cs.SEED).standard_normal(
        (cs.N_NODES, cs.DIM), dtype=np.float32)
    f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                   device=dev).from_cpu_tensor(feat)
    ip, ix = topo.to_device(dev)
    ids = {b: reddit_ids(torch, ip, ix, b, dev) for b in (*BUCKETS, 2048)}
    del topo, ip, ix, indptr, indices, feat
    table, order, n_id = f.hot, f._order_dev, ids[2048]

    def cut(w):
        if w <= table.shape[1]:
            return table[:, :w].contiguous()
        return torch.cat([table, table[:, :w - table.shape[1]]], 1)

    def draw(ids_a_row):
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        keep = torch.randperm(n_id.shape[0], generator=g, device=dev)
        return n_id[keep[:int(ids_a_row * table.shape[0])]]

    def fold(rows):
        m = int(IDS_A_ROW * rows)
        return (table[:rows].contiguous(),
                (order[n_id[:m].to(torch.int64)] % rows).to(torch.int32),
                None)

    out = [("Reddit fp32", "main", lambda: (table, n_id, order)),
           ("Reddit bf16", "main",
            lambda: (table.to(torch.bfloat16), n_id, order))]
    out += [(f"Reddit fp32, bucket {b}", "ids a row",
             lambda b=b: (table, ids[b], order)) for b in BUCKETS]
    out += [(f"Reddit fp32, {r} ids a row", "ids a row",
             lambda r=r: (table, draw(r), order)) for r in SHARES]
    out += [(f"Reddit fp32, {w} wide", "row bytes",
             lambda w=w: (cut(w), n_id, order)) for w in WIDTHS]
    out += [(f"Reddit fp32, {r} rows", "table bytes",
             lambda r=r: fold(r)) for r in TABLE_ROWS]
    return out


def other_cases(torch, qt, dev):
    """``(name, group, make)`` of the products and MAG240M lookups."""
    from quiver_tpu_torch.sampler import run_pipeline

    ptopo, pfeat, _, train = cs.products_data(qt)
    pf = qt.Feature(device_cache_size=pfeat.nbytes, csr_topo=ptopo,
                    device=dev).from_cpu_tensor(pfeat)
    ip, ix = ptopo.to_device(dev)
    seeds, kw = cs.products_batch(torch, dev, train)
    n_id = run_pipeline("none", ip, ix, seeds, kw, cs.P_FANOUTS,
                        gather_mode="pwindow")[0]
    out = [("products", "main", lambda: (pf.hot, n_id, pf._order_dev))]
    del ptopo, pfeat, ip, ix

    mtopo, tables, _ = cs.mag_data(torch, qt)
    hf = qt.HeteroFeature.from_cpu_tensors(
        tables, device_cache_size=max(a.nbytes for a in tables.values()),
        device=dev)
    del tables
    sampler = qt.HeteroGraphSageSampler(mtopo, cs.MAG_FANOUTS,
                                        seed_type="paper", device=dev,
                                        seed=cs.SEED)
    seeds = torch.from_numpy(np.random.default_rng(cs.SEED + 21).permutation(
        cs.MAG_COUNTS["paper"])[:cs.MAG_BATCH].astype(np.int32)).to(dev)
    batch = sampler.sample(seeds)
    for t, feature in hf.features.items():
        out.append((f"MAG {t}", "main",
                    lambda f=feature, t=t: (f.hot, batch.n_id[t],
                                            f._order_dev)))
    return out


def ceilings(torch, table, ids, library_ms) -> dict:
    """The card's times for work of the output's size."""
    m = ids.shape[0]
    out = torch.empty((m, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    src = torch.empty_like(out)
    perm = torch.randperm(m, device=table.device)
    seq = torch.arange(m, device=table.device) % table.shape[0]
    return dict(
        fill=cs.cuda_ms(torch, lambda: out.fill_(1)),
        copy=cs.cuda_ms(torch, lambda: out.copy_(src)),
        scatter_rows=cs.cuda_ms(torch, lambda: out.index_copy_(0, perm, src)),
        index_select_sequential=cs.cuda_ms(
            torch, lambda: torch.index_select(table, 0, seq)),
        index_select=library_ms)


def measure(torch, b2, name, group, table, ids, order) -> dict:
    """Both routes of one lookup, held bitwise and timed."""
    m, n = ids.shape[0], table.shape[0]
    row = table.shape[1] * table.element_size()
    mapped = ids.to(torch.int64).clamp(0, n - 1)
    if order is not None:
        mapped = order[mapped]
    want = b2.gather_rows_plain(table, ids, order)
    bits = {2: torch.int16, 4: torch.int32}[table.element_size()]
    for which in ROUTES:
        got = b2.gather_rows_route(table, ids, order, which)
        torch.cuda.synchronize()
        cs.check(torch.equal(got.view(bits), want.view(bits)),
                 f"{name}: the {which} route differs from the plain version")
        del got
    del want
    case = dict(case=name, group=group, m=m, n=n, row_bytes=row,
                table_mb=n * row / 1e6, ids_a_row=m / n,
                distinct_rows=int(torch.unique(mapped).shape[0]),
                rule=b2.route(m, n, row))
    for which in ROUTES:
        case[f"{which}_ms"] = cs.cuda_ms(torch, lambda: b2.gather_rows_route(
            table, ids, order, which))
    case["library_ms"] = cs.cuda_ms(
        torch, lambda: torch.index_select(table, 0, mapped))
    case["faster"] = min(ROUTES, key=lambda w: case[f"{w}_ms"])
    if group == "main":
        case["ceilings"] = ceilings(torch, table, ids, case["library_ms"])
        for which in ROUTES:
            prof = cs.device_profile(torch, lambda: b2.gather_rows_route(
                table, ids, order, which), 1.0, top=8)
            case[f"{which}_kernels"] = prof.get("top", prof)
    return case


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b2_sweep: no CUDA device available", file=sys.stderr)
        return 2
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.ops.cuda import gather_rows as b2

    dev = torch.device(cs.DEV)
    print(f"card: {cs.card_line()}", flush=True)
    cases = []
    for make_cases in (reddit_cases, other_cases):
        t0 = time.perf_counter()
        made = make_cases(torch, qt, dev)
        print(f"{make_cases.__name__}: made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for name, group, make in made:
            case = measure(torch, b2, name, group, *make())
            print("case " + json.dumps(case), flush=True)
            cases.append(case)
        del made
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps(dict(cases=[{k: v for k, v in c.items()
                                  if not k.endswith(("kernels", "ceilings"))}
                                 for c in cases])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
