"""Heterogeneous R-GAT training on a MAG240M-class schema, on the card.

PyTorch counterpart of the JAX package's ``examples/mag240m_rgat.py``
(the reference's ``benchmarks/ogbn-mag240m/``): a paper / author /
institution graph, hetero neighbour sampling (kernel B1's literal entry
once a sampled block), per-type feature lookups (B2 once a type) and
R-GAT.  Synthetic schema-compatible data.

    python -m quiver_tpu_torch.examples.mag240m_rgat
    python -m quiver_tpu_torch.examples.mag240m_rgat --device cpu \\
        --papers 800 --authors 400 --institutions 50 --steps 3 \\
        --batch-size 16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import (Clock, add_device_flag, device_of, key_words, losses_of, put,
               seeded)

CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")
EMPLOYS = ("institution", "employs", "author")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--papers", type=int, default=20_000)
    ap.add_argument("--authors", type=int, default=10_000)
    ap.add_argument("--institutions", type=int, default=500)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(edge_index_dict, counts, dims, tables, labels, rng)``: Poisson
    in-degrees per relation, normal features per type and random paper
    labels, all from ``default_rng(0)``; ``rng`` continues the stream (the
    training seeds come from it)."""
    rng = np.random.default_rng(0)

    def edges(n_src, n_dst, avg):
        deg = rng.poisson(avg, n_dst)
        dst = np.repeat(np.arange(n_dst), deg)
        return np.stack([rng.integers(0, n_src, len(dst)), dst])

    counts = {"paper": args.papers, "author": args.authors,
              "institution": args.institutions}
    eid = {
        CITES: edges(args.papers, args.papers, 8),
        WRITES: edges(args.authors, args.papers, 4),
        EMPLOYS: edges(args.institutions, args.authors, 2),
    }
    dims = {"paper": args.dim, "author": args.dim // 2, "institution": 16}
    tables = {t: rng.normal(size=(counts[t], dims[t])).astype(np.float32)
              for t in counts}
    labels = rng.integers(0, args.classes, args.papers)
    return eid, counts, dims, tables, labels, rng


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import HeteroFeature
    from ..hetero import HeteroCSRTopo, HeteroGraphSageSampler
    from ..models import RGAT
    from ..parallel import TrainState, make_train_step

    eid, counts, dims, tables, labels, rng = make_data(args)
    topo = HeteroCSRTopo.from_edge_index_dict(eid, counts)
    feats = HeteroFeature.from_cpu_tensors(tables, device_cache_size="10G",
                                           device=dev)
    sampler = HeteroGraphSageSampler(
        topo, sizes=[{CITES: 8, WRITES: 4, EMPLOYS: 2}] * 2,
        seed_type="paper", device=dev,
    )
    B = args.batch_size
    with seeded(1, dev):
        model = RGAT(in_dims=dims, hidden=64, out_dim=args.classes,
                     num_layers=2, layer_relations=sampler.layer_relations(B),
                     heads=4, dropout=0.0, device=dev)
    state = TrainState.create(model, lr=1e-3)
    step = make_train_step(state.model, state.optimizer)
    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    n_blocks = sampler.num_blocks(B)
    labels_dev = torch.from_numpy(labels).to(dev)

    clock = Clock(dev)
    losses, first = [], None
    for i in range(args.steps):
        seeds = rng.integers(0, args.papers, B)
        if first is None:
            first = seeds.copy()
        batch = sampler.sample(seeds, key_words=key_words(2 + i, n_blocks))
        loss = step(feats.lookup(batch), batch,
                    labels_dev[torch.from_numpy(seeds).to(dev)], ones)
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")
    dt = clock.lap()
    print(f"{args.steps} R-GAT steps in {dt:.2f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step)")
    put(report, first_seeds=first, losses=losses_of(losses), steps_s=dt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
