"""Train GraphSAGE on a graph whose edge array exceeds the card's budget,
on ONE card: the sampler's UVA mode.

PyTorch counterpart of the JAX package's
``examples/big_graph_single_chip.py`` (the reference's
``examples/pyg/ogbn_products_sage_quiver.py`` with ``mode="UVA"``): the
byte-budgeted hot rows (degree-ordered) sample on the card (kernel B1's
literal entry) while the cold tail samples on the native host sampler,
overlapped per hop (``quiver_tpu_torch/uva.py``); the budgeted feature
serves its hot rows with B2 (B5 with ``QUIVER_TPU_FEATURE_PAGED=on``).

    python -m quiver_tpu_torch.examples.big_graph_single_chip \\
        --nodes 500000 --deg 20 --graph-budget 20M --feature-budget 100M
    python -m quiver_tpu_torch.examples.big_graph_single_chip --device cpu \\
        --nodes 3000 --deg 8 --dim 16 --batch-size 64 --steps 4 \\
        --graph-budget 60K --feature-budget 100K
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import Clock, add_device_flag, device_of, losses_of, put, seeded


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=15)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--graph-budget", default="10M",
                    help="device byte budget for the edge array's hot tier")
    ap.add_argument("--feature-budget", default="40M",
                    help="device byte budget for the feature hot tier")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=30)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(topo, feat, labels, train_idx)`` from ``synthetic_csr`` and
    ``default_rng(0)``."""
    from ..utils.synthetic import synthetic_csr
    from ..utils.topology import CSRTopo

    rng = np.random.default_rng(0)
    indptr, indices = synthetic_csr(args.nodes, args.nodes * args.deg, 0)
    topo = CSRTopo(indptr=indptr, indices=indices)
    feat = rng.normal(size=(args.nodes, args.dim)).astype(np.float32)
    labels = rng.integers(0, args.classes, args.nodes)
    train_idx = rng.choice(args.nodes, args.nodes // 10, replace=False)
    return topo, feat, labels, train_idx


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import Feature, GraphSageSampler, SeedLoader
    from ..models import GraphSAGE
    from ..parallel import TrainState, make_train_step

    topo, feat, labels, train_idx = make_data(args)

    # BOTH big arrays get budgeted hot tiers: edges via UVA mode,
    # features via the cached Feature store
    sampler = GraphSageSampler(topo, [15, 10, 5], mode="UVA",
                               uva_budget=args.graph_budget, device=dev)
    feature = Feature(device_cache_size=args.feature_budget, csr_topo=topo,
                      device=dev).from_cpu_tensor(feat)
    with seeded(0, dev):
        model = GraphSAGE(args.dim, hidden=128, out_dim=args.classes,
                          num_layers=3, device=dev)
    state = TrainState.create(model, lr=3e-3)

    loader = SeedLoader(train_idx, sampler, feature, labels=labels,
                        batch_size=args.batch_size)
    it = iter(loader)
    b0, x0, y0, m0 = next(it)
    it.close()  # stops the epoch's prefetch worker
    print("uva split:", sampler._uva.stats())
    step = make_train_step(state.model, state.optimizer)

    clock = Clock(dev)
    losses, first, n = [], None, 0
    it = iter(loader)
    try:
        for batch, x, y, m in it:
            if first is None:
                first = batch.n_id[: args.batch_size].cpu().numpy()
            loss = step(x, batch.layers, y, m)
            losses.append(loss)
            n += 1
            if n >= args.steps:
                break
    finally:
        it.close()
        feature.close()
    dt = clock.lap()
    print(f"{n} steps in {dt:.2f}s ({dt / n * 1e3:.0f} ms/step), "
          f"final loss {float(loss):.3f}")
    put(report, first_seeds=first, losses=losses_of(losses), steps_s=dt,
        uva_split=sampler._uva.stats(),
        paged=feature.paged is not None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
