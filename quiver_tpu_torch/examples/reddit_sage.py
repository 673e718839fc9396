"""Reddit GraphSAGE: BASELINE config #1, on the card.

PyTorch counterpart of the JAX package's ``examples/reddit_sage.py``
(the reference's ``examples/pyg/reddit_quiver.py``: 2-layer SAGE, fanout
[25, 10]).  A synthetic graph at Reddit's scale: 232,965 nodes, 602-wide
features, 41 classes.  The table (561 MB) is larger than the default
``--cache 400M``, so the feature serves the hot rows from the card
(kernel B2) and the rest from the host.

    python -m quiver_tpu_torch.examples.reddit_sage
    python -m quiver_tpu_torch.examples.reddit_sage --device cpu \\
        --synthetic-nodes 2000 --epochs 1 --batch-size 128 --cache 5M
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import Clock, add_device_flag, device_of, key_words, losses_of, put
from . import seeded


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--cache", default="400M")
    ap.add_argument("--synthetic-nodes", type=int, default=232_965)
    ap.add_argument("--synthetic-classes", type=int, default=41)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(topo, feat, labels, train_idx)``: the community graph at the
    flags' size, 602-wide (Reddit's width), and the first half of a
    seeded permutation as the train split."""
    from ..utils.synthetic import community_graph

    n_cls = args.synthetic_classes
    topo, feat, labels = community_graph(
        args.synthetic_nodes, n_cls, intra_deg=30, inter_deg=10,
        feat_extra=602 - n_cls,  # Reddit dim = 602
    )
    train_idx = np.random.default_rng(0).permutation(
        topo.node_count)[: topo.node_count // 2]
    return topo, feat, labels, train_idx


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import Feature, GraphSageSampler
    from ..models import GraphSAGE
    from ..parallel import Prefetcher, TrainState, make_train_step

    topo, feat, labels, train_idx = make_data(args)
    n_cls = args.synthetic_classes
    print(f"graph: {topo.node_count:,} nodes, {topo.edge_count:,} edges")

    sampler = GraphSageSampler(topo, sizes=[25, 10], device=dev)
    feature = Feature(device_cache_size=args.cache, csr_topo=topo,
                      device=dev).from_cpu_tensor(feat)

    with seeded(0, dev):
        model = GraphSAGE(feat.shape[1], hidden=256, out_dim=n_cls,
                          num_layers=2, device=dev)
    state = TrainState.create(model, lr=1e-2)
    step = make_train_step(state.model, state.optimizer)
    B = args.batch_size
    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    n_batches = len(train_idx) // B
    rng = np.random.default_rng(1)

    def make_batch(i):
        seeds = train_idx[i * B: (i + 1) * B]
        batch = sampler.sample(seeds, key_words=key_words(i, 2))
        return batch, feature[batch.n_id], \
            torch.from_numpy(labels[seeds]).to(dev), seeds

    clock = Clock(dev)
    losses, epoch_s, first = [], [], None
    for epoch in range(args.epochs):
        rng.shuffle(train_idx)
        if first is None:
            first = train_idx[:B].copy()
        clock.reset()
        for batch, x, lab, seeds in Prefetcher(range(n_batches),
                                               make_batch, depth=2):
            loss = step(x, batch.layers, lab, ones)
            losses.append(loss)
        dt = clock.lap()
        epoch_s.append(dt)
        # sampled train accuracy on last batch
        model.eval()
        with torch.no_grad():
            logits = model(x, batch.layers)
        acc = float((logits.argmax(-1) == lab).float().mean())
        print(f"epoch {epoch}: {dt:.2f}s, loss {float(loss):.4f}, "
              f"batch acc {acc:.3f}")
    put(report, first_seeds=first, losses=losses_of(losses),
        epoch_s=epoch_s, steps=len(losses))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
