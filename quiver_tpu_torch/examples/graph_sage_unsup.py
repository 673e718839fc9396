"""Unsupervised GraphSAGE, a link-prediction objective, on the card.

PyTorch counterpart of the JAX package's ``examples/graph_sage_unsup.py``
(the reference's ``examples/pyg/graph_sage_unsup_quiver.py``): positive
pairs are sampled edges, negatives are random nodes, the loss is
``-log s(z_u . z_v) - log s(-z_u . z_neg)`` on embeddings produced through
the sampled-neighbourhood encoder (kernels B1 and B2).

    python -m quiver_tpu_torch.examples.graph_sage_unsup
    python -m quiver_tpu_torch.examples.graph_sage_unsup --device cpu \\
        --nodes 1500 --steps 6 --batch-size 64
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from . import (Clock, add_device_flag, device_of, key_words, losses_of, put,
               seeded)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(topo, feat, comm)``: community structure gives unsupervised
    learning something to find."""
    from ..utils.synthetic import community_graph

    return community_graph(args.nodes, args.classes, intra_deg=8,
                           inter_deg=2)


def pair_loss(z: torch.Tensor, B: int) -> torch.Tensor:
    """The link-prediction loss over ``z = [z_u; z_v; z_neg]`` (``[3B,
    D]``): positive edges pulled together, random pairs pushed apart."""
    zu, zv, zn = z[:B], z[B:2 * B], z[2 * B:]
    pos = F.logsigmoid((zu * zv).sum(-1))
    neg = F.logsigmoid(-(zu * zn).sum(-1))
    return -(pos + neg).mean()


def cosine_probe(z: np.ndarray, comm: np.ndarray, probe: np.ndarray):
    """Mean cosine similarity of the probe's embeddings within a community
    and across communities: ``(intra, inter)``."""
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    same = comm[probe[:, None]] == comm[probe[None, :]]
    sims = z @ z.T
    return float(sims[same].mean()), float(sims[~same].mean())


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import Feature, GraphSageSampler
    from ..models import GraphSAGE

    topo, feat, comm = make_data(args)
    feature = Feature(device_cache_size="10G",
                      device=dev).from_cpu_tensor(feat)
    sampler = GraphSageSampler(topo, [10, 5], device=dev)
    with seeded(1, dev):
        model = GraphSAGE(feat.shape[1], hidden=64, out_dim=32,
                          num_layers=2, dropout=0.0, device=dev)

    rng = np.random.default_rng(0)
    B = args.batch_size
    src_all = np.repeat(np.arange(topo.node_count), np.asarray(topo.degree))

    def make_batch(i):
        # positive pairs: random edges (u -> v); negatives: random nodes
        eids = rng.integers(0, topo.edge_count, B)
        u, v = src_all[eids], topo.indices[eids].astype(np.int64)
        neg = rng.integers(0, topo.node_count, B)
        seeds = np.concatenate([u, v, neg])
        batch = sampler.sample(seeds, key_words=key_words(i, 2))
        return seeds, batch, feature[batch.n_id]

    first, b0, x0 = make_batch(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step(x, blocks) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = pair_loss(model(x, blocks), B)
        loss.backward()
        opt.step()
        return loss.detach()

    clock = Clock(dev)
    losses = []
    for i in range(args.steps):
        _, batch, x = make_batch(i)
        loss = step(x, batch.layers)
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")
    dt = clock.lap()
    print(f"{args.steps} unsup steps in {dt:.2f}s")

    # probe: do embeddings separate communities? (cosine sim intra vs inter)
    probe = rng.integers(0, topo.node_count, 3 * B)
    pb = sampler.sample(probe, key_words=key_words(99, 2))
    model.eval()
    with torch.no_grad():
        z = model(feature[pb.n_id], pb.layers).cpu().numpy()
    intra, inter = cosine_probe(z, comm, probe)
    print(f"intra-community cos sim {intra:.3f} vs inter {inter:.3f}")
    put(report, first_seeds=first, losses=losses_of(losses), steps_s=dt,
        intra=intra, inter=inter)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
