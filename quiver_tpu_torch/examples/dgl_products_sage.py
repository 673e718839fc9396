"""A DGL-style training loop over the port's sampler and Feature, on the
card.

PyTorch counterpart of the JAX package's ``examples/dgl_products_sage.py``
(parity direction: the reference's
``examples/dgl/ogbn_products_sage_quiver.py``, which pairs quiver.Feature
with a DGL NeighborSampler loop and dglnn.SAGEConv blocks).  The sampler
runs kernel B1 and the feature B2.  Two modes:

  * dgl installed: the samples convert to real DGL MFG blocks
    (``interop.to_dgl_blocks``) and train a dgl.nn SAGE.
  * dgl absent: the same loop runs a pure-torch SAGEConv over
    ``interop.block_specs``, identical math (mean aggregation + the
    ``h_dst = h[:n_dst]`` idiom), proving the adapter contract without the
    dependency.

    python -m quiver_tpu_torch.examples.dgl_products_sage
    python -m quiver_tpu_torch.examples.dgl_products_sage --device cpu \\
        --nodes 3000 --steps 30 --batch-size 256
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from . import Clock, add_device_flag, device_of, put, seeded


class TorchSAGEConv(torch.nn.Module):
    """dglnn.SAGEConv('mean')-equivalent over a block spec ``(src, dst,
    eid, n_src, n_dst)`` (host arrays)."""

    def __init__(self, din, dout, device=None):
        super().__init__()
        self.w_self = torch.nn.Linear(din, dout, device=device)
        self.w_neigh = torch.nn.Linear(din, dout, bias=False, device=device)

    def forward(self, spec, h, h_dst):
        src, dst, _, _, n_dst = spec
        dev = h.device
        agg = torch.zeros((n_dst, h.shape[1]), dtype=h.dtype, device=dev)
        cnt = torch.zeros((n_dst, 1), dtype=h.dtype, device=dev)
        idx = torch.from_numpy(dst.astype(np.int64)).to(dev)
        agg.index_add_(0, idx, h[torch.from_numpy(
            src.astype(np.int64)).to(dev)])
        cnt.index_add_(0, idx, torch.ones((len(dst), 1), device=dev))
        mean = agg / cnt.clamp(min=1)
        return self.w_self(h_dst) + self.w_neigh(mean)


class SpecSAGE(torch.nn.Module):
    """Two :class:`TorchSAGEConv` layers with a ReLU between them."""

    def __init__(self, dim, classes, device=None):
        super().__init__()
        self.l1 = TorchSAGEConv(dim, 64, device=device)
        self.l2 = TorchSAGEConv(64, classes, device=device)

    def forward(self, blocks, x):
        h = x
        for layer, spec in zip((self.l1, self.l2), blocks):
            h_dst = h[: spec[4]]
            h = layer(spec, h, h_dst)
            if layer is self.l1:
                h = F.relu(h)
        return h


def dgl_sage(dim, classes, device):
    """The dgl.nn SAGE of the dgl mode (needs ``dgl``)."""
    import dgl.nn.pytorch as dglnn

    class SAGE(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = dglnn.SAGEConv(dim, 64, "mean")
            self.l2 = dglnn.SAGEConv(64, classes, "mean")

        def forward(self, blocks, x):
            h = x
            for layer, block in zip((self.l1, self.l2), blocks):
                h_dst = h[: block.num_dst_nodes()]
                h = layer(block, (h, h_dst))
                if layer is self.l1:
                    h = F.relu(h)
            return h

    return SAGE().to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def make_data(args):
    """``(topo, feat, labels)``: a noisy community graph with 16 extra
    feature columns."""
    from ..utils.synthetic import community_graph

    return community_graph(args.nodes, args.classes, intra_deg=8,
                           inter_deg=2, noise=0.6, feat_extra=16, seed=0)


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import Feature, GraphSageSampler
    from ..interop import block_specs

    try:
        import dgl  # noqa: F401

        from ..interop import to_dgl_blocks

        have_dgl = True
    except ImportError:
        have_dgl = False
    print(f"dgl available: {have_dgl}")

    topo, feat, labels = make_data(args)
    sampler = GraphSageSampler(topo, [10, 5], device=dev)
    feature = Feature(device_cache_size=topo.node_count, cache_unit="rows",
                      device=dev).from_cpu_tensor(feat)
    dim = feat.shape[1]

    with seeded(0, dev):
        model = (dgl_sage(dim, args.classes, dev) if have_dgl
                 else SpecSAGE(dim, args.classes, device=dev))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    rng = np.random.default_rng(1)
    clock = Clock(dev)
    losses, first = [], None
    for step in range(args.steps):
        seeds = rng.integers(0, topo.node_count, args.batch_size)
        if first is None:
            first = seeds.copy()
        batch = sampler.sample(seeds)
        x = feature[batch.n_id]
        blocks = ([b.to(dev) for b in to_dgl_blocks(batch)] if have_dgl
                  else block_specs(batch))
        out = model(blocks, x)
        y = torch.from_numpy(labels[seeds].astype(np.int64)).to(dev)
        loss = F.cross_entropy(out[: args.batch_size], y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if step % 10 == 0:
            print(f"step {step}: loss {losses[-1]:.3f}")
    dt = clock.lap()
    print(f"{args.steps} steps in {dt:.1f}s; loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f} "
          f"({'dgl blocks' if have_dgl else 'block_specs fallback'})")
    put(report, first_seeds=first, losses=losses, steps_s=dt,
        dgl=have_dgl)
    assert np.mean(losses[-5:]) < losses[0]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
