"""Data-parallel training over a mesh, a papers100M-class setup.

PyTorch counterpart of the JAX package's ``examples/papers100M_dist.py``
(the reference's ``benchmarks/ogbn-papers100M/train_quiver_multi_node.py``:
there each host keeps a probability-partitioned feature partition, an
NCCL request/response exchange serves remote rows, and DDP syncs the
gradients).  Here the same roles are played by a row-sharded graph
(:class:`DistGraphSampler`, kernel B3 for its reads), a partitioned
:class:`DistFeature` (B2 for each shard's lookup) or the two-tier
:class:`HierFeature` (``--hier``), and the data-parallel train step.

The mesh is single-controller, as JAX's: one process drives every shard.
JAX builds it over every device it sees; ``--mesh-devices N`` builds it
over N shards of the visible cards in turn, so one card repeated N times
stands in for N cards.

    python -m quiver_tpu_torch.examples.papers100M_dist --mesh-devices 4
    python -m quiver_tpu_torch.examples.papers100M_dist --device cpu \\
        --mesh-devices 4 --nodes 3000 --edges 30000 --steps 2 \\
        --batch-size 8 --dim 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import (Clock, add_device_flag, device_of, losses_of, mesh_devices,
               put, seeded)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--edges", type=int, default=2_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--hier", type=int, default=0, metavar="N_HOSTS",
                    help="use the two-tier ICI x DCN HierFeature over an "
                         "[N_HOSTS, devices/N_HOSTS] mesh (degree-ordered "
                         "hot tier covering 30%% of nodes)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="shards of the mesh, over the visible cards in "
                         "turn: this stands in for the card count (JAX's "
                         "mesh takes every device); 0: every visible card, "
                         "or one CPU device")
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args, nd: int):
    """``(topo, feat, labels, g2h, rng)`` for an ``nd``-shard mesh, from
    ``default_rng(0)``: lognormal degrees scaled to ``--edges``, normal
    features, random labels, and (without ``--hier``) a random owner
    shard a node.  ``rng`` continues the stream (the seeds come from
    it)."""
    from ..utils.topology import CSRTopo

    rng = np.random.default_rng(0)
    deg = np.maximum(
        rng.lognormal(2.0, 1.0, args.nodes), 1
    ).astype(np.int64)
    deg = (deg * args.edges / deg.sum()).astype(np.int64) + 1
    src = np.repeat(np.arange(args.nodes), deg)
    dst = rng.integers(0, args.nodes, len(src))
    topo = CSRTopo(edge_index=np.stack([src, dst]))
    feat = rng.normal(size=(args.nodes, args.dim)).astype(np.float32)
    labels = rng.integers(0, args.classes, args.nodes)
    g2h = (None if args.hier
           else rng.integers(0, nd, topo.node_count).astype(np.int32))
    return topo, feat, labels, g2h, rng


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import DistFeature, DistGraphSampler, HierFeature, PartitionInfo
    from ..models import GraphSAGE
    from ..parallel import TrainState, make_train_step
    from ..utils.mesh import Mesh, make_mesh

    devs = mesh_devices(dev, args.mesh_devices)
    mesh = make_mesh(("data",), devices=devs)
    nd = int(mesh.shape["data"])
    print(f"mesh: {nd} devices")

    topo, feat, labels, g2h, rng = make_data(args, nd)

    # graph row-sharded over the mesh; feature partitioned over the mesh
    sampler = DistGraphSampler(topo, mesh, sizes=[10, 5])
    hier_feat = hier_old2new = dist_feat = None
    if args.hier:
        H = args.hier
        hmesh = Mesh(np.array(devs, dtype=object).reshape(H, nd // H),
                     ("dcn", "ici"))
        order = np.argsort(-topo.degree, kind="stable")
        hier_old2new = np.empty(args.nodes, dtype=np.int32)
        hier_old2new[order] = np.arange(args.nodes, dtype=np.int32)
        hier_feat = HierFeature.from_global_feature(
            feat[order], hmesh, hot_count=int(args.nodes * 0.3),
            global2host=(np.arange(args.nodes) % H).astype(np.int32))
    else:
        info = PartitionInfo(host=0, hosts=nd, global2host=g2h)
        dist_feat = DistFeature.from_global_feature(feat, mesh, info)

    home = mesh.axis_devices("data")[0]
    with seeded(0, home):
        model = GraphSAGE(args.dim, hidden=128, out_dim=args.classes,
                          num_layers=2, dropout=0.0, device=home)
    state = TrainState.create(model, lr=1e-3)
    B = args.batch_size

    def sample_round(step):
        seeds = rng.integers(0, topo.node_count, (nd, B))
        n_id, n_mask, num, blocks = sampler.sample(seeds, key=step)
        if hier_feat is not None:
            ids = torch.from_numpy(hier_old2new)[n_id.cpu().long()]
            out = hier_feat.lookup(
                ids.reshape(hier_feat.H, hier_feat.C, -1))
            xs = out.reshape(nd, -1, args.dim)
        else:
            xs = dist_feat.lookup(n_id)
        labs = torch.from_numpy(labels[seeds])
        return seeds, blocks, xs, labs

    first, _, _, _ = sample_round(0)
    step_fn = make_train_step(state.model, state.optimizer, mesh=mesh)

    masks = torch.ones((nd, B), dtype=torch.bool)
    clock = Clock(dev)
    losses = []
    for i in range(args.steps):
        _, blocks, xs, labs = sample_round(i)
        loss = step_fn(xs, blocks, labs, masks)
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f}")
    dt = clock.lap()
    print(f"{args.steps} DP steps x {nd} replicas x {B} seeds "
          f"in {dt:.2f}s ({dt / args.steps * 1e3:.0f} ms/step)")
    if hier_feat is not None:
        st = hier_feat.traffic_stats()
        print(f"hier: last-batch DCN crossings "
              f"{int(st['dcn_crossings'].sum())}, drops "
              f"{int(st['drops'].sum())}")
    put(report, first_seeds=first, losses=losses_of(losses), steps_s=dt,
        replicas=nd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
