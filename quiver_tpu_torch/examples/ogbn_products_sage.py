"""ogbn-products GraphSAGE training, the flagship example, on the card.

PyTorch counterpart of the JAX package's ``examples/ogbn_products_sage.py``
(the reference's ``examples/pyg/ogbn_products_sage_quiver.py``, quality
bar test acc ~0.787).  The same "3-line swap" shape: build CSRTopo ->
GraphSageSampler -> Feature, then a normal training loop.  When the
feature budget holds the whole table, every step is the fused lane:
sampling (kernel B1 once a hop), the lookup (B2), forward, backward and
Adam with no host round trip; otherwise the staged step.

Reads ogbn-products from OGB's files when they are already on disk under
``--root`` (nothing is downloaded), else generates a synthetic
products-like graph with 47 classes and 100-wide features.

    python -m quiver_tpu_torch.examples.ogbn_products_sage \\
        --synthetic-nodes 2449029 --cache 1G
    python -m quiver_tpu_torch.examples.ogbn_products_sage --device cpu \\
        --force-synthetic --synthetic-nodes 3000 --epochs 1 \\
        --batch-size 128 --cache 10M
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import (Clock, add_device_flag, device_of, key_words, losses_of,
               mesh_devices, put, seeded)
from ..utils.rng import key as prng_key
from ..utils.topology import CSRTopo

# OGB's files of ogbn-products, under the dataset root
OGB_FILES = {"edge": "raw/edge.csv.gz", "feat": "raw/node-feat.csv.gz",
             "label": "raw/node-label.csv.gz",
             "train": "split/sales_ranking/train.csv.gz",
             "valid": "split/sales_ranking/valid.csv.gz",
             "test": "split/sales_ranking/test.csv.gz"}


def _read_ogb(root):
    """ogbn-products from OGB's raw files under ``root`` (or
    ``root/ogbn_products``); raises ``FileNotFoundError`` when they are
    not all there.  Never downloads."""
    for base in (os.path.join(root, "ogbn_products"), root):
        paths = {k: os.path.join(base, v) for k, v in OGB_FILES.items()}
        if all(os.path.exists(p) for p in paths.values()):
            break
    else:
        raise FileNotFoundError(
            f"no ogbn-products files under {root} (nothing is downloaded)")
    edge = np.loadtxt(paths["edge"], delimiter=",", dtype=np.int64).T
    feat = np.loadtxt(paths["feat"], delimiter=",", dtype=np.float32)
    labels = np.loadtxt(paths["label"], delimiter=",", dtype=np.int64)
    split = {k: np.loadtxt(paths[k], delimiter=",", dtype=np.int64)
             for k in ("train", "valid", "test")}
    return edge, feat, labels, split


def load_dataset(root, synthetic_nodes=200_000, force_synthetic=False):
    """``(topo, feat, labels, train, valid, test, n_classes)``: the real
    dataset from disk, else the synthetic fallback (the JAX example's
    arrays, bit for bit)."""
    try:
        if force_synthetic:
            raise ImportError("--force-synthetic")
        edge, feat, labels, split = _read_ogb(root)
        src, dst = edge
        # symmetrize like PyG's to_undirected
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        topo = CSRTopo(edge_index=np.stack([s, d]))
        return (topo, feat.astype(np.float32),
                labels.squeeze().astype(np.int32),
                split["train"], split["valid"], split["test"], 47)
    except Exception as e:
        print(f"[synthetic fallback: {e}]")
        rng = np.random.default_rng(0)
        n, n_cls = synthetic_nodes, 47
        comm = rng.integers(0, n_cls, n)
        deg = np.maximum(rng.lognormal(2.5, 1.0, n), 1).astype(np.int64)
        src = np.repeat(np.arange(n), deg)
        # 70% intra-community edges for learnability
        intra = rng.random(len(src)) < 0.7
        dst = np.where(
            intra,
            (src + rng.integers(1, 50, len(src)) * n_cls) % n,
            rng.integers(0, n, len(src)),
        )
        topo = CSRTopo(edge_index=np.stack([src, dst]))
        feat = np.eye(n_cls, dtype=np.float32)[comm]
        feat = np.concatenate(
            [feat, rng.normal(0, 0.5, (n, 100 - n_cls)).astype(np.float32)],
            axis=1,
        )
        idx = rng.permutation(n)
        return (topo, feat, comm.astype(np.int32),
                idx[: n // 2], idx[n // 2: n * 3 // 4], idx[n * 3 // 4:],
                n_cls)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="/data/products")
    ap.add_argument("--synthetic-nodes", type=int, default=200_000,
                    help="fallback graph size when OGB data is absent")
    ap.add_argument("--force-synthetic", action="store_true",
                    help="skip the OGB path outright (deterministic smoke)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--cache", default="200M",
                    help="device feature-cache budget (quiver.Feature)")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over all devices (the reference's "
                         "multi-GPU table: 11.1s -> 3.25s on 1 -> 4 GPUs)")
    add_device_flag(ap)
    return ap.parse_args(argv)


def stack_layers(layers_list):
    """Per-replica block tuples stacked on a leading replica axis, as the
    data-parallel step takes them."""
    return tuple(type(bs[0])(*[None if f[0] is None else torch.stack(f)
                               for f in zip(*bs)])
                 for bs in zip(*layers_list))


def _dp_epochs(args, dev, sampler, feature, model, opt, train_idx, labels,
               report):
    """The data-parallel loop: each round one batch a replica, stacked."""
    from ..parallel import make_train_step
    from ..utils.mesh import make_mesh

    # every visible card, as JAX's mesh takes every device (one CPU device
    # under --device cpu)
    mesh = make_mesh(("data",), devices=mesh_devices(dev, 0))
    ndev = int(mesh.shape["data"])
    dp_step = make_train_step(model, opt, mesh=mesh)
    print(f"data-parallel over {ndev} devices")
    B = args.batch_size
    rng = np.random.default_rng(1)
    clock = Clock(dev)
    losses, first = [], None
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_idx))
        clock.reset()
        n_rounds = len(train_idx) // (B * ndev)
        loss = None
        for r in range(n_rounds):
            parts = []
            for d in range(ndev):
                seeds = train_idx[order[(r * ndev + d) * B:
                                        (r * ndev + d + 1) * B]]
                if first is None:
                    first = seeds.copy()
                bt = sampler.sample(seeds,
                                    key_words=key_words(r * ndev + d, 3))
                parts.append((bt, feature[bt.n_id],
                              torch.from_numpy(labels[seeds]).to(dev)))
            xs = torch.stack([p[1] for p in parts])
            blocks = stack_layers([p[0].layers for p in parts])
            labs = torch.stack([p[2] for p in parts])
            masks = torch.ones((ndev, B), dtype=torch.bool, device=dev)
            loss = dp_step(xs, blocks, labs, masks)
            losses.append(loss)
        dt = clock.lap()
        print(f"epoch {epoch}: {dt:.2f}s "
              f"({n_rounds} rounds x {ndev} replicas x {B}), "
              f"loss {float(loss):.4f}")
    put(report, first_seeds=first, losses=losses_of(losses), replicas=ndev)
    return 0


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import Feature, GraphSageSampler
    from ..models import GraphSAGE, full_graph_inference
    from ..parallel import TrainState, make_train_step
    from ..pipeline import make_fused_train_step

    topo, feat, labels, train_idx, valid_idx, _, n_cls = load_dataset(
        args.root, synthetic_nodes=args.synthetic_nodes,
        force_synthetic=args.force_synthetic,
    )
    print(f"graph: {topo.node_count:,} nodes, {topo.edge_count:,} edges")

    # ---- the 3-line quiver swap ----------------------------------------
    sampler = GraphSageSampler(topo, sizes=[15, 10, 5], device=dev)
    feature = Feature(device_cache_size=args.cache, csr_topo=topo,
                      device=dev).from_cpu_tensor(feat)
    # --------------------------------------------------------------------

    with seeded(0, dev):
        model = GraphSAGE(feat.shape[1], hidden=256, out_dim=n_cls,
                          num_layers=3, device=dev)
    state = TrainState.create(model, lr=3e-3)
    B = args.batch_size

    if args.dp:
        return _dp_epochs(args, dev, sampler, feature, state.model,
                          state.optimizer, train_idx, labels, report)

    step = make_train_step(state.model, state.optimizer)

    # fully-cached features unlock the fused pipeline: sample + gather +
    # train with no host work in the steady-state loop
    fused = None
    if feature.cache_count >= feature.node_count:
        fused = make_fused_train_step(sampler, feature, state.model,
                                      state.optimizer)
        print("using fused on-device pipeline")

    rng = np.random.default_rng(1)
    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    labels_dev = torch.from_numpy(labels).to(dev)
    clock = Clock(dev)
    all_losses, epoch_s, val_acc, first = [], [], [], None
    for epoch in range(args.epochs):
        order = rng.permutation(len(train_idx))
        clock.reset()
        losses = []
        n_batches = len(train_idx) // B
        for i in range(n_batches):
            seeds = train_idx[order[i * B: (i + 1) * B]]
            if first is None:
                first = seeds.copy()
            seeds_dev = torch.from_numpy(seeds).to(dev)
            if fused is not None:
                loss = fused(seeds_dev, labels_dev[seeds_dev], ones,
                             key=prng_key(10_000 + i))
            else:
                batch = sampler.sample(seeds, key_words=key_words(
                    epoch * n_batches + i, 3))
                x = feature[batch.n_id]
                loss = step(x, batch.layers, labels_dev[seeds_dev], ones)
            losses.append(loss)
        dt = clock.lap()
        epoch_s.append(dt)
        all_losses.extend(losses)
        print(f"epoch {epoch}: {dt:.2f}s, loss "
              f"{float(torch.stack(losses).mean()):.4f}")

        # quick validation accuracy on a few batches
        correct = total = 0
        model.eval()
        with torch.no_grad():
            for i in range(min(10, len(valid_idx) // B)):
                seeds = valid_idx[i * B: (i + 1) * B]
                batch = sampler.sample(seeds)
                logits = model(feature[batch.n_id], batch.layers)
                pred = logits.argmax(-1).cpu().numpy()
                correct += (pred == labels[seeds]).sum()
                total += len(seeds)
        if total:
            val_acc.append(float(correct / total))
            print(f"  val acc (sampled): {correct / total:.4f}")

    # exact layer-wise inference for the final score (parity with the
    # reference's full-graph eval): feasible when the features fit the card
    full_acc = None
    if feature.cache_count >= feature.node_count:
        x_full = feature.hot
        if feature.feature_order is not None:
            # hot rows are cache-ordered; inference needs old-id order
            x_full = x_full[torch.from_numpy(feature.feature_order).to(dev)]
        clock.reset()
        logits = full_graph_inference(model, x=x_full, indptr=topo.indptr,
                                      indices=topo.indices, device=dev)
        pred = logits.argmax(-1).cpu().numpy()
        full_s = clock.lap()
        full_acc = float((pred[valid_idx] == labels[valid_idx]).mean())
        print(f"full-graph val acc: {full_acc:.4f}")
        put(report, full_graph_s=full_s)
    put(report, first_seeds=first, losses=losses_of(all_losses),
        epoch_s=epoch_s, val_acc=val_acc, full_graph_acc=full_acc,
        fused=fused is not None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
