"""End-to-end data-parallel training over the sharded stack (counterpart
of ``quiver_tpu/dist/e2e.py``): a row-sharded
:class:`~quiver_tpu_torch.dist.DistGraphSampler`, the all-to-all
:class:`~quiver_tpu_torch.dist.DistFeature` (or the two-tier
:class:`~quiver_tpu_torch.dist.hier.HierFeature`), and the data-parallel
``make_train_step(mesh=)``: the shape of the reference's multi-node
papers100M benchmark, sized by arguments."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["run_dist_training"]


def run_dist_training(n_devices: int, n_nodes: int = 256,
                      avg_deg: int = 8, feat_dim: int = 16,
                      batch_per_dev: int = 16,
                      sizes: Sequence[int] = (4, 3),
                      steps: int = 1, classes: int = 8,
                      lr: float = 3e-3, seed: int = 0,
                      learnable_labels: bool = True,
                      hier: Optional[tuple] = None, devices=None):
    """Run ``steps`` data-parallel steps over an ``n_devices`` mesh.

    ``devices`` are the mesh's devices (default: the first ``n_devices``
    cards; ``[torch.device("cpu")] * n`` on the CPU).  Returns the
    per-step ``losses``, the sampler's summed overflow counts and the
    feature store's (``hier=(n_hosts, hot_frac)`` swaps in the two-tier
    store over an ``[n_hosts, n_devices / n_hosts]`` mesh and adds the
    summed ``dcn_crossings``).  Labels are a linear function of the
    features by default, so the loss can fall."""
    from ..models import GraphSAGE
    from ..parallel import TrainState, make_train_step
    from ..utils.mesh import Mesh, make_mesh, visible_cards
    from ..utils.topology import CSRTopo
    from .feature import DistFeature, PartitionInfo
    from .hier import HierFeature
    from .sampler import DistGraphSampler

    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n_nodes).astype(np.int64)
    src = np.repeat(np.arange(n_nodes), deg)
    dst = rng.integers(0, n_nodes, size=len(src))
    topo = CSRTopo(edge_index=np.stack([src, dst]))
    feat = rng.normal(size=(n_nodes, feat_dim)).astype(np.float32)
    if learnable_labels:
        w_true = rng.normal(size=(feat_dim, classes))
        labels = np.argmax(feat @ w_true, axis=1).astype(np.int64)
    else:
        labels = rng.integers(0, classes, n_nodes).astype(np.int64)

    devs = list(devices) if devices is not None \
        else visible_cards()[:n_devices]
    mesh = make_mesh(("data",), devices=devs[:n_devices])
    home = mesh.axis_devices("data")[0]
    hier_feat = dist_feat = None
    if hier is not None:
        n_hosts, hot_frac = hier
        C = n_devices // n_hosts
        hmesh = Mesh(np.asarray(devs[:n_devices], dtype=object).reshape(
            n_hosts, C), ("dcn", "ici"))
        # degree order, so the hot tier holds the busy rows; the sampler
        # keeps global ids, remapped at lookup
        order = np.argsort(-topo.degree, kind="stable")
        old2new = np.empty(n_nodes, dtype=np.int64)
        old2new[order] = np.arange(n_nodes)
        g2h_hier = (np.arange(n_nodes) % n_hosts).astype(np.int32)
        hier_feat = HierFeature.from_global_feature(
            feat[order], hmesh, hot_count=int(n_nodes * hot_frac),
            global2host=g2h_hier)
    else:
        g2h = rng.integers(0, n_devices, topo.node_count).astype(np.int32)
        info = PartitionInfo(host=0, hosts=n_devices, global2host=g2h)
        dist_feat = DistFeature.from_global_feature(feat, mesh, info)
    sampler = DistGraphSampler(topo, mesh, sizes=list(sizes))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = GraphSAGE(feat_dim, 32, classes, num_layers=len(sizes),
                          dropout=0.0, device=home)
    state = TrainState.create(model, lr=lr)
    step_fn = make_train_step(state.model, state.optimizer, mesh=mesh)

    losses = []
    sampler_overflow = np.zeros(len(sizes), dtype=np.int64)
    feat_overflow = 0
    dcn_crossings = 0
    masks = torch.ones((n_devices, batch_per_dev), dtype=torch.bool)
    for it in range(steps):
        seeds = rng.integers(0, n_nodes, (n_devices, batch_per_dev))
        n_id, n_mask, num, blocks = sampler.sample(seeds, key=seed + it)
        sampler_overflow += sampler.overflow_stats().sum(axis=0)
        if hier_feat is not None:
            ids = torch.from_numpy(old2new)[n_id.cpu().to(torch.int64)]
            H, C = hier_feat.H, hier_feat.C
            xs = hier_feat.lookup(ids.reshape(H, C, -1)).reshape(
                n_devices, -1, feat_dim)
            st = hier_feat.traffic_stats()
            dcn_crossings += int(st["dcn_crossings"].sum())
            feat_overflow += int(st["drops"].sum())
        else:
            xs = dist_feat.lookup(n_id)
            feat_overflow += int(dist_feat.overflow_stats().sum())
        loss = step_fn(xs, blocks, torch.from_numpy(labels[seeds]), masks)
        losses.append(float(loss))
    return dict(losses=losses, sampler_overflow=sampler_overflow,
                feature_overflow=feat_overflow, mesh=mesh,
                node_count=n_nodes, dcn_crossings=dcn_crossings)
