"""Synthetic graphs (counterpart of ``quiver_tpu/utils/synthetic.py``).

Numpy only: the same seed gives the same arrays as the JAX package.
Lognormal degrees approximate the power-law-ish degree profile of
ogbn-products and Reddit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .topology import CSRTopo

__all__ = ["synthetic_csr", "synthetic_products", "synthetic_reddit",
           "community_graph"]


def synthetic_csr(n_nodes: int, n_edges: int, seed: int = 0,
                  sigma: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-skewed (lognormal) random CSR; returns (indptr, indices)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=3.0, sigma=sigma, size=n_nodes)
    deg = np.maximum(raw / raw.sum() * n_edges, 1).astype(np.int64)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    e = int(indptr[-1])
    indices = rng.integers(0, n_nodes, size=e, dtype=np.int32)
    return indptr, indices


def synthetic_products(seed: int = 0) -> CSRTopo:
    """ogbn-products scale: 2,449,029 nodes, ~123.7M edges."""
    indptr, indices = synthetic_csr(2_449_029, 123_718_280, seed)
    return CSRTopo(indptr=indptr, indices=indices)


def synthetic_reddit(seed: int = 0) -> CSRTopo:
    """Reddit's node count with a tenth of its edges (~11.6M), as the JAX
    package has it."""
    indptr, indices = synthetic_csr(232_965, 11_606_919, seed)
    return CSRTopo(indptr=indptr, indices=indices)


def community_graph(n_nodes: int, n_classes: int, intra_deg: int = 6,
                    inter_deg: int = 2, noise: float = 0.3,
                    feat_extra: int = 0, seed: int = 0):
    """A learnable stochastic-block-like graph: each node has
    ``intra_deg`` edges into its own class and ``inter_deg`` to random
    nodes; features are the class one-hot plus noise.

    Returns ``(CSRTopo, features [N, n_classes + feat_extra], labels [N])``,
    for checks that a loss falls.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_classes, n_nodes)
    order = np.argsort(comm, kind="stable")
    # each class is a contiguous slice of ``order``
    bounds = np.searchsorted(comm[order], np.arange(n_classes + 1))
    k = intra_deg + inter_deg
    src = np.repeat(np.arange(n_nodes), k)
    dst = np.empty(n_nodes * k, dtype=np.int64)
    lo = bounds[comm]
    hi = np.maximum(bounds[comm + 1], lo + 1)
    u = rng.random((n_nodes, intra_deg))
    intra = order[(lo[:, None] + u * (hi - lo)[:, None]).astype(np.int64)]
    inter = rng.integers(0, n_nodes, (n_nodes, inter_deg))
    dst.reshape(n_nodes, k)[:, :intra_deg] = intra
    dst.reshape(n_nodes, k)[:, intra_deg:] = inter
    topo = CSRTopo(edge_index=np.stack([src, dst]), node_count=n_nodes)
    feat = np.eye(n_classes, dtype=np.float32)[comm]
    feat += rng.normal(0, noise, feat.shape).astype(np.float32)
    if feat_extra:
        feat = np.concatenate(
            [feat, rng.normal(0, noise, (n_nodes, feat_extra))
             .astype(np.float32)], axis=1)
    return topo, feat, comm.astype(np.int32)
