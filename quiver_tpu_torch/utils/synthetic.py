"""Synthetic graphs (counterpart of ``quiver_tpu/utils/synthetic.py``).

Numpy only: the same seed gives the same arrays as the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["synthetic_csr"]


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
