"""Graph topology containers (counterpart of ``quiver_tpu/utils/topology.py``).

The canonical storage is a pair of host numpy arrays (``indptr`` int64,
``indices`` int32); :meth:`CSRTopo.to_device` places them on the card as
int32 tensors, zero-padded to a multiple of 128 exactly as the JAX package
pads them, so edge positions (``eid``) and clipped out-of-range reads agree
element for element.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = [
    "CSRTopo",
    "coo_to_csr",
    "parse_size",
    "reindex_feature",
    "reindex_by_config",
    "UNITS",
]


def coo_to_csr(
    src: np.ndarray, dst: np.ndarray, node_count: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO edge list -> CSR (indptr, indices, eid), rows are ``src``.

    A stable counting sort: each row keeps its neighbours in input order.
    ``eid`` is the permutation of input edge positions."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if node_count is None:
        node_count = int(max(src.max(), dst.max())) + 1 if src.size else 0
    counts = np.bincount(src, minlength=node_count).astype(np.int64)
    indptr = np.zeros(node_count + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    eid = np.argsort(src, kind="stable").astype(np.int64)
    indices = dst[eid].astype(np.int32)
    return indptr, indices, eid


def _pad128(a: np.ndarray) -> np.ndarray:
    """Zero-pad to a multiple of 128, never empty."""
    target = max(((len(a) + 127) // 128) * 128, 128)
    if target != len(a):
        a = np.concatenate([a, np.zeros(target - len(a), a.dtype)])
    return a


class CSRTopo:
    """Graph topology in CSR form, host-resident.

    ``CSRTopo(edge_index=...)`` (a ``[2, E]`` array of (src, dst)) or
    ``CSRTopo(indptr=..., indices=...)``.
    """

    def __init__(self, edge_index=None, indptr=None, indices=None, eid=None,
                 node_count: Optional[int] = None):
        if edge_index is not None:
            edge_index = np.asarray(edge_index)
            self.indptr_, self.indices_, self.eid_ = coo_to_csr(
                edge_index[0], edge_index[1], node_count
            )
            if eid is not None:
                self.eid_ = np.asarray(eid)[self.eid_]
        elif indptr is not None and indices is not None:
            self.indptr_ = np.asarray(indptr, dtype=np.int64)
            self.indices_ = np.asarray(indices, dtype=np.int32)
            self.eid_ = None if eid is None else np.asarray(eid)
        else:
            raise ValueError("need edge_index or (indptr, indices)")
        self.feature_order_: Optional[np.ndarray] = None
        self._device_arrays: dict = {}

    def __getstate__(self):
        # the device copies stay behind: an unpickled topology places its
        # own at its first to_device
        return dict(self.__dict__, _device_arrays={})

    @property
    def indptr(self) -> np.ndarray:
        return self.indptr_

    @property
    def indices(self) -> np.ndarray:
        return self.indices_

    @property
    def eid(self):
        return self.eid_

    @property
    def feature_order(self):
        return self.feature_order_

    @feature_order.setter
    def feature_order(self, feature_order):
        self.feature_order_ = (
            None if feature_order is None else np.asarray(feature_order)
        )

    @property
    def degree(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    @property
    def node_count(self) -> int:
        return int(self.indptr_.shape[0] - 1)

    @property
    def edge_count(self) -> int:
        return int(self.indices_.shape[0])

    def to_device(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(indptr, indices)`` as int32 tensors on ``device`` (``None``:
        the card), each zero-padded to a multiple of 128.  Cached per
        device.  Requires ``edge_count < 2**31``."""
        dev = resolve_device(device)
        cached = self._device_arrays.get(str(dev))
        if cached is None:
            if self.edge_count >= 2**31:
                raise ValueError(
                    "edge_count >= 2^31 does not fit int32 edge positions")
            indptr = torch.from_numpy(
                _pad128(self.indptr_.astype(np.int32))).to(dev)
            indices = torch.from_numpy(
                _pad128(self.indices_.astype(np.int32))).to(dev)
            cached = (indptr, indices)
            self._device_arrays[str(dev)] = cached
        return cached

    def __repr__(self):
        return f"CSRTopo(nodes={self.node_count}, edges={self.edge_count})"


def reindex_by_config(adj_csr: CSRTopo, graph_feature, gpu_portion: float,
                      seed: int = 0):
    """Degree-descending reorder with a shuffled hot prefix.

    Returns the permuted feature and ``new_order`` (old id -> new row),
    the same arrays as the JAX package for the same inputs."""
    node_count = adj_csr.node_count
    hot = int(node_count * gpu_portion)
    degree = adj_csr.degree
    prev_order = np.argsort(-degree, kind="stable")
    rng = np.random.default_rng(seed)
    prev_order[:hot] = prev_order[rng.permutation(hot)]
    new_order = np.empty(node_count, dtype=np.int64)
    new_order[prev_order] = np.arange(node_count, dtype=np.int64)
    graph_feature = np.asarray(graph_feature)[prev_order]
    return graph_feature, new_order


def reindex_feature(graph: CSRTopo, feature, ratio: float, seed: int = 0):
    if not isinstance(graph, CSRTopo):
        raise TypeError("graph should be a CSRTopo")
    return reindex_by_config(graph, feature, ratio, seed=seed)


UNITS = {
    "KB": 2**10, "MB": 2**20, "GB": 2**30,
    "K": 2**10, "M": 2**20, "G": 2**30,
}


def parse_size(sz) -> int:
    """'200M' / '1.5GB' / int / float -> bytes."""
    if isinstance(sz, int):
        return sz
    if isinstance(sz, float):
        return int(sz)
    if isinstance(sz, str):
        s = sz.upper().strip()
        for suf in sorted(UNITS, key=len, reverse=True):
            if s.endswith(suf):
                return int(float(s[: -len(suf)]) * UNITS[suf])
        if s.isdigit():
            return int(s)
    raise ValueError(f"invalid size: {sz!r}")
