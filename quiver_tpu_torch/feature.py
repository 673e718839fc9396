"""Cached feature store (counterpart of ``quiver_tpu/feature.py``).

This slice ports the ``device_replicate`` policy with the whole table on
the card.  With ``csr_topo`` set, rows are first put in degree-descending
order with a shuffled hot slice (``reindex_feature``), and
``feature_order`` maps old id -> row, the same array as the JAX package.
Every gather goes through kernel B2 (``ops/cuda/gather_rows.py``) on the
card.  A byte budget smaller than the table would need the host cold tail,
which is not ported yet (ROADMAP A4), so it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .ops.cuda.gather_rows import gather_rows
from .utils.device import resolve_device
from .utils.topology import CSRTopo, parse_size, reindex_feature

__all__ = ["Feature"]


class Feature:
    """Node-feature store on the card.

    Args:
      rank: local device index (kept for the reference's signature).
      device_list: devices in the cache (kept for the signature).
      device_cache_size: byte budget (``parse_size``), or rows with
        ``cache_unit="rows"``; it must hold the whole table.
      cache_policy: ``"device_replicate"``.
      csr_topo: optional :class:`CSRTopo` for degree-ordered rows.
      dtype: storage dtype (a ``torch.dtype``; default: the input's).
      device: where the table lives (``None``: the card).
    """

    def __init__(self, rank: int = 0, device_list: Optional[Sequence] = None,
                 device_cache_size: Union[int, str] = 0,
                 cache_policy: str = "device_replicate",
                 csr_topo: Optional[CSRTopo] = None, dtype=None,
                 cache_unit: str = "bytes", device=None):
        if cache_unit not in ("bytes", "rows"):
            raise ValueError(f"cache_unit must be 'bytes' or 'rows', got "
                             f"{cache_unit!r}")
        if cache_policy != "device_replicate":
            raise NotImplementedError(
                f"cache_policy={cache_policy!r} is not ported yet "
                "(ROADMAP A13); use 'device_replicate'")
        self.device = resolve_device(device)
        self.rank = rank
        self.device_list = device_list
        self.device_cache_size = device_cache_size
        self.cache_policy = cache_policy
        self.cache_unit = cache_unit
        self.csr_topo = csr_topo
        self.dtype = dtype
        self.feature_order: Optional[np.ndarray] = None  # old id -> row
        self.hot: Optional[torch.Tensor] = None          # [N, D] on device
        self.cache_count = 0
        self.node_count = 0
        self.dim = 0
        self._order_dev: Optional[torch.Tensor] = None

    def _budget_rows(self, row_bytes: int) -> int:
        budget = parse_size(self.device_cache_size)
        if self.cache_unit == "rows":
            return int(budget)
        return int(budget // max(row_bytes, 1))

    def from_cpu_tensor(self, tensor, prob=None) -> "Feature":
        """Place ``tensor`` ``[N, D]`` on the device.  ``prob`` (per-node
        access probability) orders rows by it instead of by degree."""
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.cpu().numpy()
        tensor = np.asarray(tensor)
        node_count, dim = tensor.shape
        dt = self.dtype or torch.from_numpy(tensor[:0]).dtype
        row_bytes = torch.empty((), dtype=dt).element_size() * dim
        cache_count = min(self._budget_rows(row_bytes), node_count)
        if cache_count < node_count:
            raise NotImplementedError(
                f"device_cache_size holds {cache_count} of {node_count} "
                "rows: the host cold tail is not ported yet (ROADMAP A4); "
                "give a budget that holds the whole table")

        new_order = None
        topo_order = False
        if prob is not None and cache_count > 0:
            order = np.argsort(-np.asarray(prob), kind="stable")
            new_order = np.empty(node_count, dtype=np.int64)
            new_order[order] = np.arange(node_count)
            tensor = tensor[order]
        elif self.csr_topo is not None and cache_count > 0:
            ratio = cache_count / node_count
            tensor, new_order = reindex_feature(self.csr_topo, tensor, ratio)
            topo_order = True

        hot = torch.from_numpy(np.ascontiguousarray(tensor)).to(dt)
        self.hot = hot.to(self.device).contiguous()
        self.node_count, self.dim = node_count, dim
        self.cache_count = cache_count
        self.feature_order = new_order
        self._order_dev = (
            None if new_order is None else
            torch.from_numpy(new_order.astype(np.int32)).to(self.device))
        if topo_order:
            self.csr_topo.feature_order = new_order
        return self

    def _check_built(self):
        if self.hot is None or self.node_count == 0:
            raise RuntimeError("Feature is empty: call from_cpu_tensor first")

    def __getitem__(self, node_idx) -> torch.Tensor:
        """Rows by (old) node id, on the device.  Tensor ids stay on the
        device (:meth:`lookup_device`); host ids are mapped through
        ``feature_order`` on the host first."""
        self._check_built()
        if isinstance(node_idx, torch.Tensor):
            return self.lookup_device(node_idx)
        idx = np.asarray(node_idx)
        if idx.size and (idx.min() < 0 or idx.max() >= self.node_count):
            raise ValueError(f"node ids must lie in [0, {self.node_count})")
        if self.feature_order is not None:
            idx = self.feature_order[idx]
        flat = torch.from_numpy(idx.astype(np.int32).reshape(-1))
        rows = gather_rows(self.hot, flat.to(self.device))
        return rows.reshape(*idx.shape, self.dim)

    def lookup_device(self, idx: torch.Tensor) -> torch.Tensor:
        """Gather with ids already on the device.  Ids are clipped to
        ``[0, N)`` before ``feature_order`` is applied, as the JAX package
        clips them; without an order the clip keeps B2 inside the table
        (the ids are never read back to the host to be checked)."""
        self._check_built()
        pos = idx.to(self.device, torch.int64).clamp(0, self.node_count - 1)
        if self._order_dev is not None:
            return gather_rows(self.hot, self._order_dev[pos])
        return gather_rows(self.hot, pos.to(torch.int32))

    def size(self, dim: int) -> int:
        return (self.node_count, self.dim)[dim]

    @property
    def shape(self):
        return (self.node_count, self.dim)

    def __repr__(self):
        return (f"Feature(nodes={self.node_count}, dim={self.dim}, "
                f"hot={self.cache_count}, policy={self.cache_policy!r}, "
                f"device={self.device})")
