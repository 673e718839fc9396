"""Row-range-sharded feature store: one logical table over a mesh
(counterpart of ``quiver_tpu/mesh/feature.py``).

Each of ``n_shards`` devices holds ``1/n_shards`` of the table and a batch
gather is a sharded gather with a halo exchange:

  * rows split into contiguous ranges of ``rows_per_shard`` (ownership is
    ``id // rows_per_shard``);
  * each shard owns a :class:`~quiver_tpu_torch.ops.paged.PagedStore`
    over its range only, so a page fault touches one shard's frame pool
    (one host-to-device copy, CLOCK eviction, the ``feature_page_*``
    metrics), as the single-device paged store faults;
  * each shard gathers the rows it owns from its pool with kernel B2
    (``ops/cuda/gather_rows.py``: the pool viewed as ``[F * R, D]``,
    index ``frame * R + lid % R``) and puts a dtype-minimum sentinel in
    every other row; the elementwise max over the shards (``pmax``) is
    the halo exchange, and the owner's row wins unchanged, so the result
    is bitwise the table's rows.  The one hole, as in JAX, is a feature
    value equal to the sentinel itself (``-inf``).

A batch whose pages exceed a shard's pool is answered from the host table
for the whole batch, exactly, and ``feature_page_fallback_total`` ticks:
the JAX package's contract, kept as semantics.

The JAX package caches one gather executable per padded batch size; the
port builds nothing, so :meth:`warm_executables` and each gather record
those keys (``("gather", B_pad, n_shards)``) in the ``mesh_feature``
program cache, as the program registry counts the port's builds.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..dist.comm import pmax
from ..ops.cuda.gather_rows import gather_rows
from ..ops.paged import PageTable, PagedStore, default_page_rows
from ..recovery.registry import program_cache
from ..utils.mesh import host_tensor
from ..utils.staging import upload
from .topology import SHARD_AXIS, build_mesh, shard_ranges

__all__ = ["MeshFeature", "pow2_bucket", "sentinel_of"]


def pow2_bucket(n: int) -> int:
    """The JAX package's executable bucket of a row count (0 stays 0)."""
    return 0 if n == 0 else max(16, 1 << int(n - 1).bit_length())


def sentinel_of(dtype: torch.dtype) -> float:
    """The value that loses every max: ``-inf`` for floats (bf16 has its
    own), the dtype's minimum for integers."""
    if dtype.is_floating_point:
        return float("-inf")
    return int(torch.iinfo(dtype).min)


def _tick(name: str, n, **labels) -> None:
    # quiverlint: ignore[QT006] -- the shard stores' `count` hook: every
    # caller in ops/paged.py passes a literal snake_case `*_total` name
    telemetry.counter(name, **labels).inc(float(n))


class MeshFeature:
    """One logical feature table served by ``n_shards`` devices.

    Args:
      table: ``[N, D]`` host table (numpy, or a torch tensor for bf16).
      n_shards: shard count (default ``config.mesh_shards``).
      mesh: a mesh with a ``"shard"`` axis of ``n_shards`` devices
        (default: ``build_mesh(n_shards)`` over the first cards).
      page_rows: rows per page (default ``default_page_rows``).
      pool_pages: each shard's frame pool in pages (default
        ``config.mesh_pool_pages``; 0 holds the whole range).
    """

    def __init__(self, table, n_shards: Optional[int] = None, mesh=None,
                 page_rows: int = 0, pool_pages: Optional[int] = None):
        from ..config import get_config

        cfg = get_config()
        if n_shards is None:
            n_shards = cfg.mesh_shards
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(
                f"MeshFeature needs n_shards >= 1 (config.mesh_shards "
                f"is off); got {self.n_shards}")
        host = host_tensor(table)
        self.node_count, self.dim = host.shape
        self.dtype = host.dtype
        self.cache_count = 0      # no replicated hot prefix: rows shard
        self.mesh = mesh if mesh is not None else build_mesh(self.n_shards)
        self.axis = SHARD_AXIS
        self.devices: List[torch.device] = self.mesh.axis_devices(self.axis)
        if len(self.devices) != self.n_shards:
            raise ValueError(f"mesh has {len(self.devices)} devices on "
                             f"{self.axis!r}, not {self.n_shards}")
        self.device = self.devices[0]
        self.rows_per_shard, self.ranges = shard_ranges(
            self.node_count, self.n_shards)
        row_bytes = self.dim * host.element_size()
        self.page_rows = int(page_rows) or default_page_rows(row_bytes)
        self._pages_per_shard = -(-self.rows_per_shard // self.page_rows)
        if pool_pages is None:
            pool_pages = int(cfg.mesh_pool_pages)
        self.pool_pages = int(pool_pages) or self._pages_per_shard
        self._table = host
        self._stores: List[PagedStore] = []
        for (lo, hi), dev in zip(self.ranges, self.devices):
            rows = torch.zeros((self.rows_per_shard, self.dim),
                               dtype=self.dtype)
            rows[: hi - lo] = host[lo:hi]
            pt = PageTable(n_rows=self.rows_per_shard, cache_count=0,
                           page_rows=self.page_rows,
                           pool_pages=self.pool_pages)
            empty = torch.empty((0, self.dim), dtype=self.dtype, device=dev)
            self._stores.append(PagedStore(pt, rows, empty, _tick))
        self.pool_pages = self._stores[0].table.pool_pages  # post-clamp
        self._sentinel = sentinel_of(self.dtype)
        self._cache = program_cache("mesh_feature", owner=self)
        self._lock = threading.Lock()
        self._lookup: Optional[List[np.ndarray]] = None
        self._dirty = True
        self.restacks = 0
        self.fallbacks = 0
        from . import _set_active_feature

        _set_active_feature(self)

    # -- faulting (host-side planning) -----------------------------------
    def _fault_shards(self, ids: np.ndarray,
                      owner: np.ndarray) -> Optional[bool]:
        """Fault every shard's touched pages (one host-to-device copy a
        shard).  ``None`` when some shard's pool cannot hold this batch's
        working set (the caller falls back), else whether a page faulted.
        Caller holds ``_lock``."""
        dirtied = False
        for s, store in enumerate(self._stores):
            local = ids[owner == s] - s * self.rows_per_shard
            if local.size == 0:
                continue
            pages = np.unique(local // self.page_rows)
            if (store.frame_of_pages()[pages] >= 0).all():
                continue
            if store._fault_pages(pages) is None:
                store.fallbacks += 1
                return None
            dirtied = True
        return dirtied

    def _shard_rows(self, s: int, ids: np.ndarray,
                    lookup: np.ndarray) -> torch.Tensor:
        """Shard ``s``'s part of the batch: its own rows through B2, the
        sentinel elsewhere."""
        store, rps, R = self._stores[s], self.rows_per_shard, self.page_rows
        n_frames = store.table.n_frames
        local = ids - s * rps
        own = (local >= 0) & (local < rps)
        lid = np.clip(local, 0, rps - 1)
        frame = lookup[lid // R]
        ok = own & (frame >= 0)
        flat = np.where(ok, np.clip(frame, 0, n_frames - 1) * R + lid % R,
                        -1).astype(np.int32)
        dev = self.devices[s]
        idx = upload(flat, dev)
        rows = gather_rows(store.frames.view(-1, self.dim), idx)
        return torch.where((idx >= 0)[:, None], rows,
                           torch.full((), self._sentinel, dtype=self.dtype,
                                      device=dev))

    # -- the batch gather ----------------------------------------------
    def __getitem__(self, node_idx) -> torch.Tensor:
        if isinstance(node_idx, torch.Tensor):
            # quiverlint: ignore[QT001] -- the sharded lookup plans on the
            # host: its one read-back of the ids
            node_idx = node_idx.cpu().numpy()
        ids = np.asarray(node_idx, dtype=np.int64).reshape(-1)
        B = len(ids)
        if B == 0:
            return torch.zeros((0, self.dim), dtype=self.dtype,
                               device=self.device)
        with telemetry.histogram("mesh_shard_gather_seconds").time():
            owner = ids // self.rows_per_shard
            with self._lock:
                faulted = self._fault_shards(ids, owner)
                if faulted is None:
                    # a shard's pool overflowed: the exact host gather,
                    # answered for the whole batch
                    self.fallbacks += 1
                    telemetry.counter("feature_page_fallback_total").inc()
                    return self._table[torch.from_numpy(ids)].to(
                        self.device)
                if faulted:
                    self._dirty = True
                if self._dirty:
                    self._lookup = [st.frame_of_pages()
                                    for st in self._stores]
                    self._dirty = False
                    self.restacks += 1
                lookup = self._lookup
                key = ("gather", pow2_bucket(B), self.n_shards)
                if key not in self._cache:
                    self._cache[key] = True
                # the gathers are launched under the lock: a later fault
                # is ordered after them on the stream
                out = pmax((self._shard_rows(s, ids, lookup[s])
                            for s in range(self.n_shards)), self.device)
        # logical halo volume of the combine: every owned row crosses to
        # the other (n-1) shards
        halo = float(B * self.dim * self._table.element_size()
                     * (self.n_shards - 1))
        telemetry.counter("mesh_halo_bytes_total", direction="send").inc(
            halo)
        telemetry.counter("mesh_halo_bytes_total", direction="recv").inc(
            halo)
        return out

    # -- warmup / introspection ----------------------------------------
    def warm_executables(self, buckets: Optional[Sequence[int]] = None
                         ) -> int:
        """Record the gather's keys for a pow2 ladder of batch sizes (the
        serving warmup calls this); returns how many were new."""
        if buckets is None:
            top = pow2_bucket(min(self.node_count, 1 << 13))
            buckets, b = [], 1
            while b <= top:
                buckets.append(b)
                b <<= 1
        before = len(self._cache)
        for b in buckets:
            key = ("gather", int(b), self.n_shards)
            if key not in self._cache:
                self._cache[key] = True
        return len(self._cache) - before

    def stats(self) -> dict:
        with self._lock:
            per_shard = [dict(range=list(r),
                              resident_pages=s.table.resident_pages(),
                              fallbacks=s.fallbacks)
                         for r, s in zip(self.ranges, self._stores)]
            return dict(
                n_shards=self.n_shards, rows_per_shard=self.rows_per_shard,
                page_rows=self.page_rows, pool_pages=self.pool_pages,
                pages_per_shard=self._pages_per_shard,
                executables=len(self._cache),
                restacks=self.restacks, fallbacks=self.fallbacks,
                shards=per_shard)

    def size(self, dim: int) -> int:
        return (self.node_count, self.dim)[dim]

    def __repr__(self):
        return (f"MeshFeature(nodes={self.node_count}, dim={self.dim}, "
                f"shards={self.n_shards}, page_rows={self.page_rows}, "
                f"pool_pages={self.pool_pages})")
