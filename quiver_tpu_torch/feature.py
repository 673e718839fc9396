"""Cached feature store (counterpart of ``quiver_tpu/feature.py``).

A byte budget splits the table into a hot prefix on the device and a
cold tail on the host.  With ``csr_topo`` set, rows are first put in
degree-descending order with a shuffled hot slice (``reindex_feature``);
``feature_order`` maps old id -> row, the same array as the JAX package.
Then:

  * the hot prefix, the first ``cache_count`` rows, lives on the card and
    is gathered by kernel B2 (``ops/cuda/gather_rows.py``);
  * the cold tail lives in pinned host memory; a gather copies the cold
    rows of the batch into a pinned staging buffer, ships them, and
    copies them into their positions behind B2's hot rows (the staged
    merge);
  * the cold-row overlay (``enable_cold_cache``) keeps recurring cold rows
    in a device table, so they stop crossing the host link;
  * the paged store (``enable_paging``) packs the table into pages and
    serves the batch through kernel B5 (``ops/paged.py``), falling back to
    the overlay or the staged merge when a batch's pages exceed its pool.

Under ``cache_policy="ici_shard"`` with a ``mesh`` (the reference's
``p2p_clique_replicate``) the budget is per device and the hot prefix is
padded and row-sharded over the mesh's first axis (:class:`ShardedRows`):
each shard gathers the rows it owns with B2 and the elementwise max of
the shards' parts (a sentinel where a shard owns nothing) is the batch,
bitwise.  :meth:`Feature.from_mmap` reads the cold tier through a
``np.load(..., mmap_mode="r")`` map, so a table larger than host memory
still serves.

A budgeted gather reads its ids on the host (a device id tensor is read
back once) and ends with its device work launched under ``_plock``, so
its result is a tensor of its own: a later batch that evicts overlay
slots or pages, which the port updates in place where JAX made new
arrays, cannot change it.

:meth:`prefetch` runs a budgeted gather on a worker thread ahead of its
``feature[ids]`` call, which then claims the staged rows (the JAX
package's ``Feature.prefetch``); ``SeedLoader`` calls it one batch ahead.

Counters use the JAX package's telemetry names and land in the port's
metrics registry where JAX ticks them; ``stats()["counters"]`` keeps
this feature's own copy.  ``feature_h2d_bytes_total`` differs from JAX's:
the port ships only real rows and pages, where JAX pads each copy to a
shape bucket.
"""

from __future__ import annotations

import collections
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import telemetry
from .config import get_config
from .ops.coldcache import ColdRowCache
from .ops.cuda.gather_rows import gather_rows
from .ops.paged import PagedStore, PageTable, default_page_rows
from .telemetry.registry import metric_key
from .utils.device import resolve_device
from .utils.staging import HostStaging
from .utils.topology import CSRTopo, parse_size, reindex_feature

__all__ = ["Feature", "DeviceConfig", "ShardedRows"]


@dataclass
class DeviceConfig:
    """Pre-partitioned placement (the reference's ``feature.py:17-24``;
    ``quiver_tpu/feature.py:66-72``): per device, a ``.npy`` shard, and
    an optional host tail on disk.  :meth:`Feature.from_mmap` reads it:
    the shards, concatenated, are the hot prefix."""

    device_ids: List[int]
    device_paths: List[str]  # .npy per device shard
    host_path: Optional[str] = None  # cold tail on disk (mmap)


class ShardedRows:
    """The ``ici_shard`` hot prefix: ``[H, D]`` rows padded with zero rows
    to a multiple of the mesh's device count (as JAX pads) and split in
    contiguous blocks over the devices of the mesh's first axis.

    :meth:`gather` maps ids through the row order, has each shard gather
    the rows it owns with kernel B2 (a sentinel elsewhere: ``-inf``, or
    the dtype's minimum) and folds the parts with an elementwise max on
    the first shard's device: bitwise the replicated gather, but for a
    row value equal to the sentinel (JAX's documented hole)."""

    def __init__(self, rows: torch.Tensor, mesh):
        from .mesh.feature import sentinel_of

        self.devices = mesh.axis_devices(mesh.axis_names[0])
        self.device = self.devices[0]
        self.dtype = rows.dtype
        self.shape = tuple(rows.shape)
        n = rows.shape[0]
        pad = (-n) % mesh.size
        if pad:
            rows = torch.cat([rows, torch.zeros((pad, rows.shape[1]),
                                                dtype=rows.dtype)])
        self.rows_per_shard = rows.shape[0] // len(self.devices)
        rps = self.rows_per_shard
        self.shards = [rows[s * rps:(s + 1) * rps].contiguous().to(d)
                       for s, d in enumerate(self.devices)]
        self._sentinel = sentinel_of(self.dtype)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.shards])[:self.shape[0]]

    def gather(self, idx: torch.Tensor,
               order: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows ``[order][clamp(idx)]`` as :func:`gather_rows` returns them,
        on the first shard's device."""
        idx = idx.to(self.device, torch.int64)
        n = order.shape[0] if order is not None else self.shape[0]
        pos = idx.clamp(0, max(n - 1, 0))
        if order is not None:
            pos = order.index_select(0, pos).to(torch.int64)
        from .dist.comm import pmax

        def part(s, shard):
            local = (pos - s * self.rows_per_shard).to(shard.device,
                                                       non_blocking=True)
            own = (local >= 0) & (local < self.rows_per_shard)
            return torch.where(own[:, None], gather_rows(shard, local),
                               torch.full((), self._sentinel,
                                          dtype=self.dtype,
                                          device=shard.device))

        return pmax((part(s, shard) for s, shard in enumerate(self.shards)),
                    self.device)


def _host_view(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, without a copy (a read-only
    memory map included: nothing writes the cold tier)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _host_ids(node_idx) -> np.ndarray:
    if isinstance(node_idx, torch.Tensor):
        return node_idx.cpu().numpy()  # the one read-back
    return np.asarray(node_idx)


class Feature:
    """Hot/cold node-feature store.

    ``_plock`` guards the staging state a gather shares with other
    threads: the overlay table and its ``cold_cache`` metadata, the paged
    store, the staging buffers, the counters and the prefetched batches.

    Args:
      rank: local device index (kept for the reference's signature).
      device_list: devices in the cache (kept for the signature).
      device_cache_size: byte budget of the hot prefix (``parse_size``),
        or rows with ``cache_unit="rows"``.
      cache_policy: ``"device_replicate"`` or ``"ici_shard"`` (the hot
        prefix sharded over ``mesh``; alias ``"p2p_clique_replicate"``).
      csr_topo: optional :class:`CSRTopo` for degree-ordered rows.
      dtype: storage dtype (a ``torch.dtype``; default: the input's).
      cache_unit: ``"bytes"`` or ``"rows"``.
      device: where the hot prefix lives (``None``: the card).
      cold_cache_size: overlay budget in the units of
        ``device_cache_size``; ``None`` defers to ``config``, ``"auto"``
        leaves it off until :meth:`enable_cold_cache`, ``0`` disables.
      cold_cache_policy: overlay eviction, ``"clock"`` or ``"minfreq"``.
      mesh: the :class:`~quiver_tpu_torch.utils.mesh.Mesh` an
        ``ici_shard`` hot prefix is sharded over (without one it is
        replicated, as in JAX).
    """

    def __init__(self, rank: int = 0, device_list: Optional[Sequence] = None,
                 device_cache_size: Union[int, str] = 0,
                 cache_policy: str = "device_replicate",
                 csr_topo: Optional[CSRTopo] = None, dtype=None,
                 cache_unit: str = "bytes", device=None,
                 cold_cache_size: Union[int, str, None] = None,
                 cold_cache_policy: Optional[str] = None, mesh=None):
        if cache_unit not in ("bytes", "rows"):
            raise ValueError(f"cache_unit must be 'bytes' or 'rows', got "
                             f"{cache_unit!r}")
        if cache_policy == "p2p_clique_replicate":
            cache_policy = "ici_shard"
        if cache_policy not in ("device_replicate", "ici_shard"):
            raise ValueError(f"cache_policy must be 'device_replicate' or "
                             f"'ici_shard', got {cache_policy!r}")
        self.mesh = mesh
        self.device = (mesh.axis_devices(mesh.axis_names[0])[0]
                       if mesh is not None and device is None
                       else resolve_device(device))
        self.rank = rank
        self.device_list = device_list
        self.device_cache_size = device_cache_size
        self.cache_policy = cache_policy
        self.cache_unit = cache_unit
        self.csr_topo = csr_topo
        self.dtype = dtype
        self.cold_cache_size = cold_cache_size
        self.cold_cache_policy = cold_cache_policy
        self.feature_order: Optional[np.ndarray] = None  # old id -> row
        self.hot = None   # [cache_count, D] on the device, or ShardedRows
        self.cold: Optional[torch.Tensor] = None  # [N - cache_count, D], host
        self.cache_count = 0
        self.node_count = 0
        self.dim = 0
        self.cold_cache: Optional[ColdRowCache] = None
        self._overlay: Optional[torch.Tensor] = None  # [C, D], device
        self.paged: Optional[PagedStore] = None
        self._order_dev: Optional[torch.Tensor] = None
        self._plock = threading.Lock()
        self._staging = HostStaging(self.device)
        self._counts: dict = {}  # JAX metric key -> count
        # prefetch: one worker, staged rows by the ids' bytes, its futures
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: dict = {}
        self._inflight: collections.deque = collections.deque()
        self._lazy_state = None  # a handle lazy_from_ipc_handle left

    def _n_devices(self) -> int:
        if self.mesh is not None:
            return self.mesh.size
        if self.device_list is not None:
            return len(self.device_list)
        if self.device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def _budget_rows(self, row_bytes: int) -> int:
        budget = parse_size(self.device_cache_size)
        rows = (int(budget) if self.cache_unit == "rows"
                else int(budget // max(row_bytes, 1)))
        if self.cache_policy == "ici_shard":
            rows *= self._n_devices()  # each device holds 1/n of it
        return rows

    def from_cpu_tensor(self, tensor, prob=None) -> "Feature":
        """Split ``tensor [N, D]`` into the hot prefix on the device and
        the cold tail in host memory (pinned when the device is the
        card).  ``prob`` (per-node access probability) orders rows by it
        instead of by degree; ``csr_topo.feature_order`` is set as a side
        effect of degree order, as in the reference."""
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.cpu().numpy()
        tensor = np.asarray(tensor)
        node_count, dim = tensor.shape
        dt = self.dtype or torch.from_numpy(tensor[:0]).dtype
        row_bytes = torch.empty((), dtype=dt).element_size() * dim
        cache_count = min(self._budget_rows(row_bytes), node_count)

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

        table = torch.from_numpy(np.ascontiguousarray(tensor)).to(dt)
        self._install(table[:cache_count], table[cache_count:], new_order,
                      cache_count, node_count, dim)
        if topo_order:
            self.csr_topo.feature_order = new_order
        self._maybe_enable_cold_cache()
        self._maybe_enable_paging()
        return self

    def _install(self, hot, cold, order, cache_count, node_count, dim,
                 own_cold: bool = True):
        """Take the tiers (host tensors) and the row order: the hot prefix
        to the device (sharded over the mesh under ``ici_shard``), the
        cold tail pinned when the device is the card.  ``own_cold=False``
        keeps the cold tensor as given (a memory map stays on disk)."""
        if self.cache_policy == "ici_shard" and self.mesh is not None \
                and hot.shape[0]:
            hot = ShardedRows(hot.contiguous(), self.mesh)
        else:
            hot = hot.to(self.device).contiguous()
        if own_cold:
            cold = (cold.pin_memory() if self.device.type == "cuda"
                    else cold.clone())
        with self._plock:
            self.node_count, self.dim = node_count, dim
            self.cache_count = cache_count
            self.hot, self.cold = hot, cold
            self.feature_order = order
            self._order_dev = (
                None if order is None else
                torch.from_numpy(order.astype(np.int32)).to(self.device))
            self.cold_cache = self._overlay = self.paged = None
            self._pending.clear()

    @classmethod
    def from_mmap(cls, path_or_array, device_config: DeviceConfig = None,
                  **kwargs) -> "Feature":
        """Disk-backed features (the reference's ``feature.py:84-192``).

        ``path_or_array`` is a ``.npy`` path, opened with
        ``np.load(..., mmap_mode="r")``, or an array.  The cold tier reads
        through it in place, so a table larger than host memory serves.
        With a ``device_config``, its ``device_paths`` shards,
        concatenated, are the hot prefix and ``path_or_array`` is the
        cold tail; otherwise the budget splits the map (no reordering).
        ``kwargs`` go to the constructor."""
        import os

        self = cls(**kwargs)
        arr = (np.load(os.fspath(path_or_array), mmap_mode="r")
               if isinstance(path_or_array, (str, os.PathLike))
               else path_or_array)
        if device_config is not None and device_config.device_paths:
            hot = np.concatenate([np.asarray(np.load(p, mmap_mode="r"))
                                  for p in device_config.device_paths])
            cc = hot.shape[0]
            self._install(torch.from_numpy(hot), _host_view(arr), None, cc,
                          cc + arr.shape[0], arr.shape[1], own_cold=False)
        else:
            n, d = arr.shape
            cc = min(self._budget_rows(arr.dtype.itemsize * d), n)
            self._install(torch.from_numpy(np.array(arr[:cc])),
                          _host_view(arr[cc:]), None, cc, n, d,
                          own_cold=False)
        self._maybe_enable_cold_cache()
        self._maybe_enable_paging()
        return self

    def set_local_order(self, local_order):
        """An externally computed cache order (the reference's
        ``feature.py:283-294``): ``local_order[i]`` is the node stored at
        row ``i``."""
        local_order = np.asarray(local_order)
        new_order = np.empty(self.node_count, dtype=np.int64)
        new_order[local_order] = np.arange(self.node_count)
        order_dev = torch.from_numpy(new_order.astype(np.int32)).to(
            self.device)
        with self._plock:
            self.feature_order = new_order
            self._order_dev = order_dev

    def dim_(self) -> int:
        return self.dim

    # -- process hand-off (``quiver_tpu_torch.multiprocessing``) ----------
    def share_ipc(self):
        """The JAX package's handle, ``(config, hot, cold, feature_order,
        cache_count, node_count, dim)``, with host copies of both tiers;
        ``config`` names the device.  The overlay and the paged store are
        not carried."""
        self._check_built()
        cfg = dict(rank=self.rank, device_cache_size=self.device_cache_size,
                   cache_policy=self.cache_policy,
                   cache_unit=self.cache_unit, device=str(self.device))
        return (cfg, self.hot.cpu(), self.cold.clone(), self.feature_order,
                self.cache_count, self.node_count, self.dim)

    @classmethod
    def new_from_ipc_handle(cls, rank, ipc_handle) -> "Feature":
        """A feature built from ``ipc_handle`` at once, on the handle's
        device, with ``rank``."""
        cfg, hot, cold, order, cc, nc, dim = ipc_handle
        self = cls(**dict(cfg, rank=rank))
        self._install(hot, cold, order, cc, nc, dim)
        return self

    @classmethod
    def lazy_from_ipc_handle(cls, ipc_handle) -> "Feature":
        """A feature that installs ``ipc_handle`` on its device at first
        use (:meth:`lazy_init_from_ipc_handle`)."""
        cfg = ipc_handle[0]
        self = cls(**dict(cfg, rank=0))
        self._lazy_state = ipc_handle
        return self

    def lazy_init_from_ipc_handle(self):
        state, self._lazy_state = self._lazy_state, None
        if state is not None:
            self._install(*state[1:])

    # -- cold-row overlay ----------------------------------------------
    def _maybe_enable_cold_cache(self):
        """Turn the overlay on at build time when a size is configured;
        ``"auto"`` leaves it to :meth:`enable_cold_cache` or the serving
        lane."""
        size = self.cold_cache_size
        if size is None:
            size = get_config().cold_cache_size
        if size in (None, "auto", "off"):
            return
        budget = parse_size(size)
        if self.cache_unit == "rows":
            rows = int(budget)
        else:
            rows = int(budget) // max(self._row_bytes(), 1)
        if rows > 0:
            self.enable_cold_cache(rows=rows)

    def enable_cold_cache(self, rows: Optional[int] = None,
                          policy: Optional[str] = None,
                          admit_threshold: Optional[int] = None
                          ) -> "Feature":
        """Attach the device overlay over the cold tail: a cold row is
        admitted on its ``admit_threshold``-th miss and then served from
        the device.  No-op when the feature is fully hot.

        Args:
          rows: capacity in rows.  Default: a quarter of the hot prefix
            (at least 1024), capped at the cold tail.
          policy: ``"clock"`` or ``"minfreq"`` (default from config).
          admit_threshold: admit on the N-th miss (default from config).
        """
        self._check_built()
        n_cold = self.node_count - self.cache_count
        if n_cold <= 0:
            return self
        cfg = get_config()
        if rows is None:
            rows = max(1024, self.cache_count // 4)
        rows = int(min(rows, n_cold))
        if rows <= 0:
            return self
        policy = policy or self.cold_cache_policy or cfg.cold_cache_policy
        admit = (admit_threshold if admit_threshold is not None
                 else cfg.cold_cache_admit)
        cache = ColdRowCache(rows, n_cold, policy=policy,
                             admit_threshold=admit)
        overlay = torch.zeros((rows, self.dim), dtype=self.hot.dtype,
                              device=self.device)
        with self._plock:
            self.cold_cache, self._overlay = cache, overlay
        return self

    # -- paged store ---------------------------------------------------
    def _maybe_enable_paging(self):
        """Attach the paged store at build time when ``feature_paged`` is
        ``"on"`` and the table does not fit the budget."""
        cfg = get_config()
        if cfg.feature_paged != "on" or self.cache_count >= self.node_count:
            return
        self.enable_paging(page_rows=cfg.feature_page_rows or None,
                           pool_pages=cfg.feature_page_pool or None)

    def enable_paging(self, page_rows: Optional[int] = None,
                      pool_pages: Optional[int] = None,
                      policy: Optional[str] = None) -> "Feature":
        """Pack the table into device pages and serve every budgeted
        gather through kernel B5.  The staged merge (or the overlay) stays
        underneath for batches whose pages exceed the pool.  No-op when
        the feature is fully hot.

        Args:
          page_rows: rows per page (default: ``default_page_rows``).
          pool_pages: OVERLAY pool capacity in pages.  Default: a quarter
            of the host pages (at least 8), capped at the host pages.
          policy: page eviction, ``"clock"`` or ``"minfreq"``.
        """
        self._check_built()
        if self.cache_count >= self.node_count:
            return self
        if isinstance(self.hot, ShardedRows):
            raise ValueError("the paged store packs a replicated hot prefix "
                             "into its frames; an ici_shard hot prefix is "
                             "sharded (use device_replicate to page)")
        R = int(page_rows) if page_rows else default_page_rows(
            self._row_bytes())
        n_pages = -(-self.node_count // R)
        hot_pages = -(-self.cache_count // R) if self.cache_count else 0
        n_host_pages = n_pages - min(hot_pages, n_pages)
        if pool_pages is None:
            pool_pages = max(8, n_host_pages // 4)
        pool_pages = min(int(pool_pages), n_host_pages)
        policy = (policy or self.cold_cache_policy
                  or get_config().cold_cache_policy)
        table = PageTable(self.node_count, self.cache_count, R, pool_pages,
                          policy=policy)
        with self._plock:
            self.paged = PagedStore(table, self.cold, self.hot,
                                    self._count)
        return self

    def invalidate_rows(self, node_ids) -> int:
        """Drop changed rows (old node ids) from the overlay and their
        pages from the page pool; touch counts reset, so a row re-earns
        admission.  The hot prefix is a partition, not a cache, and is
        untouched.  Returns the overlay slots dropped."""
        if self.cold_cache is None and self.paged is None:
            return 0
        ids = np.atleast_1d(np.asarray(node_ids, dtype=np.int64))
        if self.feature_order is not None:
            ids = ids[(ids >= 0) & (ids < len(self.feature_order))]
            ids = self.feature_order[ids]
        cold_ids = ids - self.cache_count
        cold_ids = cold_ids[cold_ids >= 0]
        with self._plock:
            cache = self.cold_cache
            dropped = (cache.invalidate_rows(cold_ids)
                       if cache is not None else 0)
            if self.paged is not None:
                self.paged.invalidate_rows(cold_ids)
            if dropped:
                self._count("coldcache_invalidated_rows_total", dropped)
        return dropped

    # -- recovery ------------------------------------------------------
    def export_coldcache_state(self) -> Optional[dict]:
        """Device-cache residency for a recovery checkpoint (``None``
        when neither the overlay nor the paged store is attached).  Only
        metadata: the row values live in the host cold tier and are
        copied from it again on restore.  With paging on, the page
        table's residency (``kind="paged"``)."""
        with self._plock:
            if self.paged is not None:
                return self.paged.export_state()
            cache = self.cold_cache
            return cache.export_state() if cache is not None else None

    def restore_coldcache_state(self, state: Optional[dict]) -> int:
        """Re-warm the overlay (or the page pool) from a checkpointed
        state: adopt the slot metadata, then copy every resident row (or
        page) from the host cold tier to the device, so a restored row is
        the row a fresh gather returns.  The geometry must match
        (``ValueError`` otherwise: the caller starts cold); a paged state
        in a build without paging, or the reverse, starts cold.  Returns
        the rows re-warmed."""
        if state is None:
            return 0
        if state.get("kind") == "paged":
            if self.paged is None:
                return 0  # paging off now: a cold start
            with self._plock:
                return self.paged.restore_state(state)
        if self.paged is not None and self.cold_cache is None:
            return 0  # an overlay state, a paged-only build: start cold
        if self.cold_cache is None:
            self.enable_cold_cache(rows=int(state["capacity"]))
        if self.cold_cache is None:
            return 0  # fully hot: nothing to overlay
        with self._plock:
            cache = self.cold_cache
            cache.restore_state(state)
            slots = np.nonzero(cache.node_of >= 0)[0]
            if slots.size:
                rows = self.cold[torch.from_numpy(cache.node_of[slots])]
                self._overlay.index_copy_(
                    0, torch.from_numpy(slots).to(self.device),
                    rows.to(self.device))
        return int(slots.size)

    def stats(self) -> dict:
        """``counters`` under the JAX telemetry keys (rows by tier,
        overlay hits, misses and evictions, page faults, hits, evictions
        and fallbacks, bytes shipped, batches by tier), and the overlay's
        and paged store's own stats."""
        with self._plock:
            return dict(
                counters=dict(self._counts),
                cold_cache=(self.cold_cache.stats()
                            if self.cold_cache is not None else None),
                paged=self.paged.stats() if self.paged is not None else None)

    # -- gathers -------------------------------------------------------
    def _check_built(self):
        if self._lazy_state is not None:
            self.lazy_init_from_ipc_handle()
        if self.hot is None or self.node_count == 0:
            raise RuntimeError("Feature is empty: call from_cpu_tensor first")

    def _row_bytes(self) -> int:
        return self.hot.element_size() * self.dim

    def _count(self, name: str, n, **labels) -> None:
        """Add ``n`` to the counter ``name{labels}`` here (under its
        registry key) and in the registry.  Caller holds ``_plock``."""
        key = metric_key(name, labels)
        self._counts[key] = self._counts.get(key, 0) + n
        telemetry.counter(name, **labels).inc(float(n))

    def __getitem__(self, node_idx) -> torch.Tensor:
        """Rows by (old) node id, on the device.  With the whole table on
        the device, tensor ids stay there (:meth:`lookup_device`);
        otherwise ids are read on the host and the budgeted path runs."""
        self._check_built()
        full = self.cache_count >= self.node_count
        tier = "hot" if full else "cold" if self.cache_count == 0 else "mixed"
        with telemetry.span("feature.getitem"), telemetry.histogram(
                "feature_gather_seconds", tier=tier).time():
            rows = self._getitem(node_idx, full)
        with self._plock:
            self._count("feature_gather_batches_total", 1, tier=tier)
        return rows

    def _getitem(self, node_idx, full: bool) -> torch.Tensor:
        if full and isinstance(node_idx, torch.Tensor):
            return self.lookup_device(node_idx)
        idx = _host_ids(node_idx)
        if full:
            rows = self._gather_hot(torch.from_numpy(
                self._rows_of(idx).astype(np.int32)).to(self.device))
            return rows.reshape(*idx.shape, self.dim)
        rows = self._take_staged(idx.tobytes())
        if self._pool is not None:
            with self._plock:
                self._count("feature_prefetch_total", 1,
                            result="hit" if rows is not None else "miss")
        if rows is None:
            flat = self._rows_of(idx)
            with self._plock:
                rows = self._stage(flat)
        return rows.reshape(*idx.shape, self.dim)

    def _rows_of(self, idx: np.ndarray) -> np.ndarray:
        """Flat int64 table rows of (old) node ids, checked."""
        if idx.size and (idx.min() < 0 or idx.max() >= self.node_count):
            raise ValueError(f"node ids must lie in [0, {self.node_count})")
        flat = idx.reshape(-1)
        if self.feature_order is not None:
            flat = self.feature_order[flat]
        return flat.astype(np.int64)

    # -- prefetch ------------------------------------------------------
    def prefetch(self, node_idx) -> None:
        """Start the budgeted gather of ``node_idx`` (host ids, or device
        ids, read back on the worker) on a worker thread; the
        ``feature[node_idx]`` call with the same ids claims its rows.  The
        host gather and copy of the cold rows then run while the caller's
        previous step runs on the card.  Does nothing when the whole table
        is on the device.  Up to 8 unclaimed batches are kept, oldest
        dropped first."""
        self._check_built()
        if self.cache_count >= self.node_count:
            return
        with self._plock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="feature-prefetch")
            pool = self._pool

        def work():
            idx = _host_ids(node_idx)
            flat = self._rows_of(idx)
            with self._plock:
                self._pending[idx.tobytes()] = self._stage(flat)
                while len(self._pending) > 8:
                    self._pending.pop(next(iter(self._pending)))

        fut = pool.submit(work)
        with self._plock:
            self._inflight.append(fut)
            # drop only finished futures: _take_staged waits on the rest
            while len(self._inflight) > 8 and self._inflight[0].done():
                self._inflight.popleft()

    def _take_staged(self, key: bytes) -> Optional[torch.Tensor]:
        """Claim the prefetched rows of ids ``key``, waiting on prefetches
        in flight.  One worker finishes them in submission order, so
        waiting on the oldest either stages the key or proves it was never
        prefetched; an error of the prefetch is raised here."""
        if self._pool is None:
            return None
        while True:
            with self._plock:
                rows = self._pending.pop(key, None)
                if rows is not None or not self._inflight:
                    return rows
                fut = self._inflight.popleft()
            fut.result()

    def close(self) -> None:
        """Stop the prefetch worker (after its current batch) and drop
        unclaimed batches."""
        with self._plock:
            pool, self._pool = self._pool, None
            self._pending.clear()
            self._inflight.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def _to_device(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Ship a host array through staging buffer ``name``."""
        arr = torch.from_numpy(np.ascontiguousarray(arr))
        buf = self._staging.buffer(name, arr.shape, arr.dtype)
        buf.copy_(arr)
        return self._staging.send(name, buf)

    def _gather_hot(self, idx: torch.Tensor,
                    order: Optional[torch.Tensor] = None) -> torch.Tensor:
        """B2 over the hot prefix: one call, or one a shard under
        ``ici_shard``."""
        if isinstance(self.hot, ShardedRows):
            return self.hot.gather(idx, order)
        return gather_rows(self.hot, idx, order)

    def _hot_rows(self, rows: np.ndarray) -> torch.Tensor:
        return self._gather_hot(self._to_device("hot",
                                                rows.astype(np.int32)))

    def _upload_cold(self, rel: np.ndarray) -> torch.Tensor:
        """Copy cold-tail rows ``rel`` into the pinned staging buffer and
        start their copy to the device."""
        buf = self._staging.buffer("rows", (len(rel), self.dim),
                                   self.cold.dtype)
        torch.index_select(self.cold, 0, torch.from_numpy(rel), out=buf)
        self._count("feature_h2d_bytes_total",
                    buf.numel() * buf.element_size())
        return self._staging.send("rows", buf)

    def _stage(self, idx: np.ndarray) -> torch.Tensor:
        """Rows of feature-order rows ``idx`` for a budgeted feature, with
        every device step launched.  Caller holds ``_plock``."""
        if self.paged is not None and len(idx):
            st = self.paged.stage(idx)
            if st is not None:
                return self.paged.finish(st)
            # the batch's pages exceed the pool: the paths below serve it
        if self.cold_cache is not None:
            return self._stage_overlay(idx)
        cc = self.cache_count
        if cc == 0:
            self._count("feature_rows_total", len(idx), tier="cold")
            return self._upload_cold(idx)
        hot_mask = idx < cc
        cold_pos = np.nonzero(~hot_mask)[0]
        self._count("feature_rows_total", len(idx) - len(cold_pos),
                    tier="hot")
        out = self._hot_rows(np.where(hot_mask, idx, 0))
        if len(cold_pos):
            self._count("feature_rows_total", len(cold_pos), tier="cold")
            rows = self._upload_cold(idx[cold_pos] - cc)
            out.index_copy_(0, self._to_device("cold_pos", cold_pos), rows)
        return out

    def _stage_overlay(self, idx: np.ndarray) -> torch.Tensor:
        """Three tiers: the hot prefix through B2, overlay hits from the
        device table, fresh rows from the host; then the fresh rows that
        earned admission are written into the overlay.  The hits are read
        before that write, so a slot this batch evicts still serves the
        row its probe found.  Caller holds ``_plock``."""
        B, cc = len(idx), self.cache_count
        hot_mask = idx < cc
        cold_pos = np.nonzero(~hot_mask)[0]
        if cc > 0:
            self._count("feature_rows_total", B - len(cold_pos), tier="hot")
        if len(cold_pos) == 0:
            return self._hot_rows(np.where(hot_mask, idx, 0))
        self._count("feature_rows_total", len(cold_pos), tier="cold")
        rel = idx[cold_pos] - cc
        cache = self.cold_cache
        hit, slots = cache.probe(rel)
        n_hit = int(hit.sum())
        out = (self._hot_rows(np.where(hot_mask, idx, 0)) if cc > 0 else
               torch.zeros((B, self.dim), dtype=self.hot.dtype,
                           device=self.device))
        if n_hit:
            rows = gather_rows(self._overlay, self._to_device(
                "ov_slot", slots[hit].astype(np.int32)))
            out.index_copy_(0, self._to_device("ov_pos", cold_pos[hit]),
                            rows)
        n_evicted = 0
        if n_hit < len(rel):
            fresh = rel[~hit]
            rows = self._upload_cold(fresh)
            out.index_copy_(0, self._to_device("cold_pos", cold_pos[~hit]),
                            rows)
            adm, n_evicted = cache.admit(fresh)
            if (adm >= 0).any():
                # duplicates of one row share its slot: write it once
                slot, src = np.unique(adm, return_index=True)
                src, slot = src[slot >= 0], slot[slot >= 0]
                self._overlay.index_copy_(
                    0, self._to_device("adm_slot", slot.astype(np.int64)),
                    rows.index_select(0, self._to_device("adm_src", src)))
        self._count("feature_coldcache_rows_total", n_hit, result="hit")
        self._count("feature_coldcache_rows_total", len(rel) - n_hit,
                    result="miss")
        if n_evicted:
            self._count("feature_coldcache_evictions_total", n_evicted)
        return out

    def lookup_device(self, idx: torch.Tensor) -> torch.Tensor:
        """Gather with ids already on the device, for features whose whole
        table is on the device (the fused serving lane).  Ids are clipped
        to ``[0, N)`` before ``feature_order`` is applied, as the JAX
        package clips them; without an order the clip keeps B2 inside the
        table (the ids are never read back to the host to be checked).
        Clip, order and copy are one call of B2."""
        self._check_built()
        if self.cache_count < self.node_count:
            raise RuntimeError(
                f"lookup_device needs the whole table on the device; "
                f"{self.cache_count} of {self.node_count} rows are: use "
                "feature[ids]")
        idx = idx.to(self.device)
        if idx.dtype not in (torch.int32, torch.int64):
            idx = idx.to(torch.int64)
        return self._gather_hot(idx, self._order_dev)

    def size(self, dim: int) -> int:
        return (self.node_count, self.dim)[dim]

    @property
    def shape(self):
        return (self.node_count, self.dim)

    def __repr__(self):
        return (f"Feature(nodes={self.node_count}, dim={self.dim}, "
                f"hot={self.cache_count}, policy={self.cache_policy!r}, "
                f"overlay={self.cold_cache is not None}, "
                f"paged={self.paged is not None}, device={self.device})")
