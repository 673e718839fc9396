"""Paged feature store: page table, residency states, fault planner
(counterpart of ``quiver_tpu/ops/paged.py``).

Feature rows are packed into fixed-size pages of ``page_rows`` rows, and
the three storage tiers become page residency states over one device
frame pool ``frames [F, R, D]``:

  * ``DEVICE``: pages of the degree-ordered hot prefix, pinned at frames
    ``[0, hot_pages)``;
  * ``OVERLAY``: host pages faulted into the pool (frames
    ``[hot_pages, hot_pages + pool)``), CLOCK-evicted;
  * ``HOST``: pages only in the host tail; a gather that touches one
    faults the whole page in.

Kernel B5 (``ops/cuda/page_gather.py``) then gathers any frontier by
walking the planner's ``(frame, offset)`` pairs.

The planner keeps the JAX package's geometry (``_plan_geometry``) and
builds the same plan arrays bit for bit, vectorized instead of one
``np.unique`` per block.  Kernel B5 reads rows straight from device
memory and stages no pages, so it needs no geometry of its own; the plan
is kept so that the two packages can be held to each other.

Externally synchronized: the owning ``Feature`` holds ``_plock`` across
:meth:`PagedStore.stage` and :meth:`PagedStore.finish`.  ``frames`` is
updated in place by faults, so a plan is finished (its gather launched on
the stream) before the lock is released; a later fault is ordered after
that gather on the stream and cannot change what it reads.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..utils.staging import HostStaging
from .coldcache import ColdRowCache
from .cuda.page_gather import page_gather

__all__ = ["PagedStore", "PageTable", "default_page_rows",
           "DEVICE", "OVERLAY", "HOST"]

DEVICE, OVERLAY, HOST = 0, 1, 2

_TXN_BYTES = 512           # the JAX package's page-size unit
_TARGET_PAGE_BYTES = 4096  # auto-sizing floor: 8 such units per page
_VMEM_BUDGET = 2 << 20     # the TPU kernel's page-window budget


def default_page_rows(row_bytes: int,
                      target_bytes: int = _TARGET_PAGE_BYTES) -> int:
    """Smallest row count whose page is a multiple of 512 bytes and at
    least ``target_bytes``; a plain ``target_bytes`` fill when no
    multiple exists within 4096 rows."""
    row_bytes = max(int(row_bytes), 1)
    fill = max(1, -(-target_bytes // row_bytes))
    for r in range(fill, fill + 4096):
        if (r * row_bytes) % _TXN_BYTES == 0:
            return r
    return fill


def _plan_geometry(page_rows: int, dim: int, itemsize: int
                   ) -> Tuple[int, int]:
    """(block, ppb): output rows per plan block and the most distinct
    pages one block may list, as the JAX package sizes them."""
    page_bytes = max(page_rows * dim * itemsize, 1)
    block = max(8, min(128, _VMEM_BUDGET // page_bytes))
    block = max(8, (block // 8) * 8)
    return block, block


class PageTable:
    """Residency bookkeeping over the pages of one feature table.

    Page ``p`` covers rows ``[p*R, (p+1)*R)``.  The hot prefix is rounded
    up to whole pages; the boundary page's rows past ``cache_count`` are
    filled from the host tail, so they are real data.  Host pages are
    tracked by a :class:`ColdRowCache` whose rows are pages.
    """

    def __init__(self, n_rows: int, cache_count: int, page_rows: int,
                 pool_pages: int, policy: str = "clock"):
        if page_rows <= 0:
            raise ValueError(f"page_rows must be > 0, got {page_rows}")
        self.page_rows = int(page_rows)
        self.n_rows = int(n_rows)
        self.n_pages = -(-self.n_rows // self.page_rows)
        self.hot_pages = (-(-int(cache_count) // self.page_rows)
                          if cache_count > 0 else 0)
        self.hot_pages = min(self.hot_pages, self.n_pages)
        self.n_host_pages = self.n_pages - self.hot_pages
        self.pool_pages = max(int(min(pool_pages, self.n_host_pages)), 0)
        self.cache = (ColdRowCache(self.pool_pages, self.n_host_pages,
                                   policy=policy, admit_threshold=1)
                      if self.pool_pages > 0 and self.n_host_pages > 0
                      else None)

    def state_of(self, page: int) -> int:
        if page < self.hot_pages:
            return DEVICE
        if (self.cache is not None
                and self.cache.slot_of[page - self.hot_pages] >= 0):
            return OVERLAY
        return HOST

    @property
    def n_frames(self) -> int:
        return self.hot_pages + self.pool_pages

    def resident_pages(self) -> int:
        return self.hot_pages + (self.cache.resident
                                 if self.cache is not None else 0)


def plan_blocks(frame: np.ndarray, off: np.ndarray, block: int, ppb: int):
    """The block plan of kernel B5 for per-row ``frame`` and ``off``:
    ``(blk_pages, blk_np, row_lp, row_off, rank)``.

    Rows are sorted by frame (stably) and cut into blocks of ``block``;
    each block lists its distinct frames in order (``blk_pages``, at most
    ``ppb``, count in ``blk_np``), each sorted row its index into that
    list (``row_lp``) and its offset (``row_off``), both padded with 0 to
    whole blocks.  ``rank[i]`` is row ``i``'s sorted position.  Equal,
    array for array, to the JAX planner's loop: a distinct frame starts
    where the sorted frame changes or a block starts, and a running count
    of those starts, restarted at each block, is ``row_lp``.
    """
    B = len(frame)
    # a stable sort's order is fixed by the keys; numpy sorts 16-bit keys
    # by radix, several times faster than int32 keys at this size
    small = B == 0 or int(frame.max()) < 2**16
    order = np.argsort(frame.astype(np.uint16) if small else frame,
                       kind="stable")
    sf = frame[order]
    nb = -(-B // block)
    pos = np.arange(B)
    new = np.ones(B, dtype=bool)
    new[1:] = sf[1:] != sf[:-1]
    new[pos % block == 0] = True
    count = np.cumsum(new)
    lp = count - count[pos - pos % block]
    row_lp = np.zeros(nb * block, dtype=np.int32)
    row_lp[:B] = lp
    row_off = np.zeros(nb * block, dtype=np.int32)
    row_off[:B] = off[order]
    blk = pos[new] // block
    blk_pages = np.zeros(nb * ppb, dtype=np.int32)
    blk_pages[blk * ppb + lp[new]] = sf[new]
    blk_np = np.bincount(blk, minlength=nb).astype(np.int32)
    rank = np.empty(B, dtype=np.int32)
    rank[order] = np.arange(B, dtype=np.int32)
    return blk_pages, blk_np, row_lp, row_off, rank


class PagedStore:
    """Device frame pool and fault planner behind ``Feature``'s paged path.

    Built by ``Feature.enable_paging``.  Owns the ``[F, R, D]`` frames
    (DEVICE pages written once here, the OVERLAY pool faulted on demand)
    and the pinned staging buffers of page faults and plans.

    Args:
      table: the :class:`PageTable`.
      host_rows: the host tail, a CPU tensor ``[N - cache_count, D]``.
      hot: the hot prefix, a ``[cache_count, D]`` tensor on the device.
      count: ``count(key, n)`` adds to the owning feature's counters
        (JAX metric keys).
    """

    def __init__(self, table: PageTable, host_rows: torch.Tensor,
                 hot: torch.Tensor, count: Callable[[str, int], None]):
        self.table = table
        self.device = hot.device
        self.dim = int(host_rows.shape[1])
        self.dtype = host_rows.dtype
        self._host = host_rows
        self._cc = int(hot.shape[0])
        self._count = count
        self._staging = HostStaging(self.device)
        R = table.page_rows
        self.page_bytes = R * self.dim * host_rows.element_size()
        self.block, self.ppb = _plan_geometry(R, self.dim,
                                              host_rows.element_size())
        self.frames = torch.zeros((table.n_frames, R, self.dim),
                                  dtype=self.dtype, device=self.device)
        flat = self.frames.view(-1, self.dim)
        hot_rows = min(table.hot_pages * R, table.n_rows)
        n_dev = min(self._cc, hot_rows)
        flat[:n_dev] = hot[:n_dev]
        if hot_rows > n_dev:  # the boundary page's tail: host rows
            flat[n_dev:hot_rows] = host_rows[:hot_rows - n_dev].to(
                self.device)
        self.fallbacks = 0

    def _fault_pages(self, host_pages: np.ndarray) -> Optional[int]:
        """Fault the given distinct HOST pages into the pool as one
        host-to-device copy.  Returns the pages faulted, or ``None`` when
        the pool cannot hold the batch's working set (the caller falls
        back to the staged path)."""
        cache = self.table.cache
        if cache is None:
            return None
        hit, _ = cache.probe(host_pages)
        fault = host_pages[~hit]
        if fault.size == 0:
            self._count("feature_page_hits_total", int(host_pages.size))
            return 0
        # the batch's hit pages are read by this very gather: keep them
        protect = cache.slot_of[host_pages[hit]]
        if fault.size + hit.sum() > cache.capacity:
            return None
        slots, n_evicted = cache.admit(fault, protect_slots=protect)
        if (slots < 0).any():
            return None
        R, k = self.table.page_rows, int(fault.size)
        base0 = self.table.hot_pages * R - self._cc  # host row of page 0
        rows = (base0 + fault[:, None] * R + np.arange(R)).reshape(-1)
        short = rows >= self._host.shape[0]  # the short tail page
        buf = self._staging.buffer("pages", (k * R, self.dim), self.dtype)
        torch.index_select(self._host, 0,
                           torch.from_numpy(np.where(short, 0, rows)),
                           out=buf)
        if short.any():
            buf[torch.from_numpy(short)] = 0
        pages = self._staging.send("pages", buf)
        frame_ids = torch.from_numpy(
            (self.table.hot_pages + slots).astype(np.int64)).to(self.device)
        self.frames.index_copy_(0, frame_ids, pages.view(k, R, self.dim))
        self._count("feature_page_faults_total", k)
        self._count("feature_page_hits_total", int(hit.sum()))
        # only real pages cross the link: no padding to a shape bucket
        self._count("feature_h2d_bytes_total", int(buf.numel())
                    * buf.element_size())
        if n_evicted:
            self._count("feature_page_evictions_total", n_evicted)
        telemetry.gauge("feature_page_resident_bytes").set(
            float(self.table.resident_pages() * self.page_bytes))
        return k

    def stage(self, idx: np.ndarray):
        """Fault the HOST pages of ``idx`` (feature-order rows) and plan
        the gather: ``("pg", blk_pages, blk_np, row_lp, row_off, rank,
        B)`` as host arrays, or ``None`` when the batch's pages exceed the
        pool (the caller stages instead)."""
        t, R = self.table, self.table.page_rows
        idx = idx.astype(np.int64)
        B = len(idx)
        page = idx // R
        is_host = page >= t.hot_pages
        n_host = int(is_host.sum())
        if n_host:
            host_pages = np.unique(page[is_host] - t.hot_pages)
            if self._fault_pages(host_pages) is None:
                self.fallbacks += 1
                self._count("feature_page_fallback_total", 1)
                return None
            slot = t.cache.slot_of[page[is_host] - t.hot_pages]
            if (slot < 0).any():
                raise RuntimeError("a fault left a HOST page unmapped")
        frame = page.astype(np.int32)
        if n_host:
            frame[is_host] = (t.hot_pages + slot).astype(np.int32)
        off = (idx % R).astype(np.int32)
        self._count("feature_rows_total{tier=hot}", B - n_host)
        self._count("feature_rows_total{tier=cold}", n_host)
        return ("pg",) + plan_blocks(frame, off, self.block, self.ppb) + (B,)

    def finish(self, staged) -> torch.Tensor:
        """Launch kernel B5 over a plan from :meth:`stage`; the rows come
        back in the order of the staged ids."""
        _, blk_pages, _, row_lp, row_off, rank, B = staged
        parts = (blk_pages, row_lp, row_off, rank)
        buf = self._staging.buffer("plan", (sum(map(len, parts)),),
                                   torch.int32)
        o = 0
        for p in parts:
            buf[o:o + len(p)] = torch.from_numpy(p)
            o += len(p)
        dev = self._staging.send("plan", buf)
        views, o = [], 0
        for p in parts:
            views.append(dev[o:o + len(p)])
            o += len(p)
        return page_gather(self.frames, *views, block=self.block,
                           ppb=self.ppb)

    def frame_of_pages(self) -> np.ndarray:
        """Logical page -> resident frame (``-1``: HOST)."""
        t = self.table
        out = np.full(t.n_pages, -1, dtype=np.int32)
        out[:t.hot_pages] = np.arange(t.hot_pages, dtype=np.int32)
        if t.cache is not None:
            slot = t.cache.slot_of
            resident = slot >= 0
            out[t.hot_pages:][resident] = (
                t.hot_pages + slot[resident]).astype(np.int32)
        return out

    def invalidate_rows(self, rel_ids: np.ndarray) -> int:
        """Drop the OVERLAY pages holding the given host-tail rows; DEVICE
        pages are a partition, not a cache.  Returns pages dropped."""
        t = self.table
        if t.cache is None or rel_ids.size == 0:
            return 0
        pages = np.unique((rel_ids + self._cc) // t.page_rows) - t.hot_pages
        dropped = t.cache.invalidate_rows(pages[pages >= 0])
        if dropped:
            telemetry.gauge("feature_page_resident_bytes").set(
                float(t.resident_pages() * self.page_bytes))
        return dropped

    def stats(self) -> dict:
        t = self.table
        return dict(
            page_rows=t.page_rows, page_bytes=self.page_bytes,
            n_pages=t.n_pages, hot_pages=t.hot_pages,
            pool_pages=t.pool_pages, resident_pages=t.resident_pages(),
            fallbacks=self.fallbacks, block=self.block, ppb=self.ppb,
            cache=(t.cache.stats() if t.cache is not None else None),
        )

    def __repr__(self):
        t = self.table
        return (f"PagedStore(pages={t.n_pages}, hot={t.hot_pages}, "
                f"pool={t.pool_pages}, page_rows={t.page_rows}, "
                f"page_bytes={self.page_bytes})")
