"""Partitioned feature store with an all-to-all lookup (counterpart of
``quiver_tpu/dist/feature.py``; the reference's ``PartitionInfo``,
``DistFeature`` and NCCL ``exchange``).

The partitioned table lives as one ``[max_local, D]`` shard a rank, each
on its rank's device.  A lookup takes one query batch a rank
(``ids [n_ranks, B]``) and answers every rank in one call, as the JAX
package's ``shard_map`` body does:

  1. each rank slots its queries into fixed-capacity buckets by owner
     (``dist/buckets.py``; a query past its bucket's ``cap`` overflows,
     gets a zero row, and is counted in ``last_overflow``);
  2. ``all_to_all`` ships the request ids to their owners;
  3. each owner gathers the requested rows of its shard with kernel B2;
  4. a second ``all_to_all`` ships the rows back, and B2 gathers each
     query's row out of the returned buckets.

:meth:`DistFeature.enable_cold_cache` keeps this rank's recurring remote
rows in a device overlay in front of the exchange, and a peer timeout
(``PeerTimeout``/``TimeoutError`` out of the exchange) degrades to the
rows each rank can answer alone (:meth:`DistFeature._degraded_lookup`),
as in JAX.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..ops.cuda.gather_rows import gather_rows
from ..resilience import chaos
from ..resilience.deadline import check_ambient
from ..resilience.errors import PeerTimeout
from ..utils.mesh import host_tensor
from .buckets import bucket, pack_ids
from .comm import all_to_all

__all__ = ["PartitionInfo", "DistFeature"]

# fault-injection site of the exchange (no-op unless a chaos plan is on)
_CHAOS_EXCHANGE = chaos.point("dist.feature.exchange")


class PartitionInfo:
    """Node -> (owner, local slot) maps (the reference's
    ``feature.py:461-526``).

    Args:
      device: this rank (kept for parity).
      host: this rank's host index.
      hosts: number of hosts (partitions).
      global2host: ``[N]`` owner host a node.
      replicate: optional ids of nodes replicated on every host.
    """

    def __init__(self, device=0, host: int = 0, hosts: int = 1,
                 global2host=None, replicate=None):
        self.device = device
        self.host = host
        self.hosts = hosts
        self.global2host = np.asarray(global2host, dtype=np.int32)
        n = self.global2host.shape[0]
        self.replicate_mask = np.zeros(n, dtype=bool)
        if replicate is not None:
            self.replicate_mask[np.asarray(replicate)] = True
        # local slot of each node on its owner; replicated nodes get a
        # slot on EVERY host, after the owned block
        owner = self.global2host.copy()
        self.global2local = np.zeros(n, dtype=np.int32)
        owned_counts = np.zeros(hosts, dtype=np.int64)
        order = np.argsort(owner, kind="stable")
        for h in range(hosts):
            ids = order[owner[order] == h]
            ids = ids[~self.replicate_mask[ids]]
            self.global2local[ids] = np.arange(len(ids), dtype=np.int32)
            owned_counts[h] = len(ids)
        self.owned_counts = owned_counts
        self.rep_ids = np.nonzero(self.replicate_mask)[0]
        self.max_local = int(owned_counts.max() + len(self.rep_ids))

    @classmethod
    def from_partition_book(cls, book, device=0, host: int = 0,
                            hosts: Optional[int] = None, replicate=None):
        """From a ``feature_partition_book`` (node -> partition), as
        ``quiver_partition_feature`` writes it."""
        book = np.asarray(book)
        return cls(device=device, host=host,
                   hosts=hosts if hosts is not None else int(book.max()) + 1,
                   global2host=book, replicate=replicate)

    def dispatch(self, ids: np.ndarray):
        """Bucket ``ids`` by owner host (``feature.py:510-526``): a list of
        id arrays and a list of position arrays, one a host."""
        ids = np.asarray(ids)
        owner = np.where(self.replicate_mask[ids], self.host,
                         self.global2host[ids])
        out_ids, out_pos = [], []
        for h in range(self.hosts):
            m = owner == h
            out_ids.append(ids[m])
            out_pos.append(np.nonzero(m)[0])
        return out_ids, out_pos


class DistFeature:
    """Sharded feature with an all-to-all remote lookup.

    Build with :meth:`from_global_feature` (the whole table is laid out
    into shards), then ``lookup(ids [n_hosts, B])``, or ``feature[ids]``
    with 1-D ids (this host's batch, broadcast to every host).

    ``_ov_lock`` guards the overlay state (the cold-row cache and its
    device table)."""

    _guarded_by = {"_overlay": "_ov_lock"}

    def __init__(self, mesh, info: PartitionInfo, axis: str = "data",
                 request_cap: Optional[int] = None):
        self.mesh = mesh
        self.info = info
        self.axis = axis
        self.n = int(mesh.shape[axis])
        if self.n != info.hosts:
            raise ValueError(f"mesh axis {axis!r} has {self.n} devices for "
                             f"{info.hosts} hosts")
        self.devices: List[torch.device] = mesh.axis_devices(axis)
        self.request_cap = request_cap
        self.shards: Optional[List[torch.Tensor]] = None
        self._maps: Optional[List[dict]] = None
        self._host_source = None  # host table (overlay admission)
        self.cold_cache = None    # ColdRowCache over the global-id space
        self._overlay = None      # [C, D] on this host's device
        self._ov_lock = threading.Lock()
        self.last_overflow = None
        self._overflow_recorded = True
        self.last_degraded = False
        self.last_degraded_mask = None

    @classmethod
    def from_global_feature(cls, feature, mesh, info: PartitionInfo,
                            axis: str = "data",
                            request_cap: Optional[int] = None):
        self = cls(mesh, info, axis, request_cap)
        src = host_tensor(feature)
        n, d = src.shape
        m = info.max_local
        g2l = info.global2local
        rep_rank = np.zeros(n, dtype=np.int64)
        rep_rank[info.rep_ids] = np.arange(len(info.rep_ids))
        self.shards, self._maps = [], []
        for h, dev in enumerate(self.devices):
            shard = torch.zeros((m, d), dtype=src.dtype)
            owned = np.nonzero((info.global2host == h)
                               & ~info.replicate_mask)[0]
            shard[torch.from_numpy(g2l[owned].astype(np.int64))] = \
                src[torch.from_numpy(owned)]
            base = int(info.owned_counts[h])
            if len(info.rep_ids):
                shard[base: base + len(info.rep_ids)] = \
                    src[torch.from_numpy(info.rep_ids)]
            self.shards.append(shard.to(dev))
            # each rank's local slot of every node it may be asked for:
            # a replicated node's slot follows this host's owned block
            lslot = np.where(info.replicate_mask, base + rep_rank, g2l)
            self._maps.append(dict(
                g2h=torch.from_numpy(info.global2host.astype(np.int64)).to(
                    dev),
                rep=torch.from_numpy(info.replicate_mask).to(dev),
                lslot=torch.from_numpy(lslot.astype(np.int64)).to(dev)))
        self._host_source = src
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    # -- the exchange --------------------------------------------------
    def _exchange(self, ids: List[torch.Tensor], valid: List[torch.Tensor],
                  cap: int):
        n, N = self.n, self._host_source.shape[0]
        dests, oks, reqs, ocounts = [], [], [], []
        for r in range(n):
            mp = self._maps[r]
            q = ids[r].clamp(0, N - 1)
            owner = torch.where(mp["rep"][q], torch.full_like(q, r),
                                mp["g2h"][q])
            dest, overflow = bucket(owner, valid[r], n, cap)
            dests.append(dest)
            oks.append(valid[r] & ~overflow)
            ocounts.append((valid[r] & overflow).sum().to(torch.int32))
            reqs.append(pack_ids(ids[r], dest, n * cap).view(n, cap))
        # phase 1: request ids to their owners
        recv = all_to_all(reqs)
        feats = []
        for r in range(n):
            rids = recv[r].reshape(-1).to(torch.int64) - 1
            rvalid = rids >= 0
            lslot = self._maps[r]["lslot"][torch.clamp_min(rids, 0)]
            rows = gather_rows(self.shards[r], lslot)
            rows = torch.where(rvalid[:, None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))
            feats.append(rows.view(n, cap, -1))
        # phase 2: rows back to the requesters
        back = all_to_all(feats)
        outs = []
        for r in range(n):
            flat = back[r].reshape(n * cap, -1)
            got = gather_rows(flat, torch.clamp(dests[r], 0, n * cap - 1))
            outs.append(torch.where(oks[r][:, None], got,
                                    torch.zeros((), dtype=got.dtype,
                                                device=got.device)))
        dev0 = self.devices[0]
        out = torch.stack([o.to(dev0, non_blocking=True) for o in outs])
        overflow = torch.stack([c.to(dev0) for c in ocounts])
        return out, overflow

    # -- per-host cold-row overlay -------------------------------------
    def enable_cold_cache(self, rows: Optional[int] = None,
                          policy: Optional[str] = None,
                          admit_threshold: Optional[int] = None
                          ) -> "DistFeature":
        """Attach a device overlay over this host's remote rows: recurring
        remote (non-replicated, other-owner) rows are admitted into a
        local ``[rows, D]`` table; a hit leaves the all-to-all (its valid
        bit clears) and its row is patched in after the exchange."""
        if self._host_source is None:
            raise RuntimeError("enable_cold_cache needs from_global_feature "
                               "(the host source feeds admission)")
        from ..config import get_config
        from ..ops.coldcache import ColdRowCache

        cfg = get_config()
        n, d = self._host_source.shape
        if rows is None:
            rows = max(1024, self.info.max_local // 4)
        rows = int(min(rows, n))
        policy = policy or cfg.cold_cache_policy
        admit = (admit_threshold if admit_threshold is not None
                 else cfg.cold_cache_admit)
        with self._ov_lock:
            self.cold_cache = ColdRowCache(rows, n, policy=policy,
                                           admit_threshold=admit)
            self._overlay = torch.zeros(
                (rows, d), dtype=self._host_source.dtype,
                device=self.devices[self.info.host])
        return self

    def invalidate_rows(self, global_ids) -> int:
        """Drop mutated rows (global ids) from this host's overlay; their
        admission evidence resets.  Returns the overlay slots dropped."""
        from .. import telemetry

        if self.cold_cache is None:
            return 0
        ids = np.atleast_1d(np.asarray(global_ids, dtype=np.int64))
        with self._ov_lock:
            cache = self.cold_cache
            dropped = (cache.invalidate_rows(ids)
                       if cache is not None else 0)
        if dropped:
            telemetry.counter("coldcache_invalidated_rows_total").inc(
                dropped)
        return dropped

    def _overlay_probe(self, ids: np.ndarray, valid: np.ndarray):
        """The overlay step for this host's query row: probe its remote
        ids, clear the valid bit of hits, read the hits' rows, admit
        recurring misses from the host source.  Returns ``(positions,
        rows)`` of the hits, or ``None``.  The hits are read before the
        admissions write the table, under ``_ov_lock``, so a slot this
        batch evicts still serves the row its probe found."""
        from .. import telemetry
        from ..telemetry import flightrec

        me = self.info.host
        row = ids[me]
        cand = (valid[me] & ~self.info.replicate_mask[row]
                & (self.info.global2host[row] != me))
        pos_all = np.nonzero(cand)[0]
        if not len(pos_all):
            return None
        gids = row[pos_all].astype(np.int64)
        n_evicted = 0
        dev = self.devices[me]
        hit_rows = None
        with self._ov_lock:
            cache = self.cold_cache
            hit_mask, slots = cache.probe(gids)
            n_hit = int(hit_mask.sum())
            if n_hit:
                hit_rows = gather_rows(self._overlay, torch.from_numpy(
                    slots[hit_mask].astype(np.int32)).to(dev))
            miss_ids = gids[~hit_mask]
            if len(miss_ids):
                adm, n_evicted = cache.admit(miss_ids)
                if (adm >= 0).any():
                    # duplicates of one row share its slot: write it once
                    slot, src = np.unique(adm, return_index=True)
                    src, slot = src[slot >= 0], slot[slot >= 0]
                    self._overlay.index_copy_(
                        0, torch.from_numpy(slot.astype(np.int64)).to(dev),
                        self._host_source[torch.from_numpy(
                            miss_ids[src])].to(dev))
            row_bytes = (self._host_source.shape[1]
                         * self._host_source.element_size())
            resident_bytes = cache.resident_bytes(row_bytes)
        telemetry.gauge("dist_feature_overlay_resident_bytes").set(
            float(resident_bytes))
        telemetry.counter("dist_feature_coldcache_rows_total",
                          result="hit").inc(float(n_hit))
        telemetry.counter("dist_feature_coldcache_rows_total",
                          result="miss").inc(float(len(gids) - n_hit))
        if n_evicted:
            telemetry.counter(
                "dist_feature_coldcache_evictions_total").inc(
                float(n_evicted))
        if flightrec.tracing():
            flightrec.event("dist.exchange", {
                "probe_hit": int(n_hit),
                "probe_miss": int(len(gids) - n_hit),
                "evicted": int(n_evicted)})
        if n_hit == 0:
            return None
        hit_pos = pos_all[hit_mask]
        valid[me, hit_pos] = False  # hits skip the all-to-all
        return hit_pos, hit_rows

    def lookup(self, ids, valid=None) -> torch.Tensor:
        """``ids``: ``[n_hosts, B]`` (one batch a host).  Returns ``[n_hosts,
        B, D]`` on the first host's device.

        After each call ``last_overflow`` holds the ``[n_hosts]`` count
        of queries that overflowed their destination bucket and got zero
        rows: always 0 when ``request_cap`` is None (cap = B, the exact
        worst case)."""
        check_ambient("dist_feature")
        patch = None
        if self.cold_cache is not None and not isinstance(ids, torch.Tensor):
            # the overlay probe needs host ids; device ids bypass it
            ids = np.asarray(ids, dtype=np.int64)
            valid = (np.ones(ids.shape, dtype=bool) if valid is None
                     else np.array(valid, dtype=bool))  # copy: bits clear
            patch = self._overlay_probe(ids, valid)
        ids_t = torch.as_tensor(ids).to(torch.int64)
        nh, B = ids_t.shape
        valid_t = (torch.ones((nh, B), dtype=torch.bool) if valid is None
                   else torch.as_tensor(valid).to(torch.bool))
        cap = self.request_cap or B
        ids_l = [ids_t[r].to(d) for r, d in enumerate(self.devices)]
        valid_l = [valid_t[r].to(d) for r, d in enumerate(self.devices)]
        try:
            _CHAOS_EXCHANGE()
            out, overflow = self._exchange(ids_l, valid_l, cap)
        except (PeerTimeout, TimeoutError):
            # a peer shard timed out: serve the rows each host resolves
            # without the exchange, zeros elsewhere, flagged
            return self._degraded_lookup(ids_t.cpu().numpy(),
                                         valid_t.cpu().numpy())
        self.last_degraded = False
        self.last_overflow = overflow
        self._overflow_recorded = False
        if patch is not None:
            pos, rows = patch
            out[self.info.host].index_copy_(
                0, torch.from_numpy(pos.astype(np.int64)).to(out.device),
                rows.to(out.device))
        from ..telemetry import flightrec

        if flightrec.tracing():
            flightrec.event("dist.lookup", {
                "hosts": int(nh), "batch": int(B),
                "overlay_patched": patch is not None})
        return out

    def _degraded_lookup(self, ids: np.ndarray, valid: np.ndarray):
        """Peer-timeout answer: each host keeps the rows its own shard
        can answer (owned, replicated, or, for this host, in the
        overlay); everything else is zero.  ``last_degraded`` flags it
        and ``last_degraded_mask`` says which rows are real."""
        check_ambient("dist_feature")
        from .. import telemetry
        from ..telemetry import flightrec

        info = self.info
        src = self._host_source
        if src is None:
            raise RuntimeError("the degraded lookup needs "
                               "from_global_feature (its host source)")
        nh, B = ids.shape
        owner = info.global2host[ids]
        local = valid & (info.replicate_mask[ids]
                         | (owner == np.arange(nh)[:, None]))
        if self.cold_cache is not None:
            me = info.host
            pos = np.nonzero(valid[me] & ~local[me])[0]
            if len(pos):
                with self._ov_lock:
                    hit, _ = self.cold_cache.probe(
                        ids[me, pos].astype(np.int64))
                local[me, pos[hit]] = True
        out = torch.zeros((nh, B, src.shape[1]), dtype=src.dtype)
        lm = torch.from_numpy(local)
        out[lm] = src[torch.from_numpy(ids[local].astype(np.int64))]
        self.last_degraded = True
        self.last_degraded_mask = local
        self.last_overflow = torch.zeros(nh, dtype=torch.int32)
        self._overflow_recorded = True
        telemetry.counter("dist_feature_degraded_total").inc()
        if flightrec.tracing():
            flightrec.event("dist.lookup", {
                "degraded": True, "hosts": int(nh), "batch": int(B),
                "served": int(local.sum()),
                "dropped": int((valid & ~local).sum())})
        return out.to(self.devices[0])

    def overflow_stats(self):
        """Per-host dropped-query counts of the last lookup, on the host
        (``None`` before any call); the first read of a lookup's counts
        feeds ``dist_feature_overflow_total``."""
        if self.last_overflow is None:
            return None
        arr = self.last_overflow.cpu().numpy()
        if not self._overflow_recorded:
            self._overflow_recorded = True
            total = float(arr.sum())
            if total:
                from .. import telemetry

                telemetry.counter("dist_feature_overflow_total").inc(total)
        return arr

    def __getitem__(self, ids):
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids)
        if ids.ndim == 1:  # parity mode: this batch on every host
            if not getattr(self, "_warned_1d", False):
                import warnings

                warnings.warn(
                    "DistFeature[1-D ids] broadcasts the batch to every "
                    "host shard (n_hosts x bandwidth), a parity shim for "
                    "the reference's per-rank __getitem__.  Pass "
                    "[n_hosts, B] ids to lookup() for the efficient path.",
                    stacklevel=2)
                self._warned_1d = True
            out = self.lookup(np.tile(ids[None], (self.n, 1)))
            return out[self.info.host]
        return self.lookup(ids)
