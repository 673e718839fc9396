"""Multi-hop sampling over a row-sharded graph (counterpart of
``quiver_tpu/dist/sampler.py``).

Each rank owns a contiguous, edge-balanced row range of the CSR (its
``indptr`` rebased, so it stays local and dense).  A hop routes every
rank's frontier ids to their owners with the fixed-capacity buckets of
:class:`~quiver_tpu_torch.dist.DistFeature` (``all_to_all``), the owner
samples them on its shard (``ops/sample.py::run_hop``), and a second
``all_to_all`` ships the sampled blocks back.

Gather modes resolve as in JAX: ``"pwindow[:U]"`` (what ``"auto"`` is)
runs ``"blocked[:U]"``, and ``"pallas"``/``"lanes_fused"`` run
``"lanes"``; under ``"blocked"`` every read of the per-shard hop goes
through kernel B3.  All modes draw the same neighbours.

Each hop of each rank draws with its own two key words: JAX's are the
folded words of ``fold_in(split(key)[1], rank)`` hop by hop, which a
caller passes as ``key_words [L, n_ranks, 2]``; without them the words
come from a generator seeded by ``key``.
"""

from __future__ import annotations

import random as _random
from typing import List

import numpy as np
import torch

from ..config import resolve_gather_mode, resolve_sample_rng
from ..ops.cuda.gather_rows import gather_rows
from ..ops.sample import run_hop
from ..resilience import chaos
from ..resilience.errors import PeerTimeout
from ..resilience.retry import Backoff, retry_call
from ..sampler import LayerBlock
from ..utils.topology import CSRTopo
from .buckets import bucket, pack_ids
from .comm import all_to_all

__all__ = ["DistGraphSampler", "shard_csr_by_rows", "plan_row_shards"]

# fault-injection site of the per-hop exchange
_CHAOS_EXCHANGE = chaos.point("dist.sampler.exchange")


def plan_row_shards(indptr, n_shards: int,
                    max_local_edges: int = 2**31 - 1) -> np.ndarray:
    """Contiguous, edge-balanced row ranges from ``indptr`` alone:
    ``row_starts [n_shards + 1]`` int64.  Raises when a shard's local
    edge count would overflow the int32 positions of its rebased
    ``indptr``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    indptr = np.asarray(indptr)
    n = len(indptr) - 1
    total = int(indptr[-1])
    target = total / n_shards
    row_starts = [0]
    for s in range(1, n_shards):
        row_starts.append(int(np.searchsorted(indptr, target * s)))
    row_starts.append(n)
    row_starts = np.asarray(row_starts, dtype=np.int64)
    local_edges = indptr[row_starts[1:]] - indptr[row_starts[:-1]]
    worst = int(local_edges.max())
    if worst > max_local_edges:
        need = -(-total // max_local_edges)
        raise ValueError(
            f"a row shard holds {worst:,} edges > int32 limit "
            f"{max_local_edges:,}; use at least ~{need} shards "
            f"(got {n_shards}) or a smaller graph partition")
    if n > max_local_edges:
        raise ValueError(
            f"{n:,} nodes overflow the int32 row_starts/frontier ids")
    return row_starts


def shard_csr_by_rows(topo: CSRTopo, n_shards: int):
    """Split a CSR into ``n_shards`` edge-balanced row ranges: ``(row_starts,
    local indptr list, local indices list)``, each ``indptr`` rebased."""
    indptr = topo.indptr
    row_starts = plan_row_shards(indptr, n_shards)
    local_indptr, local_indices = [], []
    for s in range(n_shards):
        lo, hi = row_starts[s], row_starts[s + 1]
        local_indptr.append((indptr[lo: hi + 1] - indptr[lo]).astype(
            np.int64))
        local_indices.append(
            topo.indices[indptr[lo]: indptr[hi]].astype(np.int32))
    return row_starts, local_indptr, local_indices


class DistGraphSampler:
    """Multi-hop sampler over a row-sharded CSR on a mesh.

    Args:
      topo: the whole host :class:`CSRTopo`.
      mesh: mesh whose ``axis`` the edges shard over.
      sizes: fanouts, outward.
      request_cap_frac: bucket capacity as a fraction of the frontier
        (1.0: the worst case, exact; smaller drops overflowed seeds,
        which sample no neighbour and are counted).
      seed: seeds the retry backoff's jitter.
      gather_mode / sample_rng: as the single-device sampler's.
    """

    def __init__(self, topo: CSRTopo, mesh, sizes, axis: str = "data",
                 request_cap_frac: float = 1.0, seed: int = 0,
                 gather_mode: str = "auto", sample_rng: str = "auto"):
        self.topo = topo
        self.mesh = mesh
        self.axis = axis
        self.sample_rng = resolve_sample_rng(sample_rng)
        gm = resolve_gather_mode(gather_mode)
        # JAX's resolution for the per-shard hop: the fused window modes
        # read as their element-gather equivalents (same draws)
        if gm.startswith("pwindow"):
            gm = "blocked" + gm[len("pwindow"):]
        elif gm in ("pallas", "lanes_fused"):
            gm = "lanes"
        self.gather_mode = gm
        self.sizes = list(sizes)
        self.n = int(mesh.shape[axis])
        self.devices: List[torch.device] = mesh.axis_devices(axis)
        self.request_cap_frac = request_cap_frac
        row_starts, lips, lids = shard_csr_by_rows(topo, self.n)
        self.row_starts = row_starts
        # pad the shards to one size, rounded up to 128 (the lane and B3
        # reads view each table as [rows, 128]); indptr pads repeat the
        # final offset (degree 0), indices pads are zeros (never read)
        r128 = lambda v: -(-v // 128) * 128  # noqa: E731
        max_ip = r128(max(len(x) for x in lips))
        max_id = r128(max(len(x) for x in lids))
        self.indptr_sh = np.stack([np.pad(x, (0, max_ip - len(x)),
                                          mode="edge")
                                   for x in lips]).astype(np.int32)
        self.indices_sh = np.stack([np.pad(x, (0, max_id - len(x)))
                                    for x in lids]).astype(np.int32)
        self._ip = [torch.from_numpy(self.indptr_sh[s]).to(d)
                    for s, d in enumerate(self.devices)]
        self._ix = [torch.from_numpy(self.indices_sh[s]).to(d)
                    for s, d in enumerate(self.devices)]
        self._starts = [torch.from_numpy(row_starts).to(d)
                        for d in self.devices]
        # retry pacing of the exchange: short, jittered, seeded off the
        # sampler seed so runs replay byte for byte
        self._retry_backoff = Backoff(0.005, cap_s=0.02, jitter=0.5,
                                      rng=_random.Random(seed))
        self.last_overflow = None
        self._overflow_recorded = True

    def _hop(self, frontier, fmask, k: int, cap: int, words):
        """One hop for every rank: ``(nbrs, mask, overflow count)`` a rank."""
        n = self.n
        dests, oks, ocounts, reqs = [], [], [], []
        for r in range(n):
            ids, valid = frontier[r], fmask[r]
            owner = torch.searchsorted(self._starts[r], ids.to(torch.int64),
                                       right=True) - 1
            dest, overflow = bucket(owner, valid, n, cap)
            dests.append(dest)
            oks.append(valid & ~overflow)
            ocounts.append((valid & overflow).sum().to(torch.int32))
            reqs.append(pack_ids(ids, dest, n * cap).view(n, cap))
        recv = all_to_all(reqs)
        payloads = []
        for r in range(n):
            rids = recv[r].reshape(-1).to(torch.int64) - 1
            rvalid = rids >= 0
            ip = self._ip[r]
            local = torch.clamp(rids - self._starts[r][r], 0,
                                ip.shape[0] - 2)
            k0, k1 = int(words[r][0]), int(words[r][1])
            out = run_hop(ip, self._ix[r], local, k, k0, k1, rvalid,
                          self.gather_mode)
            payloads.append(torch.where(out.mask, out.nbrs + 1,
                                        torch.zeros_like(out.nbrs))
                            .view(n, cap, k))
        back = all_to_all(payloads)
        res = []
        for r in range(n):
            flat = back[r].reshape(n * cap, k)
            got = gather_rows(flat, torch.clamp(dests[r], 0, n * cap - 1))
            nbrs = torch.where(oks[r][:, None], got - 1,
                               torch.full_like(got, -1))
            res.append((nbrs, nbrs >= 0, ocounts[r]))
        return res

    def _pipeline(self, seeds: List[torch.Tensor], key_words: np.ndarray):
        n, B = self.n, seeds[0].shape[0]
        frontier = [s.to(torch.int32) for s in seeds]
        fmask = [torch.ones(B, dtype=torch.bool, device=d)
                 for d in self.devices]
        blocks = [[] for _ in range(n)]
        ocounts = [[] for _ in range(n)]
        frac = self.request_cap_frac
        for hop, k in enumerate(self.sizes):
            F = frontier[0].shape[0]
            if frac >= 1.0:
                cap = F  # exact: even one owner of the whole frontier fits
            else:
                cap = min(max(int(np.ceil(F * frac / n)) * 2, 8), F)
            res = self._hop(frontier, fmask, k, cap, key_words[hop])
            for r, (nbrs, mask, oc) in enumerate(res):
                dev = self.devices[r]
                ocounts[r].append(oc)
                pos = (F + torch.arange(F, dtype=torch.int32,
                                        device=dev)[:, None] * k
                       + torch.arange(k, dtype=torch.int32, device=dev))
                blocks[r].append(LayerBlock(
                    nbr_local=torch.where(mask, pos, torch.zeros_like(pos)),
                    mask=mask,
                    num_targets=fmask[r].sum().to(torch.int32)))
                frontier[r] = torch.cat([frontier[r], torch.where(
                    mask, nbrs, torch.zeros_like(nbrs)).reshape(-1)])
                fmask[r] = torch.cat([fmask[r], mask.reshape(-1)])
        dev0 = self.devices[0]

        def stack(parts):
            return torch.stack([p.to(dev0, non_blocking=True)
                                for p in parts])

        layers = tuple(
            LayerBlock(nbr_local=stack([blocks[r][i].nbr_local
                                        for r in range(n)]),
                       mask=stack([blocks[r][i].mask for r in range(n)]),
                       num_targets=stack([blocks[r][i].num_targets
                                          for r in range(n)]))
            for i in reversed(range(len(self.sizes))))  # outermost first
        return (stack(frontier), stack(fmask),
                stack([m.sum().to(torch.int32) for m in fmask]), layers,
                stack([torch.stack(o) for o in ocounts]))

    def sample(self, seed_batches, key=None, key_words=None):
        """``seed_batches``: ``[n_ranks, B]``, one seed batch a rank.
        ``key_words``: ``[L, n_ranks, 2]`` uint32 words of each hop and
        rank; without them words come from a generator seeded by ``key``
        (an int, random when None).  Returns ``(n_id, n_id_mask,
        num_nodes, blocks)``, each stacked on a leading rank axis on the
        first rank's device, blocks outermost first.

        After each call ``last_overflow`` holds the ``[n_ranks, L]``
        counts of frontier entries that overflowed their bucket and
        sampled no neighbour: always 0 at ``request_cap_frac=1.0``."""
        seeds = torch.as_tensor(seed_batches).to(torch.int64)
        nd, B = seeds.shape
        if nd != self.n:
            raise ValueError(f"need seeds for {self.n} ranks, got {nd}")
        L = len(self.sizes)
        if key_words is None:
            if key is None:
                key = np.random.randint(0, 2**31 - 1)
            g = torch.Generator().manual_seed(int(key))
            key_words = torch.randint(0, 2**32, (L, nd, 2), generator=g,
                                      dtype=torch.int64).numpy()
        key_words = np.asarray(key_words, dtype=np.uint32).reshape(L, nd, 2)
        seed_l = [seeds[r].to(d) for r, d in enumerate(self.devices)]

        def exchange():
            _CHAOS_EXCHANGE()
            return self._pipeline(seed_l, key_words)

        def on_retry(attempt, exc):
            from .. import telemetry

            telemetry.counter("dist_sampler_retries_total").inc()

        # one retry after a short jittered backoff; a second timeout
        # reaches the caller (a frontier with holes would bias training)
        n_id, n_mask, num, blocks, overflow = retry_call(
            exchange, attempts=2, backoff=self._retry_backoff,
            retry_on=(PeerTimeout, TimeoutError), on_retry=on_retry)
        self.last_overflow = overflow
        self._overflow_recorded = False
        return n_id, n_mask, num, blocks

    def overflow_stats(self):
        """Per-hop dropped-request counts of the last ``sample``, on the
        host ``[n_ranks, L]`` (``None`` before any call); the first read
        of a call's counts feeds ``dist_sampler_overflow_total``."""
        if self.last_overflow is None:
            return None
        arr = self.last_overflow.cpu().numpy()
        if not self._overflow_recorded:
            self._overflow_recorded = True
            total = float(arr.sum())
            if total:
                from .. import telemetry

                telemetry.counter("dist_sampler_overflow_total").inc(total)
        return arr
