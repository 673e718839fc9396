"""Frontier exchange over the mesh: row-range-sharded neighbour sampling
(counterpart of ``quiver_tpu/mesh/sampler.py``).

Each shard holds the CSR rows of its own row range (a local ``indptr``
over ``rows_per_shard`` rows, global ids in ``indices``) and samples the
whole frontier with :func:`~quiver_tpu_torch.ops.sample.
sample_neighbors_overlay`, the op the streaming tier serves, under a
``seed_mask`` of the rows it owns.  The op's uniforms are keyed by the
key words and ``(B, k)`` alone, never by seed ids, so each shard draws
exactly the single-device sampler's neighbours for its rows; the
per-shard outputs are disjoint, and ``pmax`` on ``nbrs``/``mask``/``eid``
with ``psum`` on ``counts`` reassembles the single-device ``SampleOut``
bit for bit.

``gather_mode="xla"`` (the default, as in JAX) reads by plain indexing;
``"pallas"``, ``"blocked"`` and ``"pwindow"`` read every element through
kernel B3, five launches a hop a shard.  The draws are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..config import resolve_gather_mode, resolve_sample_rng
from ..dist.comm import pmax, psum
from ..ops.sample import SampleOut, key_words_pair, sample_neighbors_overlay
from ..recovery.registry import program_cache
from .topology import SHARD_AXIS, build_mesh, shard_ranges

__all__ = ["MeshSampler"]


def _pow2(n: int) -> int:
    b = 1
    while b < max(int(n), 1):
        b <<= 1
    return b


def _r128(n: int) -> int:
    return -(-int(n) // 128) * 128


class MeshSampler:
    """One-hop frontier sampling over a row-range-sharded CSR.

    Args:
      indptr / indices: the whole host CSR.
      n_shards: shard count (default ``config.mesh_shards``).
      mesh: a mesh with a ``"shard"`` axis (default ``build_mesh``).
      gather_mode: the per-shard reads (``config.resolve_gather_mode``).
      sample_rng: ``"auto"`` or ``"hash"`` (the port's one RNG).
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 n_shards: Optional[int] = None, mesh=None,
                 gather_mode: str = "xla", sample_rng: str = "auto"):
        from ..config import get_config

        cfg = get_config()
        if n_shards is None:
            n_shards = cfg.mesh_shards
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(
                f"MeshSampler needs n_shards >= 1 (config.mesh_shards "
                f"is off); got {self.n_shards}")
        self.mesh = mesh if mesh is not None else build_mesh(self.n_shards)
        self.axis = SHARD_AXIS
        self.devices = self.mesh.axis_devices(self.axis)
        if len(self.devices) != self.n_shards:
            raise ValueError(f"mesh has {len(self.devices)} devices on "
                             f"{self.axis!r}, not {self.n_shards}")
        self.device = self.devices[0]
        self.gather_mode = resolve_gather_mode(gather_mode)
        self.sample_rng = resolve_sample_rng(sample_rng)
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int32)
        self.node_count = len(indptr) - 1
        self.rows_per_shard, self.ranges = shard_ranges(
            self.node_count, self.n_shards)
        # one edge bucket over the largest shard (JAX's pow2), padded to
        # 128 so B3 can view every table as [rows, 128]; a frozen graph:
        # no tombstones, an empty delta overlay
        edge_pad = _r128(_pow2(max(
            int(indptr[hi] - indptr[lo]) for lo, hi in self.ranges)))
        ip_pad = _r128(self.rows_per_shard + 1)
        self._tables = []
        for (lo, hi), dev in zip(self.ranges, self.devices):
            lp = np.zeros(ip_pad, dtype=np.int32)
            lp[: hi - lo + 1] = indptr[lo:hi + 1] - indptr[lo]
            lp[hi - lo + 1:] = lp[hi - lo]      # pad rows: degree 0
            li = np.zeros(edge_pad, dtype=np.int32)
            li[: lp[hi - lo]] = indices[indptr[lo]:indptr[hi]]
            self._tables.append(dict(
                indptr=torch.from_numpy(lp).to(dev),
                indices=torch.from_numpy(li).to(dev),
                tomb=torch.zeros(edge_pad, dtype=torch.int32, device=dev),
                d_indptr=torch.zeros(ip_pad, dtype=torch.int32, device=dev),
                d_indices=torch.zeros(128, dtype=torch.int32, device=dev),
                base=torch.full((), int(indptr[lo]), dtype=torch.int32,
                                device=dev)))
        self._jitted = program_cache("mesh_sampler", owner=self)
        from . import _set_active_sampler

        _set_active_sampler(self)

    def sample(self, seeds, k: int, key_words) -> SampleOut:
        """One dense ``[B, k]`` hop over the sharded CSR, bitwise the
        single-device hop under the same two key words.  ``seeds`` are
        host ids or a tensor (kept on the devices)."""
        k0, k1 = key_words_pair(key_words)
        on_host = not isinstance(seeds, torch.Tensor)
        if on_host:
            seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        B = int(seeds.shape[0])
        key = ("combine", B, int(k), self.n_shards)
        if key not in self._jitted:
            self._jitted[key] = True
        outs, owned_counts = [], []
        for s, ((lo, hi), dev) in enumerate(zip(self.ranges, self.devices)):
            if on_host:
                owned_np = (seeds >= lo) & (seeds < hi)
                owned_counts.append(float(owned_np.sum()))
                owned = torch.from_numpy(owned_np).to(dev)
                local = torch.from_numpy(np.clip(
                    seeds - lo, 0, self.rows_per_shard - 1).astype(
                        np.int32)).to(dev)
            else:
                sd = seeds.to(dev, torch.int64)
                owned = (sd >= lo) & (sd < hi)
                owned_counts.append(owned.sum())
                local = torch.clamp(sd - lo, 0, self.rows_per_shard - 1)
            t = self._tables[s]
            out = sample_neighbors_overlay(
                t["indptr"], t["indices"], t["tomb"], t["d_indptr"],
                t["d_indices"], local, int(k), k0, k1, seed_mask=owned,
                gather_mode=self.gather_mode)
            # shard-local edge positions -> global: offset by the shard's
            # first edge (eid stays -1 where masked)
            eid = torch.where(out.eid >= 0, out.eid + t["base"],
                              torch.full_like(out.eid, -1))
            outs.append((out.nbrs, out.mask.to(torch.int32),
                         out.counts.to(torch.int32), eid))
        if not on_host:  # one read-back for every shard's gauge
            owned_counts = torch.stack(
                [c.to(self.device) for c in owned_counts]).tolist()
        for s, n in enumerate(owned_counts):
            telemetry.gauge("mesh_shard_frontier_rows", shard=str(s)).set(
                float(n))
        # the frontier exchange: exactly one shard owns each seed row
        nb = pmax([o[0] for o in outs], self.device)
        mk = pmax([o[1] for o in outs], self.device) > 0
        ct = psum([o[2] for o in outs], self.device)
        ei = pmax([o[3] for o in outs], self.device)
        return SampleOut(nbrs=nb, mask=mk, counts=ct, eid=ei)

    def stats(self) -> dict:
        return dict(n_shards=self.n_shards,
                    rows_per_shard=self.rows_per_shard,
                    node_count=self.node_count,
                    executables=len(self._jitted))

    def __repr__(self):
        return (f"MeshSampler(nodes={self.node_count}, "
                f"shards={self.n_shards})")
