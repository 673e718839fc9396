"""Ring-rotation sharded feature gather (counterpart of
``quiver_tpu/dist/ring.py``).

The complement of :class:`~quiver_tpu_torch.dist.DistFeature`'s
all-to-all: when every rank wants rows from every shard (dense demand),
the shards rotate around the ring and each rank picks up its rows as
each shard passes, so every shard crosses each link once.  Each step's
local gather is kernel B2; the rotation is ``ppermute``.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.cuda.gather_rows import gather_rows
from ..utils.mesh import host_tensor
from .comm import ppermute

__all__ = ["RingFeature"]


class RingFeature:
    """Row-range-sharded feature with a ring-rotation lookup.

    Rank ``d`` owns rows ``[d * rows_per, (d + 1) * rows_per)``; the table
    is padded with zero rows to a multiple of the rank count."""

    def __init__(self, feature, mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.n = int(mesh.shape[axis])
        self.devices: List[torch.device] = mesh.axis_devices(axis)
        src = host_tensor(feature)
        n_rows, d = src.shape
        self.rows_per = (n_rows + self.n - 1) // self.n
        pad = self.rows_per * self.n - n_rows
        if pad:
            src = torch.cat([src, torch.zeros((pad, d), dtype=src.dtype)])
        self.node_count = n_rows
        self.dim = d
        self.shards = [src[r * self.rows_per:(r + 1) * self.rows_per]
                       .contiguous().to(dev)
                       for r, dev in enumerate(self.devices)]

    def lookup(self, ids) -> torch.Tensor:
        """``ids``: ``[n_ranks, B]`` rows each rank wants -> ``[n, B, D]``
        on the first rank's device."""
        ids = torch.as_tensor(ids).to(torch.int64)
        nd, B = ids.shape
        if nd != self.n:
            raise ValueError(f"need ids for {self.n} ranks, got {nd}")
        n, rp = self.n, self.rows_per
        want = [ids[r].to(dev) for r, dev in enumerate(self.devices)]
        outs = [torch.zeros((B, self.dim), dtype=s.dtype, device=s.device)
                for s in self.shards]
        blocks = list(self.shards)
        ring = [(i, (i + 1) % n) for i in range(n)]
        for step in range(n):
            for r in range(n):
                # rank r now holds the shard of rank (r - step) % n
                base = ((r - step) % n) * rp
                local = want[r] - base
                hit = (local >= 0) & (local < rp)
                rows = gather_rows(blocks[r], torch.clamp(local, 0, rp - 1))
                outs[r] = torch.where(hit[:, None], rows, outs[r])
            if step < n - 1:  # JAX's last rotation returns every shard home
                blocks = ppermute(blocks, ring)
        dev0 = self.devices[0]
        return torch.stack([o.to(dev0, non_blocking=True) for o in outs])
