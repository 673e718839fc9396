"""Collectives (counterpart of ``quiver_tpu/dist/comm.py``).

The JAX package writes its exchanges as ``shard_map`` bodies with
``psum``, ``pmax``, ``all_to_all`` and ``ppermute`` over a mesh axis.  The
port is single-controller too: a sharded value is a list of per-shard
tensors, one on each shard's device, and the collectives below are plain
functions over such lists.  A tensor crosses devices with ``.to(dev,
non_blocking=True)``: a peer copy between two cards, nothing when both
shards name the same device.

:class:`TpuComm` keeps the reference ``NcclComm``'s surface
(``srcs/cpp/src/quiver/cuda/quiver_comm.cu:9-100``): over a :class:`Mesh`
its two primitives run in process; once ``torch.distributed`` has a
process group of more than one process (``dist.init.initialize``) they
call it, NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["TpuComm", "getNcclId", "psum", "pmax", "all_to_all",
           "ppermute"]


def getNcclId():
    """Parity shim: a single controller needs no communicator id, and a
    process group makes its own."""
    return b"torch-single-controller"


def _fold(op, parts: Iterable[torch.Tensor], device) -> torch.Tensor:
    """``op`` folded over the parts in shard order on ``device`` (default:
    the first part's); parts may come from a generator, so one part is
    made at a time beside the running result."""
    it = iter(parts)
    first = next(it)
    dev = first.device if device is None else torch.device(device)
    return functools.reduce(op, (p.to(dev, non_blocking=True) for p in it),
                            first.to(dev, non_blocking=True))


def psum(parts: Iterable[torch.Tensor], device=None) -> torch.Tensor:
    """Sum of the per-shard tensors, on ``device`` (default: the first
    shard's), adding in shard order."""
    return _fold(torch.add, parts, device)


def pmax(parts: Iterable[torch.Tensor], device=None) -> torch.Tensor:
    """Elementwise max of the per-shard tensors, on ``device``.  Equal to
    ``torch.stack(parts).amax(0)`` bit for bit (a max picks one operand
    unchanged), without the stacked copy."""
    return _fold(torch.maximum, parts, device)


def all_to_all(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``parts[i][j]`` is what shard ``i`` sends shard ``j``; returns, on
    each shard's device, ``out[j][i] = parts[i][j]`` (``jax.lax.all_to_all``
    with ``split_axis=0, concat_axis=0, tiled`` over a leading axis of the
    shard count)."""
    n = len(parts)
    for p in parts:
        if p.shape[0] != n:
            raise ValueError(f"all_to_all over {n} shards needs a leading "
                             f"axis of {n}, got {tuple(p.shape)}")
    return [torch.stack([p[j].to(parts[j].device, non_blocking=True)
                         for p in parts]) for j in range(n)]


def ppermute(parts: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Send shard ``src``'s tensor to shard ``dst`` for each pair of
    ``perm``; a shard that receives nothing gets zeros, as in JAX."""
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device, non_blocking=True)
    return out


class TpuComm:
    """Axis collectives with the reference ``NcclComm``'s surface.

    Args:
      mesh: a :class:`~quiver_tpu_torch.utils.mesh.Mesh`, or ``None`` for
        the default process group.
      axis: the mesh axis the ranks lie along.
      rank: this rank (kept for the signature; over a process group the
        group's own rank).
      group: a ``torch.distributed`` process group (default: the world's
        once initialized).
    """

    def __init__(self, mesh=None, axis: str = "data",
                 rank: Optional[int] = None, group=None):
        import torch.distributed as dist

        self.mesh = mesh
        self.axis = axis
        self.group = group
        self._pg = mesh is None or (
            dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)
        if self._pg:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "TpuComm without a mesh needs torch.distributed: call "
                    "quiver_tpu_torch.dist.initialize first")
            self.n = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.n = int(mesh.shape[axis])
            self.rank = rank if rank is not None else 0

    def allreduce(self, x):
        """Sum over the ranks (``NcclComm::allreduce``).  Over a mesh,
        ``x`` is ``[n, ...]`` (row ``i`` is rank ``i``'s value) or a list
        of per-rank tensors, and the sum is on the first rank's device;
        over a process group, ``x`` is this rank's tensor."""
        if self._pg:
            import torch.distributed as dist

            out = x.clone()
            dist.all_reduce(out, group=self.group)
            return out
        return psum(self._parts(x))

    def all_to_all(self, x):
        """Per-rank matrix exchange: row ``j`` of rank ``i``'s block goes
        to rank ``j``, whose result holds the rows from each source in
        rank order.  Over a mesh, ``x`` is ``[n, n, ...]`` (or a list of
        ``[n, ...]`` blocks) and the result ``[n, n, ...]``, the
        (source, dest) layout transposed; over a process group, ``x`` is
        this rank's ``[n, ...]`` block."""
        if self._pg:
            import torch.distributed as dist

            out = torch.empty_like(x)
            dist.all_to_all_single(out, x.contiguous(), group=self.group)
            return out
        devs = self.mesh.axis_devices(self.axis)
        parts = [p.to(d) for p, d in zip(self._parts(x), devs)]
        return torch.stack([p.to(devs[0]) for p in all_to_all(parts)])

    def _parts(self, x) -> List[torch.Tensor]:
        if isinstance(x, torch.Tensor):
            if x.shape[0] != self.n:
                raise ValueError(f"need a leading axis of {self.n} ranks, "
                                 f"got {tuple(x.shape)}")
            x = list(x)
        devs = self.mesh.axis_devices(self.axis)
        return [torch.as_tensor(p).to(d) for p, d in zip(x, devs)]

    def exchange(self, *args, **kwargs):
        raise NotImplementedError(
            "use quiver_tpu_torch.dist.DistFeature for the feature exchange")
