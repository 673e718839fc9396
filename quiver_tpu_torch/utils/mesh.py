"""Device meshes and peer cliques (counterpart of
``quiver_tpu/utils/mesh.py``).

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` of devices.  The port keeps that design.  A
:class:`Mesh` is an array of ``torch.device`` objects with named axes;
the sharded structures (``mesh/``, ``dist/``) hold one tensor a shard on
the shard's device and move tensors between devices with ``.to(dev,
non_blocking=True)``: a peer copy between two cards of a node, nothing at
all when both shards name the same device.  A device may repeat, so a
mesh of 8 logical shards runs on ``[torch.device("cpu")] * 8`` and 4
shards on ``[torch.device("cuda", 0)] * 4``.

:class:`MeshTopo` is the reference's ``p2pCliqueTopo``
(``srcs/python/quiver/utils.py:7-106``): on the card it colours the
``torch.cuda.can_device_access_peer`` matrix into cliques; CPU devices
form one clique.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "MeshTopo", "make_mesh", "init_p2p", "visible_cards",
           "host_tensor"]


def host_tensor(table) -> torch.Tensor:
    """A sharded structure's whole host table as a CPU tensor (numpy
    arrays are wrapped, not copied), from which each shard is cut."""
    if isinstance(table, torch.Tensor):
        return table.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(table))


def visible_cards() -> List[torch.device]:
    """Every CUDA card of this process; raises where there is none (a
    mesh runs on the CPU only when the caller names CPU devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; build the mesh over "
            "devices=[torch.device('cpu')] * n to run it on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; build the mesh over "
            "devices=[torch.device('cpu')] * n to run it on the CPU")
    return dev


class Mesh:
    """An ``np.ndarray`` of ``torch.device`` with named axes: JAX's
    ``Mesh`` surface (``devices``, ``axis_names``, ``shape[axis]``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [_as_device(d) for d in np.asarray(devices,
                                                  dtype=object).reshape(-1)]
        arr.reshape(-1)[:] = flat
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at index 0: where
        the shards of a structure split over ``axis`` live."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in the mesh's axes "
                             f"{self.axis_names}")
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


class MeshTopo:
    """Peer cliques over the mesh's devices (the reference's NVLink
    cliques): two cards share a clique when each can access the other's
    memory; CPU devices share one clique; a repeated device is one
    member."""

    def __init__(self, devices: Optional[Sequence] = None):
        self.devices = ([_as_device(d) for d in devices]
                        if devices is not None else visible_cards())
        cliques: List[List[torch.device]] = []
        for d in dict.fromkeys(self.devices):  # distinct, in order
            for clique in cliques:
                if all(_peers(d, m) for m in clique):
                    clique.append(d)
                    break
            else:
                cliques.append([d])
        self._cliques = dict(enumerate(cliques))

    @property
    def info(self) -> str:
        return "\n".join(f"Clique {cid} (peer): {[str(d) for d in ds]}"
                         for cid, ds in self._cliques.items())

    def get_clique_id(self, device) -> int:
        device = _as_device(device)
        for cid, ds in self._cliques.items():
            if device in ds:
                return cid
        raise KeyError(device)

    def p2p_clique(self) -> Dict[int, List[torch.device]]:
        return dict(self._cliques)

    @property
    def p2p_clique_device_list(self):
        return [ds for _, ds in sorted(self._cliques.items())]


def _peers(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    return bool(torch.cuda.can_device_access_peer(a.index, b.index)
                and torch.cuda.can_device_access_peer(b.index, a.index))


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: every visible card).
    ``shape`` defaults to all devices on the first axis; multi-axis
    shapes fill major to minor, as JAX's ``make_mesh`` does."""
    devs = np.asarray(list(devices) if devices is not None
                      else visible_cards(), dtype=object)
    if shape is None:
        shape = [len(devs)] + [1] * (len(axis_names) - 1)
    return Mesh(devs.reshape(tuple(shape)), axis_names)


def init_p2p(device_list=None) -> MeshTopo:
    """The peer cliques of ``device_list`` (default: every card).  PyTorch
    enables peer access on the first copy between two cards, so nothing
    else is switched on here."""
    return MeshTopo(device_list)
