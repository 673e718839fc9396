"""Explicit device meshes for the sharded serving tier (counterpart of
``quiver_tpu/mesh/topology.py``).

Names the two axes the tier partitions along (``data`` for batch
parallelism, ``shard`` for row-range sharding), builds the ``(data,
shard)`` mesh a shard group serves over, and gives the placement helpers
and regex partition rules the sharded structures of ``mesh/`` use.

CPU rehearsal: a mesh may repeat a device, so the whole tier runs on
``make_mesh(..., devices=[torch.device("cpu")] * n)``; on one card,
``[torch.device("cuda", 0)] * n`` runs ``n`` shards one after another.
:func:`require_devices` counts the visible cards, the default devices of
every mesh.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.mesh import Mesh, make_mesh, visible_cards

__all__ = ["DATA_AXIS", "SHARD_AXIS", "require_devices", "build_mesh",
           "row_shard", "replicated", "shard_ranges",
           "match_partition_rules"]

DATA_AXIS = "data"
SHARD_AXIS = "shard"

_DEVICES_HINT = ("pass devices= explicitly: [torch.device('cpu')] * n on "
                 "the CPU, or a card repeated, [torch.device('cuda', 0)] * n")


def require_devices(n: int) -> None:
    """Fail fast, naming the way out, when fewer cards are visible than
    a mesh over the default devices needs."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"mesh needs {n} devices but this process sees {have} CUDA "
            f"cards; {_DEVICES_HINT}")


def build_mesh(n_shards: int, data: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """An explicit ``(data, shard)`` mesh over ``data * n_shards``
    devices (the first cards when ``devices`` is None).  ``data=1`` still
    carries the axis."""
    n_shards = int(n_shards)
    data = int(data)
    if n_shards < 1 or data < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got data={data} shard={n_shards}")
    need = data * n_shards
    if devices is None:
        require_devices(need)
        devices = visible_cards()[:need]
    devices = list(devices)[:need]
    if len(devices) < need:
        raise ValueError(f"mesh needs {need} devices, got {len(devices)}")
    return make_mesh((DATA_AXIS, SHARD_AXIS), shape=(data, n_shards),
                     devices=devices)


def row_shard(mesh: Mesh, axis: str = SHARD_AXIS) -> List[torch.device]:
    """Rows partitioned along ``axis``: the device of each row block."""
    return mesh.axis_devices(axis)


def replicated(mesh: Mesh) -> List[torch.device]:
    """Fully replicated placement: every device of the mesh."""
    return list(mesh.devices.reshape(-1))


def shard_ranges(n_rows: int, n_shards: int
                 ) -> Tuple[int, List[Tuple[int, int]]]:
    """Balanced contiguous row ranges: ``rows_per_shard`` (ownership is
    ``id // rows_per_shard``) and the half-open ``[lo, hi)`` range each
    shard owns (the last may be short)."""
    n_rows, n_shards = int(n_rows), int(n_shards)
    if n_rows < 1 or n_shards < 1:
        raise ValueError(f"need n_rows>=1, n_shards>=1; got "
                         f"{n_rows}, {n_shards}")
    rows_per_shard = -(-n_rows // n_shards)
    ranges = [(s * rows_per_shard, min((s + 1) * rows_per_shard, n_rows))
              for s in range(n_shards)]
    return rows_per_shard, ranges


def match_partition_rules(rules: Sequence[Tuple[str, object]], tree):
    """Regex -> spec over a nested parameter mapping: the first rule
    whose pattern searches the ``/``-joined path of a leaf gives its
    spec.  An unmatched leaf raises."""

    def assign(node, path):
        if isinstance(node, dict):
            return {k: assign(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(assign(v, path + (str(i),))
                              for i, v in enumerate(node))
        name = "/".join(path)
        for pattern, spec in rules:
            if re.search(pattern, name):
                return spec
        raise ValueError(f"no partition rule matches param {name!r}")

    return assign(tree, ())
