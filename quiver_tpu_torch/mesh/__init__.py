"""``quiver_tpu_torch.mesh``: mesh-native sharded serving (counterpart of
``quiver_tpu/mesh``).

Turns N devices into one logical serving replica: the feature table and
the sampler's CSR are sharded by row range over an explicit
:class:`~quiver_tpu_torch.utils.mesh.Mesh` (``data``/``shard`` axes), and
the halo and frontier exchanges are max/sum combines of per-shard parts.
Off by default: with ``config.mesh_shards == 0`` nothing here is built.

The weakref registry below backs ``GET /debug/mesh``: the most recently
built :class:`MeshFeature` / :class:`MeshSampler` of the process.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional
from weakref import ref as _weakref

_ACTIVE_LOCK = threading.Lock()
_ACTIVE_FEATURE: Optional[Callable] = None
_ACTIVE_SAMPLER: Optional[Callable] = None


def _set_active_feature(feature) -> None:
    global _ACTIVE_FEATURE
    with _ACTIVE_LOCK:
        _ACTIVE_FEATURE = _weakref(feature)


def _set_active_sampler(sampler) -> None:
    global _ACTIVE_SAMPLER
    with _ACTIVE_LOCK:
        _ACTIVE_SAMPLER = _weakref(sampler)


def mesh_status() -> dict:
    """The ``GET /debug/mesh`` document; ``{"active": False}`` when no
    mesh structure is live in this process."""
    with _ACTIVE_LOCK:
        feature = _ACTIVE_FEATURE() if _ACTIVE_FEATURE is not None \
            else None
        sampler = _ACTIVE_SAMPLER() if _ACTIVE_SAMPLER is not None \
            else None
    if feature is None and sampler is None:
        from ..config import get_config

        return {"active": False,
                "mesh_shards": int(get_config().mesh_shards)}
    doc: dict = {"active": True}
    if feature is not None:
        doc["feature"] = feature.stats()
        doc["n_shards"] = feature.n_shards
    if sampler is not None:
        doc["sampler"] = sampler.stats()
        doc.setdefault("n_shards", sampler.n_shards)
    return doc


from .feature import MeshFeature  # noqa: E402  (registry must exist first)
from .sampler import MeshSampler  # noqa: E402
from .topology import (DATA_AXIS, SHARD_AXIS, build_mesh,  # noqa: E402
                       match_partition_rules, replicated, require_devices,
                       row_shard, shard_ranges)

__all__ = ["MeshFeature", "MeshSampler", "mesh_status", "build_mesh",
           "row_shard", "replicated", "shard_ranges",
           "match_partition_rules", "require_devices", "DATA_AXIS",
           "SHARD_AXIS"]
