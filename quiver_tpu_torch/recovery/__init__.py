"""Crash-safe durability and warm restart (counterpart of
``quiver_tpu/recovery``).

A checksummed write-ahead log under the ingest lane (``wal``),
atomic-rename snapshots of graph and coldcache state (``checkpoint``),
the program registry (``registry``), and the boot and health conductor
that ties them together (``manager``).  ``blockio`` holds the only raw
file writes, and the CRC-32C, computed by ``cpp/csrc/crc32c.cpp``.

Hot-path modules take their caches from ``registry`` at import, so only
the error tree and the registry load eagerly; ``blockio``, ``wal``,
``checkpoint``, ``manager`` and ``shardwal`` (a mesh shard group's
per-shard logs under one group manifest) load on first attribute
access.
"""

from __future__ import annotations

from .errors import (CheckpointError, RecoveryDeadlineExceeded,
                     RecoveryError, RetraceBudgetExceeded,
                     SnapshotFormatError, WALError, WALWriteError)
from .registry import (ProgramCache, ProgramRegistry, get_program_registry,
                       program_cache)

__all__ = [
    "RecoveryError", "WALError", "WALWriteError", "CheckpointError",
    "SnapshotFormatError", "RecoveryDeadlineExceeded",
    "RetraceBudgetExceeded",
    "ProgramCache", "ProgramRegistry", "get_program_registry",
    "program_cache",
    "blockio", "wal", "checkpoint", "manager", "shardwal",
    "WriteAheadLog", "RecoveryManager", "health_status", "ShardGroupWAL",
]

_LAZY = {
    "blockio": ".blockio", "wal": ".wal", "checkpoint": ".checkpoint",
    "manager": ".manager", "shardwal": ".shardwal",
}
_LAZY_NAMES = {
    "WriteAheadLog": ("wal", "WriteAheadLog"),
    "RecoveryManager": ("manager", "RecoveryManager"),
    "health_status": ("manager", "health_status"),
    "ShardGroupWAL": ("shardwal", "ShardGroupWAL"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        mod_name, attr = _LAZY_NAMES[name]
        mod = importlib.import_module("." + mod_name, __name__)
        val = getattr(mod, attr)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
