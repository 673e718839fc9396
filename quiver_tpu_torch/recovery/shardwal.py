"""Per-shard WAL segments with a coherent group manifest (counterpart of
``quiver_tpu/recovery/shardwal.py``; its manifests and segments are byte
for byte the JAX package's for the same appends).

A mesh shard group is N processes (or shards) serving ONE
logical replica, so its durable state must recover as one unit: a
checkpoint that contains shard 0's rows through LSN 40 and shard 1's
through LSN 37 is a replica that never existed.  This module gives
each shard its own :class:`~quiver_tpu_torch.recovery.wal.WriteAheadLog`
(single-writer stays single-writer — no cross-process log contention)
under ``<root>/shard-<NN>/`` and makes the GROUP watermark explicit:

  * writes land per shard (``append(shard, payload)``), each log
    keeping its own LSN sequence and fsync policy;
  * ``publish_manifest()`` atomically publishes the vector of
    per-shard watermarks (``blockio.atomic_publish`` — readers see a
    complete old manifest or a complete new one, never a torn hybrid);
  * ``replay(shard)`` on warm boot yields each shard's records only
    **through its manifest watermark**, so a crash that landed between
    one shard's append and another's never replays into a state no
    coherent group ever occupied.  Records past the watermark are the
    un-acked tail — exactly the debris the single-log replay contract
    already allows — and are reported via :meth:`tail_lsns` so the
    caller can decide to re-drive or drop them.

The manifest is versioned monotonically; a stale writer that lost a
race publishes a lower version and :func:`load_manifest` keeps the
newest one it can parse.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

from . import blockio
from .errors import RecoveryError
from .wal import WriteAheadLog

__all__ = ["shard_wal_root", "ShardGroupWAL", "GroupManifest",
           "load_manifest"]

_MANIFEST = "group-manifest.json"


def shard_wal_root(root: str, shard: int) -> str:
    """The WAL directory of one shard inside a group root."""
    if shard < 0:
        raise ValueError(f"shard must be >= 0, got {shard}")
    return os.path.join(str(root), f"shard-{int(shard):02d}")


class GroupManifest:
    """The coherent-group watermark: one LSN per shard, versioned."""

    def __init__(self, n_shards: int, lsns: List[int], version: int = 0,
                 group: str = ""):
        self.n_shards = int(n_shards)
        self.lsns = [int(x) for x in lsns]
        self.version = int(version)
        self.group = str(group)
        if len(self.lsns) != self.n_shards:
            raise RecoveryError(
                f"manifest lsn vector has {len(self.lsns)} entries for "
                f"{self.n_shards} shards")

    def to_dict(self) -> dict:
        return {"n_shards": self.n_shards, "lsns": self.lsns,
                "version": self.version, "group": self.group}

    @classmethod
    def from_dict(cls, d: dict) -> "GroupManifest":
        return cls(n_shards=int(d["n_shards"]),
                   lsns=list(d["lsns"]),
                   version=int(d.get("version", 0)),
                   group=str(d.get("group", "")))


def load_manifest(root: str) -> Optional[GroupManifest]:
    """The group's published watermark, or None before the first
    publish.  A garbage manifest raises — boot must not silently
    replay everything a torn watermark no longer vouches for."""
    path = os.path.join(str(root), _MANIFEST)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        return GroupManifest.from_dict(json.loads(raw))
    except (ValueError, KeyError, TypeError) as e:
        raise RecoveryError(
            f"unreadable group manifest {path}: {e}") from e


class ShardGroupWAL:
    """N per-shard write-ahead logs + one atomic group watermark."""

    def __init__(self, root: str, n_shards: int, group: str = "",
                 fsync: Optional[str] = None,
                 segment_bytes: Optional[int] = None):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.root = str(root)
        self.n_shards = int(n_shards)
        self.group = str(group)
        os.makedirs(self.root, exist_ok=True)
        self.logs = [WriteAheadLog(shard_wal_root(self.root, s),
                                   fsync=fsync,
                                   segment_bytes=segment_bytes)
                     for s in range(self.n_shards)]
        existing = load_manifest(self.root)
        self._version = existing.version if existing is not None else 0

    # -- write side ----------------------------------------------------
    def append(self, shard: int, payload: bytes) -> int:
        """Durably append one record to one shard's log; returns its
        shard-local LSN (the manifest is NOT moved — call
        :meth:`publish_manifest` at the group commit point)."""
        return self.logs[int(shard)].append(payload)

    def sync(self) -> None:
        for wal in self.logs:
            wal.sync()

    def publish_manifest(self) -> GroupManifest:
        """Atomically publish the current per-shard watermarks as the
        group's coherent recovery point.  Syncs every log FIRST — a
        watermark must never vouch for bytes still in the page cache."""
        self.sync()
        self._version += 1
        manifest = GroupManifest(
            n_shards=self.n_shards,
            lsns=[wal.last_lsn for wal in self.logs],
            version=self._version, group=self.group)
        blockio.atomic_publish(
            os.path.join(self.root, _MANIFEST),
            json.dumps(manifest.to_dict(), sort_keys=True).encode())
        return manifest

    # -- read side (warm boot) ------------------------------------------
    def manifest(self) -> Optional[GroupManifest]:
        return load_manifest(self.root)

    def replay(self, shard: int,
               manifest: Optional[GroupManifest] = None,
               ) -> Iterator[Tuple[int, bytes]]:
        """Records of one shard **through the group watermark** — the
        coherent warm-boot stream.  With no manifest published yet,
        nothing replays (nothing was ever group-committed)."""
        manifest = self.manifest() if manifest is None else manifest
        if manifest is None:
            return
        through = manifest.lsns[int(shard)]
        for lsn, payload in self.logs[int(shard)].replay():
            if lsn > through:
                break
            yield lsn, payload

    def tail_lsns(self, manifest: Optional[GroupManifest] = None,
                  ) -> List[int]:
        """Per-shard count of durable records PAST the watermark — the
        un-acked tail a warm boot skipped; operators decide re-drive
        vs drop."""
        manifest = self.manifest() if manifest is None else manifest
        base = manifest.lsns if manifest is not None \
            else [-1] * self.n_shards
        return [max(wal.last_lsn - through, 0)
                for wal, through in zip(self.logs, base)]

    def truncate_through_manifest(self) -> int:
        """Drop sealed segments wholly covered by the watermark; the
        group's log-space reclaim.  Returns segments removed."""
        manifest = self.manifest()
        if manifest is None:
            return 0
        return sum(wal.truncate_through(through)
                   for wal, through in zip(self.logs, manifest.lsns))

    def stats(self) -> dict:
        manifest = self.manifest()
        return {
            "root": self.root, "group": self.group,
            "n_shards": self.n_shards,
            "last_lsns": [wal.last_lsn for wal in self.logs],
            "manifest": manifest.to_dict() if manifest else None,
            "tail": self.tail_lsns(manifest),
        }

    def close(self) -> None:
        for wal in self.logs:
            wal.close()
