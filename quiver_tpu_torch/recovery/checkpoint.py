"""Atomic-rename snapshots of graph + coldcache state (counterpart of
``quiver_tpu/recovery/checkpoint.py``: the same ``ckpt-<seq>.qgr`` bytes
for the same state, so either package restores the other's snapshot).

One checkpoint is one file, ``ckpt-<seq>.qgr``, published through
``blockio.atomic_publish`` — readers see a complete old file or a
complete new one, never a torn hybrid.  The body is a JSON header
(format version, graph version, WAL watermark, array directory) plus a
concatenated array blob whose CRC-32C the header records.

Every array is **dtype- and endianness-pinned** in the header
(``"<i8"``, ``"<i4"``, ``"<u1"``): a snapshot written on any host
restores bit-identically on any other, and the round-trip test pins
exactly that.  Unknown format versions (or a bad magic / checksum) are
a *clean refusal* — :class:`SnapshotFormatError` /
:class:`CheckpointError`, never an exception from half-parsed bytes.

What a snapshot holds:

  * base CSR (``indptr``/``indices`` + optional ``feature_order`` and
    per-edge timestamps), the tombstone bitmap, and the **live** delta
    edges — together with ``graph_version``, the full
    ``StreamingGraph`` state at one instant (taken under the graph
    lock);
  * ``wal_lsn`` — the replay watermark: records with LSN <= it are
    already folded in, so boot replays strictly-greater LSNs and
    ``WriteAheadLog.truncate_through(wal_lsn)`` may drop the covered
    segments;
  * coldcache residency/frequency state per registered feature store
    (``ColdRowCache.export_state``), so a warm restart re-earns nothing
    that was already hot.

A snapshot of a Reddit-size graph with timestamps is about 1 GB, so the
port never joins it in memory: the body's CRC-32C is continued part by
part (native code, ``blockio.crc32c``), the parts are written in order,
and a read verifies and slices the file through one buffer.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import telemetry
from . import blockio
from .errors import CheckpointError, SnapshotFormatError

__all__ = ["CHECKPOINT_FORMAT", "CheckpointData", "save_checkpoint",
           "read_checkpoint", "load_checkpoint", "latest_checkpoint",
           "restore_graph"]

log = logging.getLogger("quiver_tpu_torch.recovery")

CHECKPOINT_FORMAT = 1
_MAGIC = b"QCKP"
_PREFIX = struct.Struct("<4sII")  # magic, format version, header length
_FILE_RE = re.compile(r"^ckpt-(\d{12})\.qgr$")

# the pinned on-disk dtype per logical array name; everything else is a
# format error, not a silent cast
_PINNED = {
    "indptr": "<i8", "indices": "<i4", "feature_order": "<i8",
    "base_ts": "<i4", "tomb": "<u1",
    "d_src": "<i4", "d_dst": "<i4", "d_ts": "<i4",
}
_CC_PINNED = {
    "slot_of": "<i4", "node_of": "<i8", "freq": "<i8", "ref": "<u1",
    "touches": "<i4",
}


@dataclass
class CheckpointData:
    """A parsed snapshot: host numpy arrays + metadata, ready to restore."""

    graph_version: int
    wal_lsn: int
    has_ts: bool
    arrays: Dict[str, np.ndarray]
    coldcaches: Dict[str, dict] = field(default_factory=dict)
    path: str = ""


def _checkpoint_path(root: str, seq: int) -> str:
    return os.path.join(root, f"ckpt-{seq:012d}.qgr")


def _list_checkpoints(root: str) -> List[str]:
    try:
        names = os.listdir(root)
    except OSError:
        return []
    found = sorted(n for n in names if _FILE_RE.match(n))
    return [os.path.join(root, n) for n in found]


def latest_checkpoint(root: str) -> Optional[str]:
    paths = _list_checkpoints(root)
    return paths[-1] if paths else None


def _pack_arrays(arrays: Dict[str, np.ndarray], pins: Dict[str, str],
                 directory: List[dict], blob: List,
                 prefix: str = "") -> None:
    offset = sum(len(b) for b in blob)
    for name, arr in arrays.items():
        pin = pins.get(name)
        if pin is None:
            raise CheckpointError(f"no pinned dtype for array {name!r}")
        a = np.ascontiguousarray(np.asarray(arr), dtype=pin)
        data = memoryview(a.reshape(-1)).cast("B")  # no copy when pinned
        directory.append({"name": prefix + name, "dtype": pin,
                          "shape": list(np.asarray(arr).shape),
                          "offset": offset, "nbytes": len(data)})
        blob.append(data)
        offset += len(data)


def _scalar(v):
    """A JSON-able Python scalar of a coldcache state's scalar (numpy
    integers would not serialize, and the header must match JAX's)."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def save_checkpoint(root: str, graph, coldcaches: Optional[dict] = None,
                    wal_lsn: int = -1, keep: Optional[int] = None) -> str:
    """Snapshot ``graph`` (a StreamingGraph) + coldcache states to
    ``root``; returns the published path.

    ``coldcaches`` maps a stable key (the caller's choice, e.g. a
    feature-store name) to a ``Feature.export_coldcache_state()`` dict.
    ``keep`` bounds retained checkpoints (older files pruned after the
    new one is durable); default ``config.recovery_checkpoint_keep``.
    """
    from ..config import get_config

    cfg = get_config()
    keep = int(keep if keep is not None else cfg.recovery_checkpoint_keep)
    os.makedirs(root, exist_ok=True)
    with graph._lock:
        base = graph._base
        arrays = {
            "indptr": base.indptr, "indices": base.indices,
            # a copy: the tombstones are written in place by later deletes
            "tomb": graph._tomb.astype(np.uint8),
        }
        if base.feature_order is not None:
            arrays["feature_order"] = base.feature_order
        if graph.has_ts:
            arrays["base_ts"] = graph._base_ts
        d_src, d_dst, d_ts = graph._delta.live_edges()
        arrays["d_src"], arrays["d_dst"] = d_src, d_dst
        if d_ts is not None:
            arrays["d_ts"] = d_ts
        version = graph._version
        has_ts = graph.has_ts
    directory: List[dict] = []
    blob: List = []
    _pack_arrays(arrays, _PINNED, directory, blob)
    cc_header: Dict[str, dict] = {}
    for key, state in (coldcaches or {}).items():
        if state is None:
            continue
        cc_arrays = {k: v for k, v in state.items()
                     if isinstance(v, np.ndarray)}
        scalars = {k: _scalar(v) for k, v in state.items()
                   if not isinstance(v, np.ndarray)}
        _pack_arrays(cc_arrays, _CC_PINNED, directory, blob,
                     prefix=f"cc/{key}/")
        cc_header[key] = {"scalars": scalars}
    crc = 0
    for part in blob:
        crc = blockio.crc32c(part, crc)
    header = {
        "format": CHECKPOINT_FORMAT,
        "graph_version": int(version),
        "wal_lsn": int(wal_lsn),
        "has_ts": bool(has_ts),
        "arrays": directory,
        "coldcaches": cc_header,
        "crc": crc,
    }
    hdr = json.dumps(header, sort_keys=True).encode()
    prefix = _PREFIX.pack(_MAGIC, CHECKPOINT_FORMAT, len(hdr))
    path = _checkpoint_path(root, int(version))
    blockio.atomic_publish(path, [prefix, hdr, *blob])
    size = len(prefix) + len(hdr) + sum(len(b) for b in blob)
    telemetry.counter("recovery_checkpoints_total").inc()
    telemetry.gauge("recovery_checkpoint_bytes").set(float(size))
    if keep > 0:
        for old in _list_checkpoints(root)[:-keep]:
            try:
                os.unlink(old)
            except OSError:
                pass
    return path


def read_checkpoint(path: str) -> CheckpointData:
    """Parse one snapshot file; typed refusal on any format problem."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
    if len(data) < _PREFIX.size:
        raise SnapshotFormatError(f"{path}: truncated prefix "
                                  f"({len(data)} bytes)")
    magic, fmt, hdr_len = _PREFIX.unpack_from(data)
    if magic != _MAGIC:
        raise SnapshotFormatError(f"{path}: bad magic {magic!r}")
    if fmt != CHECKPOINT_FORMAT:
        raise SnapshotFormatError(
            f"{path}: snapshot format {fmt} is not supported by this "
            f"build (expected {CHECKPOINT_FORMAT}) — refusing to guess "
            f"at its layout")
    hdr_end = _PREFIX.size + hdr_len
    if hdr_end > len(data):
        raise SnapshotFormatError(f"{path}: truncated header")
    try:
        header = json.loads(data[_PREFIX.size:hdr_end])
    except ValueError as e:
        raise SnapshotFormatError(f"{path}: unparsable header: {e}") from e
    body = memoryview(data)[hdr_end:]  # a view: the body is not copied
    if blockio.crc32c(body) != header.get("crc"):
        raise SnapshotFormatError(f"{path}: body checksum mismatch")
    arrays: Dict[str, np.ndarray] = {}
    for spec in header.get("arrays", []):
        off, nbytes = int(spec["offset"]), int(spec["nbytes"])
        if off + nbytes > len(body):
            raise SnapshotFormatError(
                f"{path}: array {spec['name']!r} overruns the blob")
        arr = np.frombuffer(body, dtype=np.dtype(spec["dtype"]),
                            offset=off,
                            count=nbytes // np.dtype(spec["dtype"]).itemsize)
        arrays[spec["name"]] = arr.reshape(spec["shape"])
    coldcaches: Dict[str, dict] = {}
    for key, cc in header.get("coldcaches", {}).items():
        state = dict(cc.get("scalars", {}))
        prefix = f"cc/{key}/"
        for name in list(arrays):
            if name.startswith(prefix):
                state[name[len(prefix):]] = arrays.pop(name)
        coldcaches[key] = state
    return CheckpointData(
        graph_version=int(header["graph_version"]),
        wal_lsn=int(header["wal_lsn"]), has_ts=bool(header["has_ts"]),
        arrays=arrays, coldcaches=coldcaches, path=path)


def load_checkpoint(root: str) -> Optional[CheckpointData]:
    """Newest loadable snapshot under ``root``; ``None`` when the
    directory holds none.  A corrupt newest file falls back to the next
    (with ``recovery_checkpoint_load_errors_total`` ticked); if every
    candidate refuses, the last typed error propagates — boot must not
    silently pretend there was nothing to restore.
    """
    paths = _list_checkpoints(root)
    last_error: Optional[CheckpointError] = None
    for path in reversed(paths):
        try:
            return read_checkpoint(path)
        except CheckpointError as e:
            telemetry.counter("recovery_checkpoint_load_errors_total").inc()
            log.warning("checkpoint %s unusable (%s); trying older", path, e)
            last_error = e
    if last_error is not None:
        raise last_error
    return None


def restore_graph(ckpt: CheckpointData, delta_capacity: Optional[int] = None,
                  device=None):
    """Rebuild a ``StreamingGraph`` from a parsed snapshot.

    The restored graph is bit-equivalent to the captured one: same base
    arrays, tombstones, live delta edges (re-appended in order), and
    the exact ``graph_version`` — version monotonicity across a restart
    is part of the consistency contract the crash harness checks.
    """
    from ..config import get_config
    from ..stream.graph import StreamingGraph
    from ..utils.topology import CSRTopo

    a = ckpt.arrays
    topo = CSRTopo(indptr=a["indptr"].astype(np.int64, copy=False),
                   indices=a["indices"].astype(np.int32, copy=False))
    if "feature_order" in a:
        topo.feature_order = a["feature_order"].astype(np.int64, copy=False)
    d_src = a.get("d_src")
    pending = int(len(d_src)) if d_src is not None else 0
    cfg_cap = int(delta_capacity if delta_capacity is not None
                  else get_config().stream_delta_capacity)
    base_ts = (a["base_ts"].astype(np.int32, copy=False)
               if ckpt.has_ts else None)
    g = StreamingGraph(topo, edge_ts=base_ts,
                       delta_capacity=max(cfg_cap, pending), device=device)
    with g._lock:
        tomb = a["tomb"].astype(bool)
        if tomb.shape[0] != topo.edge_count:
            raise SnapshotFormatError(
                f"{ckpt.path}: tombstone bitmap length {tomb.shape[0]} != "
                f"edge count {topo.edge_count}")
        g._tomb = tomb
        g._tombstones = int(tomb.sum())
        if pending:
            g._delta.add(d_src.astype(np.int32, copy=False),
                         a["d_dst"].astype(np.int32, copy=False),
                         a["d_ts"].astype(np.int32, copy=False)
                         if ckpt.has_ts else None)
        g._version = ckpt.graph_version
        g._snap = None
    return g
