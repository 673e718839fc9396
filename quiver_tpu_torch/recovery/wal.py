"""Segmented, checksummed write-ahead log for the ingest lane
(counterpart of ``quiver_tpu/recovery/wal.py``; its segments are byte for
byte the JAX package's for the same appends, so either package replays the
other's log).

Layout: ``<root>/wal-<start_lsn>.seg`` files of framed records
(``blockio.write_record``); a segment's filename carries the LSN of its
first record, so record ``k`` of segment ``s`` has LSN ``start(s)+k``
without any per-record header field.  LSNs are the replay watermark
currency: a checkpoint stores the LSN through which its state is
complete, boot replays strictly-greater records, and
``truncate_through`` deletes sealed segments wholly at-or-below it.

Durability contract (the reason this module exists): ``append``
returns only after the record is as durable as the fsync policy
promises —

  * ``"always"`` — fsync per append.  An acked edge op survives
    kill -9 *and* power loss.  This is the default and the mode the
    crash harness certifies.
  * ``"batch"`` — fsync when ``batch_bytes`` of unsynced records
    accumulate (plus on roll/close/``sync()``).  Survives kill -9 (the
    page cache belongs to the kernel, not the process); a power cut can
    lose the unsynced tail.
  * ``"off"`` — never fsync (tests, benches measuring everything else).

Failures (including injected ``recovery.wal_write`` / ``recovery.fsync``
chaos faults) raise :class:`~quiver_tpu_torch.recovery.errors.WALWriteError`
— the ingest worker answers the submitting request with it, so a lost
write is a *reported* error, never a silent gap.

Replay walks every segment in LSN order: verified records come back as
``(lsn, payload)``; checksum-corrupt records are skipped with
``recovery_wal_corrupt_records_total`` ticked; a torn tail stops the
segment with ``recovery_wal_torn_tails_total`` ticked.  Neither crashes
boot — both are the expected debris of a crash-mid-write.  Opening a
log **truncates** any torn tail off the final segment first (same
counter), so resumed appends can never land behind bytes replay would
refuse to cross.

Two caveats shape what replay may legitimately contain beyond the
acked stream (the at-least-once side of the contract):

  * an op whose *apply* failed after a successful durable append is
    compensated with an **abort record** (:func:`encode_abort`) so
    replay skips it — a rejected mutation must not resurrect;
  * an op nacked because the *fsync itself* failed is in an
    indeterminate state — the bytes may or may not have reached media,
    and no trailing compensation can be promised on a log that just
    refused a sync.  Such a record MAY replay.  Nacked ops therefore
    must never be counted on in either direction; only acked ops are
    guaranteed present and only abort-compensated ops guaranteed
    absent.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..telemetry import timeline as _timeline
from ..resilience import chaos
from . import blockio
from .errors import WALError, WALWriteError

__all__ = ["WriteAheadLog", "encode_edge_op", "decode_edge_op",
           "encode_abort", "decode_abort", "FSYNC_POLICIES"]

FSYNC_POLICIES = ("always", "batch", "off")

_CHAOS_WAL_WRITE = chaos.point("recovery.wal_write")
_CHAOS_FSYNC = chaos.point("recovery.fsync")
_CHAOS_REPLAY = chaos.point("recovery.replay")

_SEG_RE = re.compile(r"^wal-(\d{20})\.seg$")


def _seg_name(start_lsn: int) -> str:
    return f"wal-{start_lsn:020d}.seg"


# -- edge-op record codec ---------------------------------------------------
# One record = one edge-mutation batch.  Endpoints and timestamps are
# pinned to little-endian int64 regardless of producer dtype, so a log
# written on one host replays identically on any other.

_OP_CODES = {"add": 1, "remove": 2}
_OP_NAMES = {v: k for k, v in _OP_CODES.items()}
_EDGE_HEADER = struct.Struct("<BBI")  # op code, has_ts, edge count


def encode_edge_op(op: str, src, dst, ts=None) -> bytes:
    code = _OP_CODES.get(op)
    if code is None:
        raise WALError(f"unknown edge op {op!r}")
    src = np.atleast_1d(np.asarray(src)).astype("<i8").ravel()
    dst = np.atleast_1d(np.asarray(dst)).astype("<i8").ravel()
    if src.shape != dst.shape:
        raise WALError(f"src/dst length mismatch: {src.shape} vs {dst.shape}")
    parts = [_EDGE_HEADER.pack(code, 1 if ts is not None else 0, len(src)),
             src.tobytes(), dst.tobytes()]
    if ts is not None:
        ts = np.atleast_1d(np.asarray(ts)).astype("<i8").ravel()
        if ts.shape != src.shape:
            raise WALError(f"ts length mismatch: {ts.shape} vs {src.shape}")
        parts.append(ts.tobytes())
    return b"".join(parts)


def decode_edge_op(payload: bytes):
    """``(op, src, dst, ts)`` from one record payload; typed
    :class:`WALError` on any framing inconsistency."""
    if len(payload) < _EDGE_HEADER.size:
        raise WALError(f"edge record too short: {len(payload)} bytes")
    code, has_ts, n = _EDGE_HEADER.unpack_from(payload)
    op = _OP_NAMES.get(code)
    if op is None:
        raise WALError(f"unknown edge op code {code}")
    want = _EDGE_HEADER.size + 8 * n * (3 if has_ts else 2)
    if len(payload) != want:
        raise WALError(f"edge record length {len(payload)} != expected "
                       f"{want} for {n} edges")
    off = _EDGE_HEADER.size
    src = np.frombuffer(payload, dtype="<i8", count=n, offset=off)
    off += 8 * n
    dst = np.frombuffer(payload, dtype="<i8", count=n, offset=off)
    off += 8 * n
    ts = (np.frombuffer(payload, dtype="<i8", count=n, offset=off)
          if has_ts else None)
    to_native = lambda a: a.astype(np.int64, copy=True)  # noqa: E731
    return op, to_native(src), to_native(dst), \
        (to_native(ts) if ts is not None else None)


# An abort is a compensation record: the durable record at
# ``target_lsn`` was answered with an error live (its apply failed
# AFTER the append), so replay must not fold it in — otherwise a
# recovered graph would contain a mutation the serving process
# rejected, and post-crash state would diverge from the state the
# crash harness certifies.  Aborts share the edge-op framing (code 3,
# one little-endian int64 "endpoint" carrying the target LSN) so an
# older reader treats them as an unknown-op skip, never a crash.

_ABORT_CODE = 3


def encode_abort(target_lsn: int) -> bytes:
    return (_EDGE_HEADER.pack(_ABORT_CODE, 0, 1)
            + struct.pack("<q", int(target_lsn)))


def decode_abort(payload: bytes) -> Optional[int]:
    """Target LSN when ``payload`` is an abort record, else None."""
    if len(payload) != _EDGE_HEADER.size + 8:
        return None
    code, _has_ts, _n = _EDGE_HEADER.unpack_from(payload)
    if code != _ABORT_CODE:
        return None
    return int(struct.unpack_from("<q", payload, _EDGE_HEADER.size)[0])


# -- the log ----------------------------------------------------------------

class WriteAheadLog:
    """Segmented append log; see module docstring for the contract."""

    _guarded_by = {
        "_f": "_lock", "_seg_written": "_lock", "_next_lsn": "_lock",
        "_seg_path": "_lock", "_unsynced": "_lock", "_closed": "_lock",
    }

    def __init__(self, root: str, segment_bytes: Optional[int] = None,
                 fsync: Optional[str] = None,
                 batch_bytes: Optional[int] = None):
        from ..config import get_config

        cfg = get_config()
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.segment_bytes = int(segment_bytes if segment_bytes is not None
                                 else cfg.recovery_segment_bytes)
        self.fsync_policy = str(fsync if fsync is not None
                                else cfg.recovery_fsync)
        if self.fsync_policy not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy must be one of {FSYNC_POLICIES},"
                             f" got {self.fsync_policy!r}")
        self.batch_bytes = int(batch_bytes if batch_bytes is not None
                               else cfg.recovery_batch_bytes)
        self._lock = threading.RLock()  # re-entered by the _locked helpers
        self._f = None
        self._seg_path: Optional[str] = None
        self._seg_written = 0
        self._unsynced = 0
        self._closed = False
        # resume LSN accounting from what is already on disk: only the
        # LAST segment needs a scan (earlier counts are implied by the
        # next segment's start LSN).  Torn debris is truncated off the
        # tail HERE, before any append can reopen the segment — if the
        # very first record tore (crash mid-first-write), the slot
        # count is 0 and the next roll reuses the same wal-<start>.seg
        # name; appending behind un-truncated torn bytes would strand
        # every new record past the point replay stops at.
        segs = self._segments()
        if segs:
            start, path = segs[-1]
            self._next_lsn = start + _resume_segment(path)
        else:
            self._next_lsn = 0
        telemetry.gauge("recovery_wal_segments_total").set(float(len(segs)))

    # -- write side ---------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Durably append one record; returns its LSN.

        Raises :class:`WALWriteError` on any write/fsync failure
        (including chaos faults) — the record must then be treated as
        NOT durable and the submitting request answered with the error.
        """
        t0 = time.perf_counter() if _timeline._ON else 0.0
        with self._lock:
            if self._closed:
                raise WALWriteError("append on closed WAL")
            try:
                _CHAOS_WAL_WRITE()
                if (self._f is None
                        or self._seg_written >= self.segment_bytes):
                    self._roll_locked()
                n = blockio.write_record(self._f, payload)
                self._seg_written += n
                self._unsynced += n
                lsn = self._next_lsn
                self._next_lsn += 1
                if self.fsync_policy == "always" or (
                        self.fsync_policy == "batch"
                        and self._unsynced >= self.batch_bytes):
                    self._sync_locked()
            except WALError:
                raise
            except Exception as e:
                raise WALWriteError(f"wal append failed: {e}") from e
        telemetry.counter("recovery_wal_records_total").inc()
        telemetry.counter("recovery_wal_bytes_total").inc(float(n))
        if _timeline._ON and t0:
            _timeline.emit("wal.append", cat="wal",
                           dur_s=time.perf_counter() - t0,
                           attrs={"lsn": lsn, "bytes": int(n)})
        return lsn

    def sync(self) -> None:
        """Flush + fsync the open segment (no-op under policy "off")."""
        with self._lock:
            if self._f is None or self._closed:
                return
            try:
                self._sync_locked()
            except WALError:
                raise
            except Exception as e:
                raise WALWriteError(f"wal fsync failed: {e}") from e

    def roll(self) -> None:
        """Seal the open segment and start a fresh one — called before a
        checkpoint so truncation can drop everything the checkpoint
        covers (the open segment is never deleted)."""
        with self._lock:
            if not self._closed:
                self._roll_locked()

    def _sync_locked(self) -> None:
        with self._lock:  # re-entrant: callers already hold it
            # the chaos point lives inside the policy gate: "off"
            # promises no fsync, so an injected fsync fault has nothing
            # real to stand in for there
            if self.fsync_policy != "off":
                t0 = time.perf_counter() if _timeline._ON else 0.0
                _CHAOS_FSYNC()
                self._f.flush()
                os.fsync(self._f.fileno())
                telemetry.counter("recovery_wal_fsyncs_total").inc()
                if _timeline._ON and t0:
                    _timeline.emit("wal.fsync", cat="wal",
                                   dur_s=time.perf_counter() - t0)
            self._unsynced = 0

    def _roll_locked(self) -> None:
        with self._lock:  # re-entrant: callers already hold it
            if self._f is not None:
                self._sync_locked()
                self._f.close()
            self._seg_path = os.path.join(self.root,
                                          _seg_name(self._next_lsn))
            self._f = blockio.append_open(self._seg_path)
            self._seg_written = 0
            self._unsynced = 0
        blockio.fsync_dir(self.root)
        telemetry.gauge("recovery_wal_segments_total").set(
            float(len(self._segments())))

    @property
    def last_lsn(self) -> int:
        """LSN of the newest appended record (-1 when empty)."""
        with self._lock:
            return self._next_lsn - 1

    @property
    def next_lsn(self) -> int:
        with self._lock:
            return self._next_lsn

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                try:
                    if self.fsync_policy != "off":
                        self._f.flush()
                        os.fsync(self._f.fileno())
                finally:
                    self._f.close()
                    self._f = None

    # -- read side ----------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        out.sort()
        return out

    def replay(self) -> Iterator[Tuple[int, bytes]]:
        """Yield ``(lsn, payload)`` for every verified record on disk.

        Corrupt records are skipped (they still consume an LSN slot so
        later records keep their positions); a torn tail ends its
        segment.  Both tick telemetry; neither raises.  The
        ``recovery.replay`` chaos point fires once per segment.
        """
        with self._lock:
            # under fsync="batch"/"off" the open segment's tail may sit
            # in the stdio buffer — push it to the page cache so a live
            # replay sees every appended record
            if self._f is not None and not self._closed:
                self._f.flush()
        for start_lsn, path in self._segments():
            _CHAOS_REPLAY()
            with open(path, "rb") as f:
                data = f.read()
            lsn = start_lsn
            for kind, _off, payload in blockio.scan_records(data):
                if kind == "ok":
                    yield lsn, payload
                    lsn += 1
                elif kind == "corrupt":
                    telemetry.counter(
                        "recovery_wal_corrupt_records_total").inc()
                    lsn += 1
                else:  # torn
                    telemetry.counter("recovery_wal_torn_tails_total").inc()
                    break

    # -- truncation ---------------------------------------------------
    def truncate_through(self, lsn: int) -> int:
        """Delete sealed segments whose records all have LSN <= ``lsn``.

        Safe to call any time after the covering checkpoint is durably
        published; returns the number of segments removed.  The open
        segment (and the newest segment, whose record count the name of
        a successor would otherwise bound) is never deleted.
        """
        with self._lock:
            active = self._seg_path
        segs = self._segments()
        removed = 0
        for i, (start, path) in enumerate(segs):
            if path == active or i + 1 >= len(segs):
                continue
            next_start = segs[i + 1][0]
            if next_start - 1 <= lsn:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    continue
        if removed:
            blockio.fsync_dir(self.root)
            telemetry.counter(
                "recovery_wal_truncated_segments_total").inc(removed)
            telemetry.gauge("recovery_wal_segments_total").set(
                float(len(self._segments())))
        return removed


def _resume_segment(path: str) -> int:
    """LSN slots consumed by a segment (ok + corrupt records) — how
    ``__init__`` resumes numbering.

    A torn tail ends the count AND is truncated off the file (through
    ``blockio.truncate_at``, the one sanctioned shortener), so a
    segment the log re-appends to can never put fresh records behind
    bytes replay refuses to cross.  The tick happens here instead of at
    replay for a trimmed tail — the debris is gone before replay runs."""
    with open(path, "rb") as f:
        data = f.read()
    n = 0
    torn_at = None
    for kind, off, _payload in blockio.scan_records(data):
        if kind == "torn":
            torn_at = off
            break
        n += 1
    if torn_at is not None:
        blockio.truncate_at(path, torn_at)
        telemetry.counter("recovery_wal_torn_tails_total").inc()
    return n
