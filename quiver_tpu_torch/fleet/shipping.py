"""WAL shipping: read-only follower tails over the leader's log
(counterpart of ``quiver_tpu/fleet/shipping.py``).

The fleet keeps writes single-writer — one ingest leader appends to the
WAL (``recovery/wal.py``) — and read replicas *tail* the log, folding
acked records into their own graph.  Two transports share one
catch-up/holdback core (:class:`TailFollower`):

  * :class:`WALFollower` (here) reads the leader's segment files
    directly — the shared-filesystem deployment.  It never opens the
    log for writing (a :class:`~quiver_tpu_torch.recovery.wal.WriteAheadLog`
    constructor would truncate the leader's live torn tail), it only
    reads bytes and walks ``blockio.scan_records`` frames, so any
    number of followers can ship from one leader directory.
  * :class:`~quiver_tpu_torch.fleet.walstream.WALStreamFollower` receives
    the same frames over a TCP JSON-lines stream from the leader's
    :class:`~quiver_tpu_torch.fleet.walstream.WALStreamServer` — fleets with
    no shared filesystem.  Same holdback, same staleness contract.

Three live-tailing realities shape the loop:

  * **torn tail = write in progress.**  Replay-at-boot treats a torn
    frame as crash debris; a live follower treats it as the leader's
    append racing the read — it keeps its offset, ticks
    ``fleet_ship_torn_waits_total``, and re-polls.  Waiting is correct
    in both worlds: if the leader actually crashed, its restart
    truncates the debris and the next poll sees a clean (shorter) file.
  * **abort holdback.**  An abort record compensates a durable-but-
    nacked op and lands at the very next LSN (the ingest worker is the
    only appender).  The follower therefore holds back the newest
    visible record until a successor slot appears — proving no abort is
    coming — or a grace window passes (the leader appends the abort
    microseconds after the failed apply, so a grace-expired commit that
    later meets its abort means the leader was suspended mid-pair; that
    is detected as a *late abort* and answered with a checkpoint
    resync, never silently diverging state).
  * **truncation gaps.**  ``truncate_through`` after a leader
    checkpoint may delete segments a lagging follower still needed.
    The follower detects the gap (its next LSN precedes every remaining
    segment) and resyncs from the newest shared checkpoint
    (``fleet_ship_resyncs_total``) instead of stranding.

Staleness is measured, not assumed: ``fleet_replica_staleness_lsn`` is
the distance between the last LSN visible (on disk, or past the stream
frontier) and the last LSN folded into the follower's graph;
``fleet_replica_staleness_seconds`` is how long the follower has been
behind (0 while caught up).  The staleness contract the router and the
chaos harness rely on is in docs/FLEET.md.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import telemetry
from ..recovery import blockio
from ..recovery.errors import WALError
from ..recovery.wal import decode_abort, decode_edge_op
from ..resilience import chaos

__all__ = ["TailFollower", "WALFollower", "list_segments", "scan_frames"]

log = logging.getLogger("quiver_tpu_torch.fleet")

_CHAOS_SHIP = chaos.point("fleet.ship")

# same on-disk naming contract as recovery/wal.py (`wal-<start_lsn>.seg`,
# 20-digit zero-padded) — the follower reads the layout, it never owns it
_SEG_RE = re.compile(r"^wal-(\d{20})\.seg$")


def list_segments(wal_dir: str) -> List[Tuple[int, str]]:
    """``(start_lsn, path)`` per segment under ``wal_dir``, sorted.
    Shared by the file follower and the walstream server — both read
    the leader's layout, neither owns it."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except OSError:
        return []
    for n in names:
        m = _SEG_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, n)))
    out.sort()
    return out


def scan_frames(data: bytes):
    """``(kind, payload, start_offset, end_offset)`` per complete frame,
    plus a trailing ``torn`` flag — end offsets come from the *next*
    frame's start, which is the only way to bound a corrupt frame.
    ``data[start:end]`` is the raw frame (header + payload), which is
    what the walstream server ships so receivers re-verify the disk
    bytes, not a re-framed copy."""
    raw = list(blockio.scan_records(data))
    torn = bool(raw) and raw[-1][0] == "torn"
    usable = raw[:-1] if torn else raw
    frames = []
    for i, (kind, off, payload) in enumerate(usable):
        if i + 1 < len(usable):
            end = usable[i + 1][1]
        elif torn:
            end = raw[-1][1]
        else:
            end = len(data)
        frames.append((kind, payload, off, end))
    return frames, torn


class TailFollower:
    """The transport-independent catch-up/holdback core.

    Subclasses implement :meth:`poll_once` (one tailing pass over their
    transport) and feed every visible slot — in LSN order — through
    :meth:`_observe`; the core resolves abort holdback, commits decoded
    edge ops through ``apply_fn(lsn, op, src, dst, ts)``, counts, and
    publishes the staleness gauges.  ``resync_fn`` is called when the
    follower is stranded (truncation gap or late abort); it must
    re-restore follower state from the newest shared checkpoint and
    return the next LSN to resume from.
    """

    _guarded_by = {
        "_next_lsn": "_lock", "_records": "_lock", "_resyncs": "_lock",
        "_staleness_lsn": "_lock", "_staleness_seconds": "_lock",
        "_caught_up_at": "_lock", "_last_error": "_lock",
    }

    def __init__(self,
                 apply_fn: Callable[[int, str, object, object, object],
                                    None],
                 start_lsn: int = -1,
                 resync_fn: Optional[Callable[[], int]] = None,
                 poll_interval_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 name: str = "follower",
                 thread_prefix: str = "quiver-fleet-ship"):
        from ..config import get_config

        cfg = get_config()
        self.apply_fn = apply_fn
        self.resync_fn = resync_fn
        self.name = str(name)
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else cfg.fleet_ship_poll_ms / 1e3)
        self.grace_s = float(grace_s if grace_s is not None
                             else cfg.fleet_ship_grace_ms / 1e3)
        self._lock = threading.Lock()
        self._next_lsn = int(start_lsn) + 1   # next LSN to commit
        self._records = 0
        self._resyncs = 0
        self._staleness_lsn = 0
        self._staleness_seconds = 0.0
        self._caught_up_at = time.monotonic()
        self._last_error: Optional[str] = None
        # follower-thread-private holdback slot (single thread root —
        # the poll loop; unit tests drive poll_once() from one thread
        # too): (lsn, payload, observed_at)
        self._held: Optional[Tuple[int, bytes, float]] = None
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"{thread_prefix}-{self.name}")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TailFollower":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self._stop_evt.set()
        if self._thread.is_alive():
            join_and_reap([self._thread], timeout, component="fleet.ship")
        self._close_transport()

    def is_running(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.poll_once()
            except Exception as e:
                # a follower that dies silently strands its replica in a
                # stale-forever state; record and keep polling
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                log.warning("wal follower %s poll failed: %s", self.name, e)
            self._stop_evt.wait(self.poll_interval_s)

    # -- transport hooks -----------------------------------------------
    def poll_once(self) -> int:
        """One tailing pass; returns records committed.  Public so unit
        tests can drive the loop deterministically without the thread."""
        raise NotImplementedError

    def _reset_cursor(self) -> None:
        """Drop transport-side position state after a resync — the next
        poll re-derives it from ``_next_lsn``."""

    def _close_transport(self) -> None:
        """Release transport resources on stop (sockets, handles)."""

    # -- the holdback core ---------------------------------------------
    def _committed_next(self) -> int:
        with self._lock:
            return self._next_lsn

    def _visible_next(self) -> int:
        return self._committed_next() + (1 if self._held is not None else 0)

    def _resync(self, reason: str) -> None:
        telemetry.counter("fleet_ship_resyncs_total",
                          replica=self.name).inc()
        log.warning("wal follower %s resyncing from checkpoint (%s)",
                    self.name, reason)
        if self.resync_fn is None:
            with self._lock:
                self._last_error = f"stranded ({reason}), no resync_fn"
            raise WALError(f"follower {self.name} stranded: {reason}")
        next_lsn = int(self.resync_fn())
        with self._lock:
            self._next_lsn = next_lsn
            self._resyncs += 1
            self._last_error = None
        self._held = None
        self._reset_cursor()

    def _observe(self, lsn: int, payload: Optional[bytes]) -> int:
        """One visible slot: resolve the held predecessor, then hold or
        commit this one.  Returns records committed.  ``payload`` is
        None for a corrupt slot (consumes its LSN, carries no op)."""
        committed = 0
        target = decode_abort(payload) if payload is not None else None
        if self._held is not None:
            held_lsn, held_payload, _t0 = self._held
            self._held = None
            if target is not None and target == held_lsn:
                # the holdback worked: skip the aborted record and
                # consume the abort's own slot in one step — this is
                # NOT a late abort, the target was never applied
                telemetry.counter("fleet_ship_aborted_total",
                                  replica=self.name).inc()
                self._advance(lsn)
                return committed
            committed += self._commit(held_lsn, held_payload)
        if target is not None:
            if target < self._committed_next():
                # abort for a record we already applied: the grace
                # window was beaten — state diverged, rebuild it
                telemetry.counter("fleet_ship_late_aborts_total",
                                  replica=self.name).inc()
                self._advance(lsn)  # consume the abort's own slot
                self._resync(f"late abort for lsn {target}")
                return committed
            # the abort's own slot commits immediately (nothing can
            # cancel an abort)
            self._advance(lsn)
        elif payload is None:
            # corrupt frame: consumes its LSN slot, carries no op
            telemetry.counter("recovery_wal_corrupt_records_total").inc()
            self._advance(lsn)
        else:
            self._held = (lsn, payload, time.monotonic())
        return committed

    def _flush_held(self) -> int:
        """Commit the held tail record once its grace window expires —
        the no-successor-visible path (idle leader)."""
        if self._held is None:
            return 0
        held_lsn, payload, t0 = self._held
        if (time.monotonic() - t0) >= self.grace_s:
            self._held = None
            return self._commit(held_lsn, payload)
        return 0

    def _commit(self, lsn: int, payload: bytes) -> int:
        try:
            op, src, dst, ts = decode_edge_op(payload)
        except WALError as e:
            log.warning("follower %s: undecodable record at lsn %d: %s",
                        self.name, lsn, e)
            self._advance(lsn)
            return 0
        self.apply_fn(lsn, op, src, dst, ts)
        with self._lock:
            self._next_lsn = lsn + 1
            self._records += 1
        telemetry.counter("fleet_ship_records_total",
                          replica=self.name).inc()
        return 1

    def _advance(self, lsn: int) -> None:
        with self._lock:
            self._next_lsn = lsn + 1

    def _extra_lag(self) -> int:
        """Transport-visible lag beyond the held slot (the stream
        follower knows the leader's frontier from keepalives; file
        followers see exactly what is on disk)."""
        return 0

    def _publish_staleness(self) -> None:
        """Distance between what is visible and what is applied.  The
        held-back tail record counts as visible-but-unapplied (honest:
        it IS behind, bounded by the grace window)."""
        lag = (1 if self._held is not None else 0) + self._extra_lag()
        now = time.monotonic()
        with self._lock:
            self._staleness_lsn = lag
            if lag == 0:
                self._caught_up_at = now
                self._staleness_seconds = 0.0
            else:
                self._staleness_seconds = max(now - self._caught_up_at, 0.0)
            s_lsn, s_sec = self._staleness_lsn, self._staleness_seconds
        telemetry.gauge("fleet_replica_staleness_lsn",
                        replica=self.name).set(float(s_lsn))
        telemetry.gauge("fleet_replica_staleness_seconds",
                        replica=self.name).set(s_sec)

    # -- read side -----------------------------------------------------
    @property
    def applied_lsn(self) -> int:
        with self._lock:
            return self._next_lsn - 1

    def status(self) -> dict:
        with self._lock:
            out = {
                "name": self.name,
                "applied_lsn": self._next_lsn - 1,
                "records": self._records,
                "resyncs": self._resyncs,
                "staleness_lsn": self._staleness_lsn,
                "staleness_seconds": round(self._staleness_seconds, 3),
                "last_error": self._last_error,
            }
        out["running"] = self._thread.is_alive()
        return out


class WALFollower(TailFollower):
    """Tail one leader WAL directory, applying committed records.

    The shared-filesystem transport over :class:`TailFollower`: walks
    segment files with a frame-boundary byte cursor, waits on torn
    tails, rotates at sealed segment ends, and resyncs across
    truncation gaps.
    """

    def __init__(self, wal_dir: str,
                 apply_fn: Callable[[int, str, object, object, object],
                                    None],
                 start_lsn: int = -1,
                 resync_fn: Optional[Callable[[], int]] = None,
                 poll_interval_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 name: str = "follower"):
        super().__init__(apply_fn, start_lsn=start_lsn,
                         resync_fn=resync_fn,
                         poll_interval_s=poll_interval_s, grace_s=grace_s,
                         name=name, thread_prefix="quiver-fleet-ship")
        self.wal_dir = str(wal_dir)
        # follower-thread-private tail cursor (single thread root — the
        # poll loop; unit tests drive poll_once() from one thread too):
        self._seg_start: Optional[int] = None  # start LSN of open segment
        self._offset = 0                       # frame-boundary byte offset
        self._torn_waiting = False

    # -- tailing -------------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        return list_segments(self.wal_dir)

    def _reset_cursor(self) -> None:
        self._seg_start = None
        self._offset = 0

    def _reposition(self, segs: List[Tuple[int, str]]) -> bool:
        """Point the cursor at the segment containing ``_next_lsn``;
        False when the log no longer covers it (truncation gap)."""
        target = self._committed_next()
        candidates = [(s, p) for s, p in segs if s <= target]
        if not candidates:
            return False
        start, path = candidates[-1]
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        frames, _torn = scan_frames(data)
        slot, offset = start, 0
        for _kind, _payload, _off, end in frames:
            if slot >= target:
                break
            slot += 1
            offset = end
        if slot < target:
            # the durable log ends before the LSN a checkpoint claims to
            # cover — never expected (watermarks only cover synced
            # records); refuse to misnumber what follows
            return False
        # the tail cursor has one driver at a time: the poll thread in
        # production, a test calling poll_once() when the thread was never
        # started; never both
        self._seg_start = start
        self._offset = offset
        self._held = None
        return True

    def poll_once(self) -> int:
        """One tailing pass; returns records committed.  Public so unit
        tests can drive the loop deterministically without the thread."""
        _CHAOS_SHIP()
        segs = self._segments()
        if not segs:
            self._publish_staleness()
            return 0
        if self._seg_start is None or not any(
                s == self._seg_start for s, _p in segs):
            if not self._reposition(segs):
                self._resync("wal no longer covers next lsn")
                segs = self._segments()
                if not self._reposition(segs):
                    self._publish_staleness()
                    return 0
        committed = 0
        while True:
            seg_idx = next((i for i, (s, _p) in enumerate(segs)
                            if s == self._seg_start), None)
            if seg_idx is None:
                break
            start, path = segs[seg_idx]
            try:
                if os.path.getsize(path) < self._offset:
                    # shrunk behind our frame-boundary cursor — only
                    # reachable through outside interference; re-derive
                    # the cursor rather than misframe
                    if not self._reposition(segs):
                        self._resync("segment shrank behind cursor")
                        segs = self._segments()
                        continue
                with open(path, "rb") as f:
                    f.seek(self._offset)
                    chunk = f.read()
            except OSError:
                break
            base = self._offset
            frames, torn = scan_frames(chunk)
            stranded = False
            for kind, payload, _off, end in frames:
                self._torn_waiting = False
                # the chunk starts at the next unobserved slot and slots
                # are consumed in order, so the frame's LSN is implied
                lsn = self._visible_next()
                committed += self._observe(
                    lsn, payload if kind == "ok" else None)
                if self._seg_start != start:
                    # a late abort resynced mid-scan; restart the walk
                    stranded = True
                    break
                self._offset = base + end
            if stranded:
                segs = self._segments()
                continue
            if torn:
                if not self._torn_waiting:
                    self._torn_waiting = True
                    telemetry.counter("fleet_ship_torn_waits_total",
                                      replica=self.name).inc()
                break
            # clean EOF: rotate iff a successor segment exists (the
            # leader only rolls before appending to the new file, so a
            # successor means this one is sealed)
            if seg_idx + 1 < len(segs):
                next_start = segs[seg_idx + 1][0]
                if self._visible_next() < next_start:
                    # slots vanished inside a sealed segment — never
                    # expected (restart truncation precedes the roll);
                    # refuse to guess, resync
                    self._resync("sealed segment ends before successor")
                    segs = self._segments()
                    continue
                self._seg_start = next_start
                self._offset = 0
                continue
            break
        committed += self._flush_held()
        self._publish_staleness()
        return committed
