"""Fenced leader election: auto-failover without a coordination service
(counterpart of ``quiver_tpu/fleet/election.py``).

The fleet's write path is single-appender by construction — exactly one
leader owns the WAL.  Leader *placement* is static: the process
started with ``role="leader"`` is the leader until an operator says
otherwise.  This module closes the gap for leader *death*: when the
leader's membership heartbeat expires, followers race to promote the
most-caught-up candidate, and an **epoch fencing token** guarantees the
single-appender invariant survives the race — even against a deposed
leader that is merely suspended, not dead.

The ladder (docs/FLEET.md "Leader failover & fencing"):

  1. **detect** — no fresh leader record and no fresh claim for longer
     than the heartbeat timeout.
  2. **rank** — fresh members sort by (replayed LSN desc, replica id
     asc).  Rank r waits ``r * fleet_election_stagger_s`` before
     claiming, so the most-caught-up follower claims first unless it is
     dead too.
  3. **claim** — publish ``election/claim-<epoch:020d>.json`` through
     ``blockio.atomic_publish(..., exclusive=True)``: tmp + fsync +
     ``os.link``.  The link is a filesystem compare-and-swap — exactly
     one racer owns each epoch, and a reader sees a complete record or
     none.  The new epoch is ``highest claimed + 1``.
  4. **promote** — the winner stops its follower tail, opens the WAL
     (truncating the dead leader's torn debris), folds in the durable
     tail with the same two-pass abort-aware replay boot uses (the
     abort-holdback contract carries through promotion), and starts an
     ingest lane whose appends are fenced.
  5. **fence** — every WAL append / roll / truncate of a fenced writer
     first checks the claim directory; a claim with a higher epoch by
     another replica means *deposed*: the write raises
     :class:`StaleEpochError` and is never durable.  Membership records
     carry the epoch too, so ``FleetMembership.leader()`` resolves
     split-brain windows by epoch, and the router re-resolves the write
     path when the epoch moves.

Liveness is heartbeat-age, exactly like membership: no quorum, no
consensus — the claim file's exclusivity is the only atomic primitive,
and the fencing token is what makes "two processes briefly believe they
lead" harmless (the stale one cannot write).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from .. import telemetry
from ..recovery import blockio
from ..recovery.errors import WALWriteError
from ..resilience import chaos
from .membership import MembershipDirectory, ReplicaInfo

__all__ = ["StaleEpochError", "ClaimRecord", "ElectionDirectory",
           "EpochFence", "FencedWAL", "LeaderElector"]

log = logging.getLogger("quiver_tpu_torch.fleet")

_CHAOS_CLAIM = chaos.point("fleet.election.claim")

_CLAIM_RE = re.compile(r"^claim-(\d{20})\.json$")


class StaleEpochError(WALWriteError):
    """A fenced write from a deposed leader: the claim directory holds
    a higher epoch owned by another replica.  Subclasses
    :class:`WALWriteError` so the ingest worker nacks the op exactly
    like any other durability failure — nothing was appended, nothing
    is acked."""


@dataclass
class ClaimRecord:
    """One epoch-stamped leadership claim."""

    epoch: int
    leader_id: str
    claim_lsn: int = -1          # the claimant's replayed LSN at claim time
    wall: float = 0.0            # wall-clock claim time (cross-process)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "leader_id": self.leader_id,
                "claim_lsn": self.claim_lsn, "wall": self.wall}

    @classmethod
    def from_dict(cls, d: dict) -> "ClaimRecord":
        return cls(epoch=int(d["epoch"]), leader_id=str(d["leader_id"]),
                   claim_lsn=int(d.get("claim_lsn", -1)),
                   wall=float(d.get("wall", 0.0)))


class ElectionDirectory:
    """``<fleet_dir>/election/claim-<epoch>.json`` claim files.

    Append-only by construction: a claim is published exclusively (the
    ``os.link`` CAS in ``blockio.atomic_publish``) and never modified.
    The current leadership is simply the highest parseable epoch; old
    claims are pruned opportunistically, newest-first readers never
    depend on them."""

    def __init__(self, fleet_root: str):
        self.root = os.path.join(str(fleet_root), "election")
        os.makedirs(self.root, exist_ok=True)

    def _epochs(self) -> List[int]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in names:
            m = _CLAIM_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        out.sort()
        return out

    def top(self) -> Optional[ClaimRecord]:
        """The highest-epoch claim, or None.  A claim file unlinked (a
        concurrent prune) or unparseable between listdir and open falls
        through to the next epoch down — a scan never dies on one bad
        file."""
        for epoch in reversed(self._epochs()):
            path = os.path.join(self.root, f"claim-{epoch:020d}.json")
            try:
                with open(path, "rb") as f:
                    return ClaimRecord.from_dict(json.loads(f.read()))
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return None

    def claim(self, record: ClaimRecord) -> bool:
        """Atomically claim ``record.epoch``; True iff this call won the
        epoch.  Exactly one racer can ever win one epoch — the loser
        re-reads :meth:`top` and stands down."""
        _CHAOS_CLAIM()
        path = os.path.join(self.root, f"claim-{record.epoch:020d}.json")
        data = json.dumps(record.to_dict(), sort_keys=True).encode()
        won = blockio.atomic_publish(path, data, exclusive=True)
        telemetry.counter("fleet_election_claims_total",
                          outcome="won" if won else "lost").inc()
        return won

    def prune(self, keep: int = 16) -> int:
        """Drop all but the newest ``keep`` claims; races are fine (the
        loser of an unlink race just counts 0 for that file)."""
        removed = 0
        for epoch in self._epochs()[:-keep] if keep else self._epochs():
            try:
                os.unlink(os.path.join(self.root,
                                       f"claim-{epoch:020d}.json"))
                removed += 1
            except OSError:
                continue
        return removed


class EpochFence:
    """The fencing token check a fenced writer runs before every write.

    Holds the epoch this process claimed; :meth:`check` re-reads the
    claim directory (at most every ``recheck_s`` seconds — 0 means
    every call, what the tests and the chaos harness use) and raises
    :class:`StaleEpochError` once a higher epoch owned by someone else
    exists.  Deposition is sticky: once seen, every later write refuses
    immediately without touching the filesystem."""

    _guarded_by = {"_deposed": "_lock", "_checked_at": "_lock"}

    def __init__(self, election_dir: ElectionDirectory, epoch: int,
                 owner: str, recheck_s: Optional[float] = None):
        from ..config import get_config

        self.election_dir = election_dir
        self.epoch = int(epoch)
        self.owner = str(owner)
        self.recheck_s = float(
            recheck_s if recheck_s is not None
            else get_config().fleet_election_fence_recheck_s)
        self._lock = threading.Lock()
        self._deposed = False
        self._checked_at = -float("inf")

    @property
    def deposed(self) -> bool:
        with self._lock:
            return self._deposed

    def check(self) -> None:
        """Raise :class:`StaleEpochError` when this epoch is fenced off."""
        now = time.monotonic()
        with self._lock:
            deposed = self._deposed
            due = (now - self._checked_at) >= self.recheck_s
            if due:
                self._checked_at = now
        if not deposed and due:
            top = self.election_dir.top()
            if (top is not None and top.epoch > self.epoch
                    and top.leader_id != self.owner):
                with self._lock:
                    self._deposed = True
                deposed = True
        if deposed:
            telemetry.counter("fleet_election_fenced_writes_total",
                              replica=self.owner).inc()
            raise StaleEpochError(
                f"epoch {self.epoch} fenced off (replica {self.owner} "
                "deposed): a higher claim exists")


class FencedWAL:
    """An epoch-fenced view of :class:`~quiver_tpu_torch.recovery.wal.
    WriteAheadLog`: ``append``/``roll``/``truncate_through`` first run
    the fence check, everything else delegates.  A deposed leader's
    write raises before a single byte lands — the cross-process half of
    the single-appender invariant (the WAL's own lock is the
    in-process half)."""

    def __init__(self, wal, fence: EpochFence):
        self._wal = wal
        self.fence = fence

    def append(self, payload: bytes) -> int:
        self.fence.check()
        return self._wal.append(payload)

    def roll(self) -> None:
        self.fence.check()
        self._wal.roll()

    def truncate_through(self, lsn: int) -> int:
        self.fence.check()
        return self._wal.truncate_through(lsn)

    def __getattr__(self, name):
        return getattr(self._wal, name)


class LeaderElector:
    """The per-replica election loop: leader-death detection, ranked
    candidacy, atomic claim, promotion/demotion callbacks.

    Pure control plane — it never touches the WAL itself.  Callbacks:

      * ``applied_lsn_fn()`` — this replica's replayed LSN (candidacy
        currency; leaders report their append frontier).
      * ``role_fn()`` — current role, ``"leader"`` | ``"follower"``.
      * ``promote_fn(claim)`` — this replica just won ``claim``; make
        it the leader (replica.py's promotion path).
      * ``demote_fn(claim)`` — a higher epoch owned by someone else
        exists while ``role_fn()`` says leader; step down.

    Drive it with :meth:`start` (daemon thread at
    ``fleet_election_poll_s``) or deterministically with :meth:`step`.
    """

    _guarded_by = {"epoch": "_lock", "_dead_since": "_lock"}

    def __init__(self, directory: MembershipDirectory, replica_id: str,
                 applied_lsn_fn: Callable[[], int],
                 role_fn: Callable[[], str],
                 promote_fn: Optional[Callable[[ClaimRecord], None]] = None,
                 demote_fn: Optional[Callable[[ClaimRecord], None]] = None,
                 poll_s: Optional[float] = None,
                 stagger_s: Optional[float] = None,
                 timeout_s: Optional[float] = None):
        from ..config import get_config

        cfg = get_config()
        self.directory = directory
        self.election_dir = ElectionDirectory(directory.root)
        self.replica_id = str(replica_id)
        self.applied_lsn_fn = applied_lsn_fn
        self.role_fn = role_fn
        self.promote_fn = promote_fn
        self.demote_fn = demote_fn
        self.poll_s = float(poll_s if poll_s is not None
                            else cfg.fleet_election_poll_s)
        self.stagger_s = float(stagger_s if stagger_s is not None
                               else cfg.fleet_election_stagger_s)
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else cfg.fleet_heartbeat_timeout_s)
        self._lock = threading.Lock()
        self.epoch = -1               # the epoch this replica holds, if any
        self._dead_since: Optional[float] = None
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"quiver-fleet-elector-{self.replica_id}")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "LeaderElector":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        self._stop_evt.set()
        if self._thread.is_alive():
            join_and_reap([self._thread], timeout,
                          component="fleet.election")

    def is_running(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.step()
            except Exception as e:
                # an elector that dies silently turns a failover fleet
                # back into a static one; log and keep polling
                log.warning("elector %s step failed: %s",
                            self.replica_id, e)
            self._stop_evt.wait(self.poll_s)

    # -- the ladder ----------------------------------------------------
    def claim_initial(self) -> ClaimRecord:
        """Boot-time claim for a configured leader: epoch = highest
        claimed + 1, retried past racers (a booting leader outranks any
        dead predecessor's claim by construction)."""
        while True:
            top = self.election_dir.top()
            epoch = (top.epoch if top is not None else 0) + 1
            rec = ClaimRecord(
                epoch=epoch, leader_id=self.replica_id,
                claim_lsn=int(self.applied_lsn_fn()),
                # claim freshness is compared across processes; wall
                # clock is the only shared clock and the timeout absorbs
                # NTP steps
                wall=time.time())
            if self.election_dir.claim(rec):
                with self._lock:
                    self.epoch = epoch
                telemetry.gauge("fleet_election_epoch").set(float(epoch))
                return rec

    def _rank(self) -> int:
        """This replica's position in the promotion order (0 = claim
        now).  Candidates are fresh members ranked most-caught-up
        first; an unlisted self ranks last (it cannot prove catch-up)."""
        peers = [r for r in self.directory.replicas(fresh_only=True)
                 if r.state not in ("draining",)]
        me = int(self.applied_lsn_fn())

        def key(r: ReplicaInfo):
            applied = (me if r.replica_id == self.replica_id
                       else r.wal_next_lsn - 1)
            return (-applied, r.replica_id)

        order = sorted(peers, key=key)
        for i, r in enumerate(order):
            if r.replica_id == self.replica_id:
                return i
        return len(order)

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One election pass; returns the action taken (None | "claimed"
        | "lost" | "demoted") — what the tests assert on."""
        now = time.monotonic() if now is None else now
        top = self.election_dir.top()
        if top is not None:
            telemetry.gauge("fleet_election_epoch").set(float(top.epoch))
        role = self.role_fn()
        with self._lock:
            my_epoch = self.epoch
        if role == "leader":
            if (top is not None and top.epoch > my_epoch
                    and top.leader_id != self.replica_id):
                log.warning("replica %s deposed by %s (epoch %d > %d)",
                            self.replica_id, top.leader_id, top.epoch,
                            my_epoch)
                if self.demote_fn is not None:
                    self.demote_fn(top)
                return "demoted"
            return None
        # follower: is there a live leader (fresh record or fresh claim)?
        leader = self.directory.leader()
        claim_fresh = (
            top is not None
            # quiverlint: ignore[QT012] -- claim freshness is cross-
            # process; wall clock is the only shared clock, the timeout
            # absorbs NTP steps
            and (time.time() - top.wall) <= self.timeout_s)
        if leader is not None or claim_fresh:
            with self._lock:
                self._dead_since = None
            return None
        with self._lock:
            if self._dead_since is None:
                self._dead_since = now
                return None
            dead_for = now - self._dead_since
        rank = self._rank()
        if dead_for < rank * self.stagger_s:
            return None
        epoch = (top.epoch if top is not None else 0) + 1
        rec = ClaimRecord(
            epoch=epoch, leader_id=self.replica_id,
            claim_lsn=int(self.applied_lsn_fn()),
            # cross-process freshness stamp
            wall=time.time())
        if not self.election_dir.claim(rec):
            # a racer beat us to this epoch — its claim is now the fresh
            # one; stand down and re-observe
            with self._lock:
                self._dead_since = None
            return "lost"
        with self._lock:
            self.epoch = epoch
            self._dead_since = None
        telemetry.counter("fleet_election_promotions_total",
                          replica=self.replica_id).inc()
        telemetry.gauge("fleet_election_epoch").set(float(epoch))
        log.warning("replica %s claimed leadership (epoch %d, lsn %d)",
                    self.replica_id, epoch, rec.claim_lsn)
        if self.promote_fn is not None:
            self.promote_fn(rec)
        return "claimed"
