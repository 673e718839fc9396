"""RecoveryManager — the boot/checkpoint/health conductor (counterpart
of ``quiver_tpu/recovery/manager.py``).

One manager owns one durability root::

    <root>/wal/wal-<lsn>.seg     append log (wal.py)
    <root>/ckpt/ckpt-<seq>.qgr   snapshots  (checkpoint.py)

and walks a process through the readiness ladder the serving tier
exposes at ``/healthz``::

    booting -> replaying -> warming -> serving

``boot_degraded()`` climbs to *replaying*: the newest loadable
checkpoint is restored (or a fresh graph built) and the WAL opened —
the graph is already **servable but stale** (``health()["stale"]``),
which is the serve-degraded-while-replaying contract: reads are
answered from the checkpointed topology while the tail of the log
folds in.  ``finish_boot()`` replays strictly past the checkpoint
watermark, optionally runs a warmup, optionally ``seal()``\\ s the
program registry (turning any later cold compile into a budget
violation), and lands on *serving*.  ``boot()`` is both in sequence.

Checkpoints are **consistent by construction**: when an
:class:`~quiver_tpu_torch.stream.ingest.IngestLane` is attached, the snapshot
runs as a *barrier* on the single writer thread — between two applies,
never inside one — so the captured graph state and the captured WAL
watermark (``lane._applied_lsn``) agree exactly.  The sequence is
roll → snapshot → truncate: the log is sealed first so truncation can
drop every segment the snapshot covers.

The replay deadline (``config.recovery_deadline_s``) bounds how long a
boot may chew log before the operator hears about it as a typed
:class:`RecoveryDeadlineExceeded` instead of a silent hang.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional

from .. import telemetry
from .checkpoint import load_checkpoint, restore_graph, save_checkpoint
from .errors import RecoveryDeadlineExceeded, RecoveryError, WALError
from .wal import WriteAheadLog, decode_abort, decode_edge_op

__all__ = ["RecoveryManager", "health_status", "set_active",
           "RECOVERY_STATES"]

log = logging.getLogger("quiver_tpu_torch.recovery")

RECOVERY_STATES = ("booting", "replaying", "warming", "serving")
_STATE_CODE = {s: i for i, s in enumerate(RECOVERY_STATES)}


class RecoveryManager:
    """Crash-only lifecycle for one StreamingGraph deployment."""

    _guarded_by = {
        "_state": "_lock", "_stale": "_lock", "_features": "_lock",
        "_lane": "_lock", "_ckpt": "_lock", "_replayed": "_lock",
    }

    def __init__(self, root: Optional[str] = None,
                 graph_factory: Optional[Callable] = None,
                 delta_capacity: Optional[int] = None, device=None,
                 segment_bytes: Optional[int] = None,
                 fsync: Optional[str] = None):
        from ..config import get_config

        cfg = get_config()
        root = str(root if root is not None else cfg.recovery_dir)
        if not root:
            raise RecoveryError(
                "no durability root: pass root= or set "
                "QUIVER_TPU_RECOVERY_DIR (config.recovery_dir)")
        self.root = root
        self.wal_dir = os.path.join(root, "wal")
        self.ckpt_dir = os.path.join(root, "ckpt")
        self.graph_factory = graph_factory
        self.delta_capacity = delta_capacity
        self.device = device
        self._wal_kwargs = {"segment_bytes": segment_bytes, "fsync": fsync}
        self.wal: Optional[WriteAheadLog] = None
        self.graph = None
        self._lock = threading.Lock()
        self._state = "booting"
        self._stale = False
        self._features: Dict[str, object] = {}
        self._lane = None
        self._ckpt = None
        self._replayed = 0
        self._replay_from = -1        # boot thread only
        self._boot_t0: Optional[float] = None
        self._boot_seconds: Optional[float] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_wake = threading.Event()
        set_active(self)

    # -- state ladder --------------------------------------------------
    def _set_state(self, state: str, stale: Optional[bool] = None) -> None:
        with self._lock:
            self._state = state
            if stale is not None:
                self._stale = stale
        telemetry.gauge("recovery_state").set(float(_STATE_CODE[state]))

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def health(self) -> dict:
        """The ``/healthz`` payload: readiness state + staleness flag.

        ``ready`` (and HTTP 200) only in the *serving* state; a
        replaying process answers 503 with ``stale: true`` so load
        balancers keep traffic away while operators can still see a
        live, progressing boot.
        """
        with self._lock:
            state, stale, replayed = self._state, self._stale, self._replayed
        graph = self.graph
        out = {
            "state": state,
            "ready": state == "serving",
            "stale": stale,
            "managed": True,
            "replayed_records": replayed,
        }
        if graph is not None:
            out["graph_version"] = int(graph.version)
        if self.wal is not None:
            out["wal_next_lsn"] = self.wal.next_lsn
        if self._boot_seconds is not None:
            out["boot_seconds"] = self._boot_seconds
        return out

    # -- boot ----------------------------------------------------------
    def boot_degraded(self):
        """Restore the newest checkpoint (or build fresh) and open the
        WAL; returns the graph, *servable but stale*, in state
        ``replaying``.  Call :meth:`finish_boot` to fold in the log tail
        and reach ``serving``."""
        from ..config import get_config

        cfg = get_config()
        self._boot_t0 = time.perf_counter()
        self._set_state("booting", stale=True)
        if cfg.recovery_cache_dir:
            # the kernel and native libraries build into (and are found
            # in) this directory: the port's persistent compile cache
            from .registry import get_program_registry

            get_program_registry().enable_persistent_cache(
                cfg.recovery_cache_dir)
        os.makedirs(self.wal_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        ckpt = load_checkpoint(self.ckpt_dir)
        if ckpt is not None:
            graph = restore_graph(ckpt, delta_capacity=self.delta_capacity,
                                  device=self.device)
            self._replay_from = ckpt.wal_lsn
            log.info("restored checkpoint %s (graph version %d, "
                     "wal watermark %d)", ckpt.path, ckpt.graph_version,
                     ckpt.wal_lsn)
        elif self.graph_factory is not None:
            graph = self.graph_factory()
            self._replay_from = -1
        else:
            raise RecoveryError(
                f"no checkpoint under {self.ckpt_dir} and no graph_factory "
                "to build a fresh graph from")
        # quiverlint: ignore[QT008] -- set exactly once here, before the
        # checkpointer thread can exist; read-only references afterwards
        self.wal = WriteAheadLog(self.wal_dir, **self._wal_kwargs)
        self.graph = graph  # quiverlint: ignore[QT008] -- same: boot-once
        with self._lock:
            self._ckpt = ckpt
        self._set_state("replaying", stale=True)
        return graph

    def finish_boot(self, warmup: Optional[Callable] = None,
                    seal: bool = False) -> int:
        """Replay the WAL tail, warm, and flip to ``serving``.

        ``warmup`` (optional) runs with the recovered graph between
        replay and serving — the place to build the kernel libraries and
        the sampler's pipeline entries.  With
        ``seal=True`` the program registry is sealed afterwards, so a
        warm boot that still compiles past its retrace budget fails
        loudly.  Returns the number of records replayed.
        """
        from ..config import get_config
        from ..stream.compactor import compact

        if self.wal is None or self.graph is None:
            raise RecoveryError("finish_boot before boot_degraded")
        cfg = get_config()
        deadline_s = float(cfg.recovery_deadline_s)
        t0 = time.perf_counter()
        replayed = skipped = 0

        def _check_deadline() -> None:
            if deadline_s > 0 and (time.perf_counter()
                                   - self._boot_t0) > deadline_s:
                telemetry.counter("recovery_deadline_exceeded_total").inc()
                raise RecoveryDeadlineExceeded(
                    f"replay still running after {deadline_s:.1f}s "
                    f"({replayed} records in); raise "
                    "recovery_deadline_s or checkpoint more often")

        # Two passes over the tail: an abort record lands AFTER the
        # record it cancels, so the abort set must be complete before
        # anything is folded in.  Buffering the tail is fine — it only
        # spans back to the last checkpoint watermark.
        tail = []
        aborted = set()
        for lsn, payload in self.wal.replay():
            if lsn <= self._replay_from:
                continue
            _check_deadline()
            target = decode_abort(payload)
            if target is not None:
                aborted.add(target)
                continue
            tail.append((lsn, payload))
        for lsn, payload in tail:
            _check_deadline()
            if lsn in aborted:
                # durable but nacked live (apply failed after the
                # append): the rejected mutation must not resurrect
                telemetry.counter("recovery_replay_aborted_total").inc()
                continue
            try:
                op, src, dst, ts = decode_edge_op(payload)
            except WALError as e:
                # a verified-checksum record that doesn't decode is a
                # producer bug, not a torn write — skip it loudly
                log.warning("undecodable WAL record at lsn %d: %s", lsn, e)
                skipped += 1
                continue
            self._apply_replayed(op, src, dst, ts, compact)
            replayed += 1
        elapsed = time.perf_counter() - t0
        if replayed:
            telemetry.counter("recovery_replay_records_total").inc(replayed)
        if skipped:
            telemetry.counter("recovery_replay_skipped_total").inc(skipped)
        telemetry.gauge("recovery_replay_seconds").set(elapsed)
        with self._lock:
            self._replayed = replayed
        self._set_state("warming", stale=False)
        if warmup is not None:
            warmup(self.graph)
        if seal:
            from .registry import get_program_registry

            get_program_registry().seal()
        self._boot_seconds = time.perf_counter() - self._boot_t0
        telemetry.gauge("recovery_boot_seconds").set(self._boot_seconds)
        self._set_state("serving", stale=False)
        return replayed

    def boot(self, warmup: Optional[Callable] = None, seal: bool = False):
        """``boot_degraded()`` + ``finish_boot()``; returns the graph."""
        graph = self.boot_degraded()
        self.finish_boot(warmup=warmup, seal=seal)
        return graph

    def adopt(self, graph, applied_lsn: int,
              warmup: Optional[Callable] = None, seal: bool = False) -> int:
        """Promotion boot: take ownership of a WAL this process has been
        *following*, not writing.

        A promoted follower already holds a nearly-current graph (the
        shipped tail folded through ``applied_lsn``), so re-restoring
        the checkpoint would throw that warmth away.  Opening the log is
        the ownership handover — :class:`WriteAheadLog` resumes the
        append cursor and clears the dead leader's torn tail exactly as
        a same-process restart would — then only the records *past* the
        follower's applied watermark are folded, abort-aware (two
        passes, same as :meth:`finish_boot`).

        One divergence is unrecoverable by folding: an abort whose
        target is ``<= applied_lsn`` means the dead leader nacked a
        record this follower already applied (a late abort that crossed
        the failover).  Un-applying is not a graph operation, so that
        path falls back to a full checkpoint boot — correctness over
        warmth, and ``recovery_adopt_fallbacks_total`` says it
        happened.  Either way the manager lands on ``serving``; the
        caller re-reads ``self.graph`` (the fallback replaces it).
        Returns the number of records folded/replayed.
        """
        from ..stream.compactor import compact

        self._boot_t0 = time.perf_counter()
        self._set_state("booting", stale=True)
        os.makedirs(self.wal_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        wal = WriteAheadLog(self.wal_dir, **self._wal_kwargs)
        applied_lsn = int(applied_lsn)
        tail = []
        aborted = set()
        late_abort = None
        for lsn, payload in wal.replay():
            target = decode_abort(payload)
            if target is not None:
                if target <= applied_lsn:
                    late_abort = (lsn, target)
                    break
                aborted.add(target)
                continue
            if lsn <= applied_lsn:
                continue
            tail.append((lsn, payload))
        if late_abort is not None:
            telemetry.counter("recovery_adopt_fallbacks_total").inc()
            log.warning(
                "late abort at lsn %d targets already-applied lsn %d; "
                "adopted graph is ahead of the durable log — falling "
                "back to checkpoint boot", *late_abort)
            wal.close()
            self.boot_degraded()
            return self.finish_boot(warmup=warmup, seal=seal)
        # the promotion handover: set once here, before any lane or
        # checkpointer exists for this manager
        self.wal = wal
        self.graph = graph
        with self._lock:
            self._ckpt = load_checkpoint(self.ckpt_dir)
        self._set_state("replaying", stale=True)
        replayed = skipped = 0
        for lsn, payload in tail:
            if lsn in aborted:
                telemetry.counter("recovery_replay_aborted_total").inc()
                continue
            try:
                op, src, dst, ts = decode_edge_op(payload)
            except WALError as e:
                log.warning("undecodable WAL record at lsn %d: %s", lsn, e)
                skipped += 1
                continue
            self._apply_replayed(op, src, dst, ts, compact)
            replayed += 1
        if replayed:
            telemetry.counter("recovery_replay_records_total").inc(replayed)
        if skipped:
            telemetry.counter("recovery_replay_skipped_total").inc(skipped)
        with self._lock:
            self._replayed = replayed
        self._set_state("warming", stale=False)
        if warmup is not None:
            warmup(self.graph)
        if seal:
            from .registry import get_program_registry

            get_program_registry().seal()
        self._boot_seconds = time.perf_counter() - self._boot_t0
        telemetry.gauge("recovery_boot_seconds").set(self._boot_seconds)
        self._set_state("serving", stale=False)
        return replayed

    def _apply_replayed(self, op, src, dst, ts, compact) -> None:
        graph = self.graph
        if op == "add":
            try:
                graph.add_edges(src, dst, ts if graph.has_ts else None)
            except BufferError:
                compact(graph)  # same fold-then-retry as the live lane
                graph.add_edges(src, dst, ts if graph.has_ts else None)
        elif op == "remove":
            graph.remove_edges(src, dst)

    # -- attachment ----------------------------------------------------
    def attach_lane(self, lane) -> None:
        """Wire an IngestLane into the durability path: its worker
        appends to this WAL before applying (durable-before-ack) and
        executes this manager's checkpoints as barriers."""
        if self.wal is None:
            raise RecoveryError("attach_lane before boot_degraded")
        lane.wal = self.wal
        lane.checkpoint_fn = self._do_checkpoint
        with self._lock:
            self._lane = lane

    def attach_feature(self, name: str, feature) -> int:
        """Register a feature store for coldcache snapshot/restore.

        If the boot checkpoint carried overlay state under ``name``, it
        is restored now (best-effort: a shape/capacity mismatch logs
        and leaves the overlay cold — staleness of a *cache* is a perf
        regression, not a correctness loss).  Returns rows re-warmed.
        """
        with self._lock:
            self._features[str(name)] = feature
            ckpt = self._ckpt
        state = (ckpt.coldcaches.get(str(name))
                 if ckpt is not None else None)
        if state is None:
            return 0
        try:
            warmed = feature.restore_coldcache_state(state)
        except (ValueError, KeyError) as e:
            telemetry.counter(
                "recovery_coldcache_restore_errors_total").inc()
            log.warning("coldcache restore for %r failed (%s); "
                        "starting cold", name, e)
            return 0
        telemetry.counter("recovery_coldcache_rows_restored_total").inc(
            warmed)
        return warmed

    # -- checkpointing -------------------------------------------------
    def checkpoint(self, timeout: float = 60.0):
        """Take one consistent snapshot; returns its path.

        Routed through the attached lane's writer thread as a barrier
        when there is one (so it lands between applies, at that thread's
        exact ``_applied_lsn``); taken inline otherwise.
        """
        with self._lock:
            lane = self._lane
        if lane is not None and lane.is_running():
            barrier = lane.request_checkpoint()
            if not barrier.done.wait(timeout):
                raise RecoveryError(
                    f"checkpoint barrier not executed within {timeout}s "
                    "(ingest worker wedged?)")
            if barrier.error is not None:
                raise barrier.error
            return barrier.result
        wal_lsn = self.wal.last_lsn if self.wal is not None else -1
        return self._do_checkpoint(wal_lsn)

    def _do_checkpoint(self, wal_lsn: int):
        if self.graph is None:
            raise RecoveryError("checkpoint before boot")
        if self.wal is not None:
            self.wal.roll()
        with self._lock:
            features = dict(self._features)
        coldcaches = {}
        for name, feat in features.items():
            try:
                coldcaches[name] = feat.export_coldcache_state()
            except Exception as e:
                telemetry.counter(
                    "recovery_coldcache_export_errors_total").inc()
                log.warning("coldcache export for %r failed: %s", name, e)
        path = save_checkpoint(self.ckpt_dir, self.graph,
                               coldcaches=coldcaches, wal_lsn=wal_lsn)
        if self.wal is not None:
            self.wal.truncate_through(wal_lsn)
        return path

    def start_checkpointer(self,
                           interval_s: Optional[float] = None) -> None:
        """Periodic checkpoints on a daemon thread (default interval
        ``config.recovery_checkpoint_interval_s``)."""
        from ..config import get_config

        if self._ckpt_thread is not None:
            return
        interval = float(interval_s if interval_s is not None
                         else get_config().recovery_checkpoint_interval_s)
        self._ckpt_wake.clear()

        def _loop():
            while not self._ckpt_wake.wait(interval):
                try:
                    self.checkpoint()
                except Exception as e:
                    # a failed periodic snapshot costs replay time, not
                    # data — log it and keep the cadence
                    telemetry.counter(
                        "recovery_checkpoint_errors_total").inc()
                    log.warning("periodic checkpoint failed: %s", e)

        self._ckpt_thread = threading.Thread(
            target=_loop, daemon=True, name="quiver-recovery-ckpt")
        self._ckpt_thread.start()

    def stop_checkpointer(self, timeout: float = 5.0) -> None:
        from ..resilience.shutdown import join_and_reap

        t = self._ckpt_thread
        if t is None:
            return
        self._ckpt_wake.set()
        self._ckpt_thread = None
        join_and_reap([t], timeout, component="recovery.checkpointer")

    def close(self) -> None:
        """Stop the checkpointer and close the WAL (graph stays usable)."""
        self.stop_checkpointer()
        if self.wal is not None:
            self.wal.close()
        with _ACTIVE_LOCK:
            global _ACTIVE
            if _ACTIVE is not None and _ACTIVE() is self:
                _ACTIVE = None


# -- process-wide health surface (read by /healthz) -------------------------

_ACTIVE: Optional["weakref.ref[RecoveryManager]"] = None
_ACTIVE_LOCK = threading.Lock()


def set_active(manager: Optional[RecoveryManager]) -> None:
    """Make ``manager`` the one ``/healthz`` reports on (held weakly —
    a dropped manager reverts the endpoint to unmanaged)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = weakref.ref(manager) if manager is not None else None


def health_status() -> dict:
    """The process's readiness document.

    Unmanaged processes (no RecoveryManager constructed — every
    deployment predating this tier) report ``serving``/ready, so
    adding the endpoint never takes a healthy legacy deployment out of
    rotation.
    """
    with _ACTIVE_LOCK:
        ref = _ACTIVE
    mgr = ref() if ref is not None else None
    if mgr is None:
        return {"state": "serving", "ready": True, "stale": False,
                "managed": False}
    return mgr.health()
