"""Typed recovery failures (a copy of ``quiver_tpu/recovery/errors.py``).

Mirrors the resilience error tree (``resilience/errors.py``): every
durability failure surfaces as a :class:`RecoveryError` subclass so
callers can catch the whole family — or one precise mode — without
string matching.  The contract the crash harness enforces: a
durability fault is *answered* (on the ingest ``results`` queue, or
raised from ``boot()``), never silently swallowed — silent loss is the
one failure mode a WAL exists to rule out.
"""

from __future__ import annotations

__all__ = [
    "RecoveryError", "WALError", "WALWriteError", "SnapshotFormatError",
    "CheckpointError", "RecoveryDeadlineExceeded", "RetraceBudgetExceeded",
]


class RecoveryError(RuntimeError):
    """Base class for every durability / warm-restart failure."""


class WALError(RecoveryError):
    """Write-ahead-log failure (framing, decode, or I/O)."""


class WALWriteError(WALError):
    """An append or fsync did not reach durable storage.

    This is the error answered on the submitting request: the edge op
    was NOT acknowledged and MUST NOT be assumed durable.
    """


class CheckpointError(RecoveryError):
    """A checkpoint could not be written or read back."""


class SnapshotFormatError(CheckpointError):
    """Version-skewed or corrupt snapshot: clean refusal, not a crash."""


class RecoveryDeadlineExceeded(RecoveryError):
    """Replay exceeded ``config.recovery_deadline_s``."""


class RetraceBudgetExceeded(RecoveryError):
    """A sealed program registry built more entries than its
    per-subsystem budget allows (a warm boot built something cold: a
    kernel library, a native library or a sampler entry)."""
