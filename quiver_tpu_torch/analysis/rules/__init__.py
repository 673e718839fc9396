"""quiverlint rule registry — one module per rule, ordered by code."""

from __future__ import annotations

import hashlib
import inspect
from typing import Dict, List

from ..core import Rule
from .qt001_host_sync import HostSyncRule
from .qt002_retrace import RetraceRule
from .qt003_locks import LockDisciplineRule
from .qt004_layering import ImportLayeringRule
from .qt005_hygiene import HygieneRule
from .qt006_metric_names import MetricNameRule
from .qt007_silent_except import SilentExceptRule
from .qt008_races import DataRaceRule
from .qt009_lock_order import LockOrderRule
from .qt010_thread_reap import ThreadReapRule
from .qt011_durability import DurabilityRule
from .qt012_wall_clock import WallClockRule
from .qt013_staging_sync import InterproceduralHostSyncRule
from .qt014_cache_keys import UnboundedExecutableKeyRule
from .qt015_collectives import CollectiveDisciplineRule

__all__ = ["all_rules", "rule_fingerprints", "RULE_CLASSES"]

RULE_CLASSES = (HostSyncRule, RetraceRule, LockDisciplineRule,
                ImportLayeringRule, HygieneRule, MetricNameRule,
                SilentExceptRule, DataRaceRule, LockOrderRule,
                ThreadReapRule, DurabilityRule, WallClockRule,
                InterproceduralHostSyncRule, UnboundedExecutableKeyRule,
                CollectiveDisciplineRule)


def all_rules() -> List[Rule]:
    return [cls() for cls in RULE_CLASSES]


_FINGERPRINTS: Dict[str, str] = {}


def rule_fingerprints() -> Dict[str, str]:
    """rule code -> short hash of the rule's *implementation source*.

    Stamped into the baseline (v2) so that editing a rule's logic
    invalidates its accepted entries: a finding grandfathered under the
    old detector must be re-justified once the detector changes,
    instead of a stale fingerprint silently absorbing whatever the new
    logic reports (see ``baseline.py`` and ``--strict-baseline``).
    Source hashing deliberately includes docstrings/comments: a rule
    edit is a rule edit.
    """
    if not _FINGERPRINTS:
        for cls in RULE_CLASSES:
            src = inspect.getsource(inspect.getmodule(cls))
            digest = hashlib.blake2b(src.encode("utf-8"),
                                     digest_size=8).hexdigest()
            _FINGERPRINTS[cls.code] = digest
    return dict(_FINGERPRINTS)
