"""quiverlint baseline — accepted pre-existing findings, committed to git.

The baseline is a multiset of finding fingerprints ``(rule, path, scope,
snippet)``.  Line numbers are deliberately excluded so edits elsewhere
in a file don't churn the baseline; moving or editing the flagged line
itself *does* invalidate the entry, which is the behavior you want — a
touched finding must be re-justified (fix it, suppress it inline, or
re-record the baseline).

Since v2 every entry also carries ``rule_hash``, a digest of the
emitting rule's implementation source (:func:`..rules.rule_fingerprints`).
Editing a rule's logic therefore invalidates its accepted entries under
``--strict-baseline``: the old entry was a judgment about what the *old*
detector reported, and letting it ride silently absorbs whatever the new
logic finds at the same fingerprint.  v1 baselines (no hashes) still
load; their entries simply carry no hash and are exempt from the check,
so the upgrade path is "re-record when convenient, strict once you do".

Workflow::

    python -m quiver_tpu_torch.analysis quiver_tpu_torch --write-baseline
    git add quiverlint_torch.baseline.json

CI then runs the linter normally: findings matching the baseline are
reported as "baselined" and don't affect the exit code; anything new
fails the run (see ``tests/test_torch_lint_clean.py``).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding

__all__ = ["DEFAULT_BASELINE_NAME", "load", "load_entries", "save",
           "partition", "stale", "hash_mismatches"]

DEFAULT_BASELINE_NAME = "quiverlint_torch.baseline.json"
_VERSION = 2
_ACCEPTED_VERSIONS = (1, 2)


def save(path, findings: Sequence[Finding]) -> None:
    from .rules import rule_fingerprints

    hashes = rule_fingerprints()
    entries = []
    for f in sorted(findings, key=lambda x: (x.path, x.line, x.rule)):
        d = f.to_dict()
        h = hashes.get(f.rule)
        if h:
            d["rule_hash"] = h
        entries.append(d)
    doc = {
        "version": _VERSION,
        "tool": "quiverlint",
        "findings": entries,
    }
    Path(path).write_text(json.dumps(doc, indent=2) + "\n")


def load_entries(path) -> List[Tuple[Finding, Optional[str]]]:
    """(finding, recorded rule hash or None) per baseline entry."""
    doc = json.loads(Path(path).read_text())
    if doc.get("version") not in _ACCEPTED_VERSIONS:
        raise ValueError(
            f"baseline {path}: unsupported version {doc.get('version')!r}")
    return [(Finding.from_dict(d), d.get("rule_hash"))
            for d in doc.get("findings", [])]


def load(path) -> List[Finding]:
    return [f for f, _ in load_entries(path)]


def hash_mismatches(entries: Sequence[Tuple[Finding, Optional[str]]],
                    current: Dict[str, str],
                    ) -> List[Tuple[Finding, str, str]]:
    """Entries recorded under a different rule implementation.

    Returns (finding, recorded hash, current hash) triples; entries
    with no recorded hash (v1 baselines) are exempt.  Under
    ``--strict-baseline`` any mismatch fails the run: the accepted debt
    was a judgment about the *old* detector and must be re-recorded
    (or fixed) now that the logic changed.
    """
    out: List[Tuple[Finding, str, str]] = []
    for f, h in entries:
        cur = current.get(f.rule)
        if h is not None and cur is not None and h != cur:
            out.append((f, h, cur))
    return out


def partition(findings: Sequence[Finding],
              baseline: Sequence[Finding],
              ) -> Tuple[List[Finding], List[Finding]]:
    """Split ``findings`` into (new, baselined) by multiset fingerprint
    match — two identical snippets in one scope need two baseline
    entries, so a *second* copy of an accepted violation still fails."""
    budget = Counter(f.fingerprint() for f in baseline)
    new: List[Finding] = []
    known: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            known.append(f)
        else:
            new.append(f)
    return new, known


def stale(findings: Sequence[Finding],
          baseline: Sequence[Finding]) -> List[Finding]:
    """Baseline entries no longer matched by any current finding.

    A stale entry is accepted debt that has since been fixed (or the
    flagged line rewritten) without the baseline being re-recorded —
    harmless until someone reintroduces the same violation and the dead
    entry silently absorbs it.  ``--strict-baseline`` fails on these;
    multiset semantics mirror :func:`partition` (two identical accepted
    entries need two current findings to both stay live).
    """
    remaining = Counter(f.fingerprint() for f in baseline)
    for f in findings:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
    out: List[Finding] = []
    claimed: Counter = Counter()
    for b in baseline:
        fp = b.fingerprint()
        if claimed[fp] < remaining.get(fp, 0):
            claimed[fp] += 1
            out.append(b)
    return out
