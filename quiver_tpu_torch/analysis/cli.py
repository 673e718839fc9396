"""quiverlint CLI — ``python -m quiver_tpu_torch.analysis [paths...]``.

Exit codes: 0 = clean (no unsuppressed, un-baselined findings),
1 = new findings, 2 = usage or internal error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from . import baseline as baseline_mod
from .core import LintConfig, analyze_paths
from .rules import all_rules

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.analysis",
        description="quiverlint: CUDA hot-path static analysis "
                    "(QT001 host sync, QT002 recompile and rebuild hazards, "
                    "QT003 lock discipline, QT004 import layering, QT005 "
                    "hygiene, QT006 metric names, QT007 silent except; "
                    "whole-program concurrency QT008-QT010; QT011 "
                    "durability, QT012 wall clock; staging dataflow QT013 "
                    "interprocedural sync, QT014 cache-key bounds, QT015 "
                    "collective discipline)",
    )
    p.add_argument("paths", nargs="*", default=["quiver_tpu_torch"],
                   help="files or directories to lint "
                        "(default: quiver_tpu_torch)")
    p.add_argument("--root", default=None,
                   help="directory findings are reported relative to "
                        "(default: CWD); baseline paths anchor here")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: <root>/"
                        f"{baseline_mod.DEFAULT_BASELINE_NAME} if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--strict-baseline", action="store_true",
                   help="also fail when the baseline holds stale entries "
                        "no longer reported (fixed debt must be removed "
                        "from the baseline, not left to absorb the next "
                        "regression), when a baseline entry was recorded "
                        "under a since-edited rule implementation "
                        "(rule-hash mismatch), or when a sync-ok waiver "
                        "no longer suppresses anything")
    p.add_argument("--report-only", action="store_true",
                   help="print findings but always exit 0 (except on "
                        "internal errors) — coverage mode for paths "
                        "outside the enforced set")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current findings as the accepted baseline "
                        "and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule codes to run "
                        "(e.g. QT001,QT003)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print suppressed findings (text format)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name}: {rule.description}")
        return 0

    root = Path(args.root).resolve() if args.root else Path.cwd()
    config = LintConfig()
    if args.rules:
        config.rules = tuple(
            c.strip().upper() for c in args.rules.split(",") if c.strip())

    result = analyze_paths(args.paths, config=config, root=root)
    for err in result.errors:
        print(f"quiverlint: error: {err}", file=sys.stderr)

    baseline_path = (Path(args.baseline) if args.baseline
                     else root / baseline_mod.DEFAULT_BASELINE_NAME)
    if args.write_baseline:
        baseline_mod.save(baseline_path, result.findings)
        print(f"quiverlint: wrote {len(result.findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    known = []
    new = result.findings
    stale = []
    mismatched = []
    if not args.no_baseline and baseline_path.exists():
        try:
            entries = baseline_mod.load_entries(baseline_path)
        except (ValueError, json.JSONDecodeError, OSError) as e:
            print(f"quiverlint: error: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        accepted = [f for f, _ in entries]
        new, known = baseline_mod.partition(result.findings, accepted)
        if args.strict_baseline:
            from .rules import rule_fingerprints

            stale = baseline_mod.stale(result.findings, accepted)
            mismatched = baseline_mod.hash_mismatches(
                entries, rule_fingerprints())
    stale_sync = result.stale_sync_ok if args.strict_baseline else []

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in known],
            "suppressed": [f.to_dict() for f in result.suppressed],
            "stale": [f.to_dict() for f in stale],
            "rule_hash_mismatch": [
                dict(f.to_dict(), recorded_hash=h, current_hash=cur)
                for f, h, cur in mismatched],
            "stale_sync_ok": [
                {"path": p, "line": ln, "reason": r}
                for p, ln, r in stale_sync],
            "files": result.files,
            "errors": result.errors,
        }, indent=2))
    else:
        for f in new:
            print(f.format())
            if f.snippet:
                print(f"    {f.snippet}")
        for f in stale:
            print(f"stale baseline entry (no longer reported): "
                  f"{f.rule} {f.path} [{f.scope}] {f.snippet!r}")
        for f, h, cur in mismatched:
            print(f"baseline entry recorded under edited rule logic: "
                  f"{f.rule} {f.path} [{f.scope}] (recorded {h}, "
                  f"current {cur}) — re-record the baseline")
        for p, ln, r in stale_sync:
            print(f"stale sync-ok waiver (suppresses nothing): "
                  f"{p}:{ln} [{r}]")
        if args.show_suppressed:
            for f in result.suppressed:
                print(f"suppressed: {f.format()}")
        print(f"quiverlint: {len(new)} new finding(s), "
              f"{len(known)} baselined, {len(result.suppressed)} "
              f"suppressed across {result.files} file(s)"
              + (f", {len(stale)} stale baseline entr"
                 f"{'y' if len(stale) == 1 else 'ies'}"
                 f", {len(mismatched)} rule-hash mismatch(es)"
                 f", {len(stale_sync)} stale sync-ok waiver(s)"
                 if args.strict_baseline else ""))

    if result.errors:
        return 2
    if args.report_only:
        return 0
    return 1 if (new or stale or mismatched or stale_sync) else 0
