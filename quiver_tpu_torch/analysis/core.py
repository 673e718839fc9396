"""quiverlint core — findings, config, module context, suppressions, engine.

The data layer's performance contract is structural: hot loops must not
sync with the card (QT001), compiled functions and kernel builds must not
repeat per call (QT002), shared state must stay under its declared lock
(QT003), hot modules must not grow import-time dependencies on the
exporter stack (QT004), and library code must stay free of the Python
footguns that turn into silent serving bugs (QT005).  QT006-QT012 hold
metric names, exception handling, the whole-program concurrency model,
durable writes and clocks; QT013-QT015 read the staging dataflow (a
card value coerced across function boundaries, executable-cache keys,
collective discipline).  Telemetry *observes* violations after the
fact; this package *rejects* them at lint time.

Everything here is stdlib-only AST analysis: the linter itself must be
cheap enough to run in CI on every change and must never need a device
(or even torch) to execute its rules.

Suppression syntax (same line, or a comment-only line directly above)::

    torch.cuda.synchronize()  # quiverlint: ignore[QT001] -- timing probe

Baseline workflow: ``python -m quiver_tpu_torch.analysis --write-baseline``
records the current findings; later runs report only findings whose
fingerprint is not in the baseline, so pre-existing debt never blocks CI
while every *new* finding fails it (see :mod:`.baseline`).
"""

from __future__ import annotations

import ast
import fnmatch
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "LintConfig", "LintResult", "ModuleContext", "ProgramRule",
    "Rule", "analyze_paths", "dotted_call_name", "iter_py_files",
    "load_contexts",
]

_SUPPRESS_RE = re.compile(r"#\s*quiverlint:\s*ignore\[([A-Za-z0-9_,\s]+)\]")
# QT013's audited waiver: a *sync* that is part of the design (response
# leaving the process, bench checksum).  Unlike ignore[...], sync-ok is
# tracked — a waiver suppressing nothing is stale and fails
# --strict-baseline, so boundary declarations can't outlive the sync.
_SYNC_OK_RE = re.compile(r"#\s*quiverlint:\s*sync-ok\[([^\]]*)\]")

MODULE_SCOPE = "<module>"


@dataclass(frozen=True)
class Finding:
    """One rule violation, addressed stably by (rule, path, scope, snippet).

    Line/column are carried for display but excluded from the fingerprint
    so unrelated edits above a finding don't invalidate the baseline.
    """

    rule: str
    path: str        # posix path relative to the lint root
    line: int
    col: int
    scope: str       # innermost enclosing def/class qualname, or <module>
    message: str
    snippet: str     # stripped source of the flagged line

    def fingerprint(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.snippet)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "scope": self.scope, "message": self.message,
            "snippet": self.snippet,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(rule=d["rule"], path=d["path"], line=int(d.get("line", 0)),
                   col=int(d.get("col", 0)),
                   scope=d.get("scope", MODULE_SCOPE),
                   message=d.get("message", ""), snippet=d.get("snippet", ""))

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        return f"{loc}: {self.rule} [{self.scope}] {self.message}"


# Default hot-module set: the sampling -> gather -> serve pipeline, where
# a host round-trip is a per-batch tax (GNNSampler / SALIENT's dominant
# cost); ``ops/cuda`` holds the kernel wrappers and ``utils/staging.py``
# the pinned buffers every budgeted lookup reuses.  Patterns are
# fnmatch'd against the posix relpath.
_DEFAULT_HOT = (
    "quiver_tpu_torch/sampler.py",
    "quiver_tpu_torch/feature.py",
    "quiver_tpu_torch/uva.py",
    "quiver_tpu_torch/mixed.py",
    "quiver_tpu_torch/serving.py",
    "quiver_tpu_torch/neighbour_num.py",
    "quiver_tpu_torch/ops/*.py",
    "quiver_tpu_torch/ops/cuda/*.py",
    "quiver_tpu_torch/parallel/*.py",
    "quiver_tpu_torch/resilience/*.py",
    "quiver_tpu_torch/stream/*.py",
    "quiver_tpu_torch/recovery/*.py",
    "quiver_tpu_torch/fleet/*.py",
    "quiver_tpu_torch/mesh/*.py",
    "quiver_tpu_torch/utils/staging.py",
)


@dataclass
class LintConfig:
    """Knobs shared by all rules; tests swap in fixture-scoped configs."""

    hot_modules: Tuple[str, ...] = _DEFAULT_HOT
    # QT004: modules that must never be imported at module level from
    # library code (the exporter pulls in http.server; hot paths opt in
    # at call time via expose_metrics()).
    layering_forbidden: Tuple[str, ...] = (
        "quiver_tpu_torch.telemetry.export", "http.server",
    )
    layering_exempt: Tuple[str, ...] = (
        "quiver_tpu_torch/telemetry/export.py",
        "quiver_tpu_torch/analysis/*",
    )
    # QT011: files whose persisted bytes must flow through the blessed
    # durable-IO helpers, and the helper module itself (the one place
    # raw writes are allowed to live).
    durability_scope: Tuple[str, ...] = ("quiver_tpu_torch/recovery/*.py",)
    durability_exempt: Tuple[str, ...] = (
        "quiver_tpu_torch/recovery/blockio.py",)
    # QT014: extra bucket-helper function names (beyond the built-in
    # pow2/quarter-octave set) whose results count as bounded key
    # components.
    bucket_helpers: Tuple[str, ...] = ()
    # QT015: modules whose psum operands must be provably integer (the
    # bit-exact halo-combine contract of the mesh tier).
    bitexact_modules: Tuple[str, ...] = ("quiver_tpu_torch/mesh/*.py",)
    # rule codes to run; None = every registered rule
    rules: Optional[Tuple[str, ...]] = None
    exclude: Tuple[str, ...] = ("*/.*", "*/__pycache__/*")

    def want_rule(self, code: str) -> bool:
        return self.rules is None or code in self.rules


class ModuleContext:
    """Parsed view of one file handed to every rule."""

    def __init__(self, path: Path, relpath: str, source: str,
                 config: LintConfig):
        self.path = path
        self.relpath = relpath
        self.config = config
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.module = _dotted_module(relpath)
        self.scopes: Dict[int, str] = {}
        _map_scopes(self.tree, "", self.scopes)
        self.functions: List[Tuple[str, ast.AST]] = []
        _collect_functions(self.tree, "", self.functions)

    # -- helpers used by the rules ------------------------------------
    def is_hot(self) -> bool:
        return _match_any(self.relpath, self.config.hot_modules)

    def scope_of(self, node: ast.AST) -> str:
        return self.scopes.get(id(node), MODULE_SCOPE) or MODULE_SCOPE

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str,
                scope: Optional[str] = None) -> Finding:
        return Finding(
            rule=rule, path=self.relpath, line=node.lineno,
            col=node.col_offset, scope=scope or self.scope_of(node),
            message=message, snippet=self.snippet(node.lineno),
        )

    def suppressions(self) -> Dict[int, Set[str]]:
        """line number -> set of suppressed rule codes ('*' = all)."""
        out: Dict[int, Set[str]] = {}
        for i, raw in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(raw)
            if not m:
                continue
            codes = {c.strip().upper() for c in m.group(1).split(",")
                     if c.strip()}
            out.setdefault(i, set()).update(codes)
            if raw.strip().startswith("#"):
                # comment-only line: covers the next non-comment line, so
                # an ignore may sit atop a multi-line justification block
                j = i + 1
                while (j <= len(self.lines)
                       and self.lines[j - 1].strip().startswith("#")):
                    j += 1
                out.setdefault(j, set()).update(codes)
        return out

    def sync_ok(self) -> Dict[int, Tuple[int, str]]:
        """effective line -> (declaration line, reason) for QT013
        ``sync-ok[...]`` waivers.

        Same placement rules as suppressions: same line, or a
        comment-only line directly above (which then covers the next
        non-comment line).  The declaration line identifies the waiver
        for the staleness audit — one comment may register under two
        effective lines but is one declaration."""
        out: Dict[int, Tuple[int, str]] = {}
        # tokenize (not a line scan) so docstrings and message strings
        # may *show* the directive without registering a waiver — the
        # staleness audit would otherwise flag them forever
        comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = dict(enumerate(self.lines, start=1))
        for i in sorted(comments):
            m = _SYNC_OK_RE.search(comments[i])
            if not m:
                continue
            reason = m.group(1).strip()
            out.setdefault(i, (i, reason))
            if self.lines[i - 1].strip().startswith("#"):
                j = i + 1
                while (j <= len(self.lines)
                       and self.lines[j - 1].strip().startswith("#")):
                    j += 1
                out.setdefault(j, (i, reason))
        return out


class Rule:
    """Base class; subclasses set code/name/description and yield findings."""

    code = "QT000"
    name = "base"
    description = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError
        yield  # pragma: no cover


class ProgramRule(Rule):
    """A rule over the *whole* analyzed program at once.

    Per-file rules see one :class:`ModuleContext`; concurrency
    properties (QT008 races, QT009 lock ordering, QT010 thread reaping)
    need the interprocedural call graph spanning every file.  The
    engine collects all contexts first, then runs each program rule's
    :meth:`check_program` once.  Findings flow through the same
    suppression / baseline machinery, keyed by the file each finding
    lands in.
    """

    program = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        return iter(())

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        raise NotImplementedError
        yield  # pragma: no cover


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    files: int = 0
    # sync-ok waivers that suppressed nothing this run: (path, line,
    # reason).  Only populated when QT013 actually ran; --strict-baseline
    # fails on them.
    stale_sync_ok: List[Tuple[str, int, str]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# shared AST helpers


def dotted_call_name(func: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for an Attribute/Name chain, else None."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _dotted_module(relpath: str) -> str:
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _match_any(relpath: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(relpath, pat) for pat in patterns)


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _map_scopes(node: ast.AST, qual: str, out: Dict[int, str]) -> None:
    """Record, for every node, the qualname of its innermost enclosing
    def/class (the node's *own* name excluded — a def's finding scope is
    where the def lives; its body's scope includes it)."""
    for child in ast.iter_child_nodes(node):
        out[id(child)] = qual or MODULE_SCOPE
        if isinstance(child, _SCOPE_NODES):
            inner = f"{qual}.{child.name}" if qual else child.name
            _map_scopes(child, inner, out)
        else:
            _map_scopes(child, qual, out)


def _collect_functions(node: ast.AST, qual: str,
                       out: List[Tuple[str, ast.AST]]) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            q = f"{qual}.{child.name}" if qual else child.name
            out.append((q, child))
            _collect_functions(child, q, out)
        elif isinstance(child, ast.ClassDef):
            q = f"{qual}.{child.name}" if qual else child.name
            _collect_functions(child, q, out)
        else:
            _collect_functions(child, qual, out)


# ---------------------------------------------------------------------------
# engine


def iter_py_files(paths: Sequence, root: Path,
                  config: LintConfig) -> Iterator[Path]:
    seen = set()
    for p in paths:
        p = Path(p)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            candidates = sorted(p.rglob("*.py"))
        else:
            candidates = [p]
        for f in candidates:
            rel = _relpath(f, root)
            if _match_any(rel, config.exclude) or f in seen:
                continue
            seen.add(f)
            yield f


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def load_contexts(paths: Sequence, config: Optional[LintConfig] = None,
                  root: Optional[Path] = None) -> List[ModuleContext]:
    """Parse ``paths`` into :class:`ModuleContext` objects without running
    any rules — the entry point for consumers that want the program model
    alone (e.g. the lock-witness harness seeding the canonical order)."""
    config = config or LintConfig()
    root = Path(root) if root is not None else Path.cwd()
    out: List[ModuleContext] = []
    for f in iter_py_files(paths, root, config):
        try:
            out.append(ModuleContext(f, _relpath(f, root), f.read_text(),
                                     config))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
    return out


def analyze_paths(paths: Sequence, config: Optional[LintConfig] = None,
                  root: Optional[Path] = None) -> LintResult:
    """Run every (selected) rule over ``paths``; returns raw + suppressed
    findings.  Baseline filtering is layered on top by the CLI / tests —
    see :func:`quiver_tpu_torch.analysis.baseline.partition`."""
    from .rules import all_rules

    config = config or LintConfig()
    root = Path(root) if root is not None else Path.cwd()
    selected = [r for r in all_rules() if config.want_rule(r.code)]
    rules = [r for r in selected if not getattr(r, "program", False)]
    program_rules = [r for r in selected if getattr(r, "program", False)]
    result = LintResult()
    contexts: List[ModuleContext] = []
    sups: Dict[str, Dict[int, Set[str]]] = {}
    syncoks: Dict[str, Dict[int, str]] = {}
    for f in iter_py_files(paths, root, config):
        try:
            ctx = ModuleContext(f, _relpath(f, root), f.read_text(), config)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            result.errors.append(f"{f}: {e}")
            continue
        result.files += 1
        sup = ctx.suppressions()
        contexts.append(ctx)
        sups[ctx.relpath] = sup
        syncoks[ctx.relpath] = ctx.sync_ok()
        for rule in rules:
            for finding in rule.check(ctx):
                codes = sup.get(finding.line, ())
                if finding.rule.upper() in codes or "*" in codes:
                    result.suppressed.append(finding)
                else:
                    result.findings.append(finding)
    if program_rules and contexts:
        # one parse, one program model: every program rule (QT008-010
        # concurrency, QT013-015 staging) reads the same memoized
        # Program / Dataflow built over this exact context list.
        from .concurrency import build_program

        build_program(contexts)
    sync_ok_used: Set[Tuple[str, int]] = set()   # (path, declaration line)
    for rule in program_rules:
        for finding in rule.check_program(contexts):
            codes = sups.get(finding.path, {}).get(finding.line, ())
            decl = syncoks.get(finding.path, {}).get(finding.line)
            if finding.rule.upper() in codes or "*" in codes:
                result.suppressed.append(finding)
            elif finding.rule.upper() == "QT013" and decl is not None:
                sync_ok_used.add((finding.path, decl[0]))
                result.suppressed.append(finding)
            else:
                result.findings.append(finding)
    if any(r.code == "QT013" for r in program_rules):
        for path in sorted(syncoks):
            decls = {(dline, reason)
                     for dline, reason in syncoks[path].values()}
            for dline, reason in sorted(decls):
                if (path, dline) not in sync_ok_used:
                    result.stale_sync_ok.append((path, dline, reason))
    result.findings.sort(key=lambda x: (x.path, x.line, x.rule))
    result.suppressed.sort(key=lambda x: (x.path, x.line, x.rule))
    return result
