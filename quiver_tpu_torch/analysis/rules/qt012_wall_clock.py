"""QT012 — wall-clock duration measurement in a hot path.

``time.time()`` is the WALL clock: NTP slews and steps it, a suspended
VM jumps it, and leap-second smears bend it — a duration computed from
it can come out negative or wildly wrong, and those durations feed the
latency histograms, the QoS ladder's burn rates, and the perf gate.
Durations in hot modules must come from ``time.perf_counter()`` (or
``time.monotonic()`` for coarse deadlines).

``time.time()`` stays legitimate as a *timestamp* (log records,
``t_wall`` fields, absolute deadlines built by addition): the rule
flags only its use in a subtraction — the duration idiom — either
directly (``time.time() - t0``) or through a name assigned from it in
the same function (``t0 = time.time(); ...; now - t0``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..core import Finding, ModuleContext, Rule, dotted_call_name

_WALL_CALLS = {"time.time"}


def _imports_bare_time(tree: ast.AST) -> bool:
    """True when ``from time import time`` is in scope, so a bare
    ``time()`` call is the wall clock too."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time" and alias.asname is None:
                    return True
    return False


def _is_wall_call(node: ast.AST, bare: bool) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_call_name(node.func)
    return name in _WALL_CALLS or (bare and name == "time")


def _wall_names(fn: ast.AST, bare: bool) -> Set[str]:
    """Names assigned (directly) from a wall-clock call in ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_wall_call(node.value, bare):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class WallClockRule(Rule):
    code = "QT012"
    name = "wall-clock-in-hot-path"
    description = ("time.time() used to measure a duration in a hot "
                   "module (use time.perf_counter())")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.is_hot():
            return
        bare = _imports_bare_time(ctx.tree)
        seen: Set[int] = set()  # nested defs appear under two quals
        for qual, fn in ctx.functions:
            names = None  # computed lazily: most functions are clean
            for node in ast.walk(fn):
                if (not isinstance(node, ast.BinOp)
                        or not isinstance(node.op, ast.Sub)
                        or id(node) in seen):
                    continue
                sides = (node.left, node.right)
                direct = any(_is_wall_call(s, bare) for s in sides)
                if not direct:
                    if names is None:
                        names = _wall_names(fn, bare)
                    if not any(isinstance(s, ast.Name) and s.id in names
                               for s in sides):
                        continue
                seen.add(id(node))
                yield ctx.finding(
                    self.code, node,
                    "duration computed from the wall clock "
                    "(`time.time()` subtraction); use "
                    "`time.perf_counter()` — NTP steps make this "
                    "negative or wrong, and it feeds latency metrics",
                    scope=qual)
