"""QT010 — every discovered thread root must be reaped.

The runtime has `resilience.shutdown.join_and_reap`, which joins
worker threads against a shared deadline and ticks
``serving_thread_leak_total{component}`` for stragglers — but nothing
kept new thread roots honest about using it.  This rule closes the gap
between the static thread-root inventory (the same one QT008/QT009 use
for reachability) and that runtime metric:

* a ``threading.Thread(...)`` creation site is flagged unless its owner
  (the enclosing class, else the enclosing module) calls
  ``join_and_reap`` somewhere;
* a ``threading.Thread`` *subclass* is flagged at its ``class``
  statement under the same ownership test (its ``stop`` should reap
  itself: ``join_and_reap([self], ...)``);
* a ``pool.submit(...)`` owner passes by either calling
  ``join_and_reap`` or referencing ``shutdown`` (executor lifecycles
  are reaped by ``Executor.shutdown``); submitting to a pool received
  as a *parameter* is never flagged — a borrowed executor's worker
  lifecycle belongs to the caller that owns the pool.

Deliberate leaks (a daemon with process lifetime) are suppressed inline
with a justification: ``# quiverlint: ignore[QT010] -- <why>``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Sequence, Set

from ..concurrency import build_program
from ..concurrency.program import SpawnSite
from ..core import Finding, ModuleContext, ProgramRule


class ThreadReapRule(ProgramRule):
    code = "QT010"
    name = "unreaped-thread-root"
    description = ("thread roots must be joined via resilience.shutdown."
                   "join_and_reap (executors: .shutdown), or suppressed "
                   "with a justification")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        prog = build_program(ctxs)
        for spawn in sorted(
                prog.spawns,
                key=lambda s: (s.ctx.relpath,
                               getattr(s.node, "lineno", 0))):
            if spawn.borrowed:
                continue
            owner = (spawn.owner_class.node if spawn.owner_class is not None
                     else spawn.ctx.tree)
            refs = _referenced_names(owner)
            if "join_and_reap" in refs:
                continue
            if spawn.kind == "submit" and "shutdown" in refs:
                continue
            where = (spawn.owner_class.name if spawn.owner_class is not None
                     else spawn.ctx.module)
            if spawn.kind == "thread-subclass":
                msg = (f"`{where}` subclasses threading.Thread but never "
                       f"reaps itself via resilience.shutdown."
                       f"join_and_reap — leaked workers bypass "
                       f"serving_thread_leak_total")
            elif spawn.kind == "submit":
                msg = (f"executor work submitted in `{where}` with no "
                       f"join_and_reap/shutdown in scope — pool threads "
                       f"outlive the owner unreaped")
            else:
                msg = (f"thread spawned in `{where}` but join_and_reap "
                       f"is never called there — stop paths leak "
                       f"workers past serving_thread_leak_total")
            yield self._finding(spawn, msg)

    @staticmethod
    def _finding(spawn: SpawnSite, message: str) -> Finding:
        ctx = spawn.ctx
        node = spawn.node
        return Finding(
            rule=ThreadReapRule.code, path=ctx.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            scope=ctx.scope_of(node), message=message,
            snippet=ctx.snippet(getattr(node, "lineno", 1)))


def _referenced_names(owner: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(owner):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out
