"""QT013 — interprocedural host sync.

QT001 is deliberately local: it tracks names assigned from ``torch.*``
calls *within one function* and flags host casts of those.  The syncs
that actually bite cross function boundaries — ``out =
self._fused_forward(padded)`` returns a live card tensor from three
calls away, and the ``np.asarray(out)`` on the next line is invisible to
QT001.  QT013 reads the solved staging dataflow
(:mod:`..staging.dataflow`) instead: any value whose residency fixpoint
is DEVICE *and* whose card residency originated in a hot module (the
sampler -> gather -> serve pipeline, the kernel wrappers) is flagged at
every coercion point —

  * host casts: ``int()`` / ``float()`` / ``bool()``,
  * materializers: ``np.asarray()`` / ``np.array()``, ``.cpu()`` and
    ``.to("cpu")``,
  * sync methods: ``.item()`` / ``.tolist()``,
  * implicit bool: ``if x:`` / ``while x:`` / ``not x`` / ``x and y``
    / ``assert x`` — each one compiles to ``bool(x)``, a blocking
    read-back torch will happily perform for you.

Intentional syncs at a design boundary (a serving response leaving the
process, a bench harness checksum) carry a written waiver::

    out = np.asarray(dev)  # quiverlint: sync-ok[response boundary]

``sync-ok`` is audited: a waiver that no longer suppresses anything is
*stale* and fails ``--strict-baseline`` (see ``analyze_paths``), so
the escape hatch can't outlive the sync it excused.

Hot modules stay QT001's territory for what QT001 sees: ``.cpu()`` and
``.to("cpu")`` (flagged there outright), purely-local flows (a name
assigned from ``torch.*`` in the same function), and any line QT001
already reports — so one sync is never reported twice under two codes,
and a line carries at most one code (and one directive).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..core import (
    Finding,
    ModuleContext,
    ProgramRule,
    dotted_call_name,
)

_CASTS = {"int", "float", "bool"}
_MATERIALIZE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist"}


class InterproceduralHostSyncRule(ProgramRule):
    code = "QT013"
    name = "interprocedural-host-sync"
    description = ("host coercion (cast / np.asarray / .item / .cpu / "
                   "implicit bool) of a card value that crossed a "
                   "function boundary from a hot-path producer")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        from ..staging.dataflow import DEVICE, build_dataflow
        from .qt001_host_sync import (HostSyncRule, _is_cpu_to, _mentions,
                                      _SYNC_CALLS, _tracked_names)

        df = build_dataflow(ctxs)
        out: List[Finding] = []
        seen: Set[Tuple[str, int, int, str]] = set()
        qt001_lines: Dict[str, Set[int]] = {}   # relpath -> lines, lazy

        def qt001_sync(node: ast.AST) -> bool:
            """A call QT001 flags outright in a hot module."""
            return isinstance(node, ast.Call) and (
                dotted_call_name(node.func) in _SYNC_CALLS
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("cpu", "synchronize"))
                or _is_cpu_to(node))

        for fi in df.prog.functions.values():
            ctx = fi.ctx
            hot = ctx.is_hot()
            tracked: Optional[Set[str]] = None  # QT001's local set, lazy

            def local_territory(node: ast.AST, arg: ast.AST) -> bool:
                """True when QT001 already owns this sync (hot module:
                a ``.cpu()`` / ``.to("cpu")``, a sync inside the coerced
                expression, purely local tensor provenance, or a line
                QT001 reports).  Mirrors QT001's own ownership test."""
                nonlocal tracked
                if not hot:
                    return False
                if qt001_sync(node) or any(qt001_sync(s)
                                           for s in ast.walk(arg)):
                    return True
                if ctx.relpath not in qt001_lines:
                    qt001_lines[ctx.relpath] = {
                        f.line for f in HostSyncRule().check(ctx)}
                if node.lineno in qt001_lines[ctx.relpath]:
                    return True
                if tracked is None:
                    tracked = _tracked_names(fi.node)
                return _mentions(arg, tracked)

            def emit(node: ast.AST, arg: ast.AST, kind: str, msg: str,
                     env: Dict) -> None:
                v = df.classify(fi, arg, env)
                if v is None or v.cls != DEVICE or not v.hot:
                    return
                if local_territory(node, arg):
                    return
                key = (ctx.relpath, node.lineno, node.col_offset, kind)
                if key in seen:
                    return
                seen.add(key)
                out.append(ctx.finding(self.code, node, msg))

            def visit(node: ast.AST, env: Dict) -> None:
                if isinstance(node, ast.Call):
                    name = dotted_call_name(node.func)
                    if name in _CASTS and node.args:
                        emit(node, node.args[0], "cast",
                             f"`{name}()` of a card value produced in a "
                             f"hot path forces a blocking device->host "
                             f"sync (crossed a function boundary; waive "
                             f"an intentional boundary with "
                             f"`# quiverlint: sync-ok[reason]`)", env)
                    elif name in _MATERIALIZE and node.args:
                        emit(node, node.args[0], "cast",
                             f"`{name}()` materializes a hot-path card "
                             f"value on host — a full transfer per call "
                             f"(waive an intentional response boundary "
                             f"with `# quiverlint: sync-ok[reason]`)", env)
                    elif (isinstance(node.func, ast.Attribute)
                          and node.func.attr in _SYNC_METHODS
                          and not node.args):
                        emit(node, node.func.value, "cast",
                             f"`.{node.func.attr}()` syncs a hot-path "
                             f"card value to host", env)
                    elif (isinstance(node.func, ast.Attribute)
                          and (node.func.attr == "cpu"
                               or _is_cpu_to(node))):
                        emit(node, node.func.value, "cast",
                             f"`.{node.func.attr}(...)` copies a hot-path "
                             f"card value to host and waits for the "
                             f"stream (waive an intentional response "
                             f"boundary with "
                             f"`# quiverlint: sync-ok[reason]`)", env)
                elif isinstance(node, (ast.If, ast.While)):
                    emit(node, node.test, "bool",
                         "implicit bool() of a hot-path card value — "
                         "branching on card data blocks on a transfer; "
                         "hoist the decision to host metadata or shape "
                         "logic", env)
                elif isinstance(node, ast.Assert):
                    emit(node, node.test, "bool",
                         "assert on a hot-path card value forces an "
                         "implicit bool() sync", env)
                elif (isinstance(node, ast.UnaryOp)
                      and isinstance(node.op, ast.Not)):
                    emit(node, node.operand, "bool",
                         "`not` on a hot-path card value forces an "
                         "implicit bool() sync", env)
                elif isinstance(node, ast.IfExp):
                    emit(node, node.test, "bool",
                         "conditional expression on a hot-path card "
                         "value forces an implicit bool() sync", env)

            df.replay(fi, visit)

        yield from out
