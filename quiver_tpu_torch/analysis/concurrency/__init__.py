"""Whole-program concurrency model for quiverlint (QT008/QT009/QT010).

The per-file rule framework (:mod:`..core`) sees one module at a time;
data races and lock-order inversions are whole-program properties.  This
package builds a single :class:`~.program.Program` over every analyzed
file — an interprocedural call graph with thread-root discovery, a
lock-held context propagated through it, per-root reachability, and a
lock-acquisition-order graph — and the QT008/QT009/QT010 rules read it.

Everything stays stdlib-only AST analysis (same contract as the rest of
quiverlint: no jax, no device, runs in CI in well under a second).

The runtime complement is :mod:`quiver_tpu_torch.analysis.witness` — a
lock-witness sanitizer enabled by ``QUIVER_SANITIZE=1`` that checks the
same two properties (guarded writes, acquisition order) dynamically.
:func:`canonical_lock_edges` exports the static order graph in the
witness's label vocabulary so the sanitizer can pre-seed its order
relation and flag a single reversed acquisition even when the forward
order never executes in that process.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..core import ModuleContext
from .program import (
    Access,
    ClassInfo,
    FuncInfo,
    LockId,
    Program,
    SpawnSite,
)

__all__ = [
    "Access", "ClassInfo", "FuncInfo", "LockId", "Program", "SpawnSite",
    "build_program", "canonical_lock_edges",
]

# One-slot memo: within one analyze_paths() run the three program rules
# each receive the identical context list, so the expensive build runs
# once.  Keyed by object identity — a fresh run parses fresh contexts.
_CACHE_KEY: Tuple[int, ...] = ()
_CACHE_VAL: Program = None  # type: ignore[assignment]


def build_program(ctxs: Sequence[ModuleContext]) -> Program:
    """Build (or reuse) the whole-program model for ``ctxs``."""
    global _CACHE_KEY, _CACHE_VAL
    key = tuple(id(c) for c in ctxs)
    if key != _CACHE_KEY or _CACHE_VAL is None:
        _CACHE_VAL = Program(list(ctxs))
        _CACHE_KEY = key
    return _CACHE_VAL


def canonical_lock_edges(ctxs: Sequence[ModuleContext],
                         ) -> List[Tuple[str, str]]:
    """Static acquisition-order edges as (held_label, acquired_label)
    pairs, e.g. ``("StreamingGraph._lock", "CSRTopo._lock")`` — the
    vocabulary the runtime witness uses for its own order graph."""
    prog = build_program(ctxs)
    out = []
    for held, acquired, _site in prog.order_edges():
        out.append((held.label, acquired.label))
    return sorted(set(out))
