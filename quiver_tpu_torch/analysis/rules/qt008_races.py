"""QT008 — data-race candidates via whole-program root attribution.

QT003 checks that *declared* guarded attributes are mutated under their
lock, lexically, through ``self``.  It cannot see the two failure modes
that actually bite a multi-threaded serving stack:

1. shared state that was **never declared** — an attribute written from
   two different thread roots with no common lock;
2. **cross-object** mutation of a declared attribute
   (``graph._base = ...`` from the compactor) — invisible to a
   self-only lexical rule even when a ``_guarded_by`` contract exists.

This rule reads the :class:`~..concurrency.program.Program` model:

* every function is attributed to the thread roots that reach it over
  the interprocedural call graph ("main" is the synthetic root for
  public entry points; ``threading.Thread(target=...)``, ``Thread``
  subclasses overriding ``run``, and ``pool.submit(fn)`` each seed one);
* an access's lock-held set is its lexical ``with`` nest plus the
  *must-hold* entry set propagated from every call site.

**Undeclared attribute**: flagged when it is written outside the owning
class's ``__init__`` (or a ``@classmethod`` constructor), the union of
roots over all its accesses spans ≥ 2 roots, and no single lock is held
at every write.  Reads are deliberately not required to hold the lock —
the codebase sanctions double-checked reads (same policy as QT003) —
but they *do* count for root attribution, so a worker-side reader of a
main-side unlocked write is flagged.

**Declared attribute**: any write through a non-``self`` receiver must
hold the declared lock (interprocedural context counts); ``self``
writes stay QT003's job so each site is reported exactly once.

One finding per (class, attribute) at the first offending write keeps
baselines and suppressions stable.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Sequence

from ..concurrency import build_program
from ..concurrency.program import MAIN_ROOT, Access
from ..core import Finding, ModuleContext, ProgramRule


class DataRaceRule(ProgramRule):
    code = "QT008"
    name = "data-race-candidate"
    description = ("instance/module state written from >=2 thread roots "
                   "with no common lock (call-graph lock-held context)")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        prog = build_program(ctxs)
        by_attr: Dict[tuple, List[Access]] = {}
        for acc in prog.accesses:
            by_attr.setdefault((acc.owner, acc.attr), []).append(acc)

        for (owner, attr), accs in sorted(by_attr.items()):
            cls = prog.classes.get(owner)
            if cls is not None and (prog.lock_kind(owner, attr)
                                    or prog.is_sync_attr(owner, attr)):
                continue  # the lock itself, or an Event/Queue-style
                          # internally-synchronized primitive
            guarded = prog.guarded_map(owner) if cls is not None else {}
            if attr in guarded:
                yield from self._check_declared(
                    prog, owner, attr, guarded[attr], accs)
                continue
            yield from self._check_undeclared(prog, owner, attr, accs)

        yield from self._check_requires(prog)

    # -- requires-lock call-site verification --------------------------
    def _check_requires(self, prog) -> Iterator[Finding]:
        """The body of a ``# quiverlint: requires-lock[X._l]`` function
        trusts its directive; this closes the loop by checking every
        resolved call site actually holds the named lock."""
        for e in sorted(prog.call_edges,
                        key=lambda e: (e.caller,
                                       getattr(e.node, "lineno", 0))):
            req = prog.requires.get(e.callee)
            if not req or e.indirect:
                continue
            caller_must = prog.entry_must.get(e.caller) or frozenset()
            held = e.locks | caller_must
            callee = prog.functions[e.callee]
            caller = prog.functions.get(e.caller)
            if caller is None:
                continue
            for lock in sorted(req - held, key=lambda l: l.label):
                ctx = caller.ctx
                node = e.node
                yield Finding(
                    rule=self.code, path=ctx.relpath,
                    line=getattr(node, "lineno", 1),
                    col=getattr(node, "col_offset", 0),
                    scope=ctx.scope_of(node),
                    message=(f"call into `{callee.qual}` (requires-lock "
                             f"`{lock.label}`) without holding "
                             f"`{lock.label}` at the call site"),
                    snippet=ctx.snippet(getattr(node, "lineno", 1)))

    # -- declared contract, cross-object writes ------------------------
    def _check_declared(self, prog, owner, attr, lockname, accs,
                        ) -> Iterator[Finding]:
        for acc in accs:
            if not acc.write or acc.via_self or acc.in_init:
                continue
            held = prog.held_at(acc)
            if any(l.owner == owner and l.attr == lockname for l in held):
                continue
            short = owner.rsplit(":", 1)[-1]
            yield self._finding(
                acc,
                f"`{short}.{attr}` is _guarded_by `{lockname}` but is "
                f"written through a non-self reference without holding "
                f"`{short}.{lockname}`")

    # -- undeclared shared state ---------------------------------------
    def _check_undeclared(self, prog, owner, attr, accs,
                          ) -> Iterator[Finding]:
        writes = [a for a in accs if a.write and not a.in_init]
        if not writes:
            return
        roots = set()
        for acc in accs:
            if not acc.in_init:
                roots |= prog.roots_of.get(acc.func.key, set())
        if len(roots) < 2:
            return
        common = None
        for w in writes:
            held = prog.held_at(w)
            common = held if common is None else (common & held)
            if not common:
                break
        if common:
            return  # every write holds one shared lock
        first = min(writes, key=lambda a: (a.func.ctx.relpath,
                                           a.node.lineno))
        short = owner.rsplit(":", 1)[-1]
        names = sorted(prog.root_labels.get(r, r) for r in roots)
        kind = "attribute" if owner in prog.classes else "module global"
        yield self._finding(
            first,
            f"`{short}.{attr}` ({kind}) is accessed from {len(roots)} "
            f"thread roots ({', '.join(names)}) but its writes share no "
            f"common lock — declare it in _guarded_by and guard the "
            f"writes")

    @staticmethod
    def _finding(acc: Access, message: str) -> Finding:
        ctx = acc.func.ctx
        node = acc.node
        return Finding(
            rule=DataRaceRule.code, path=ctx.relpath, line=node.lineno,
            col=node.col_offset, scope=ctx.scope_of(node),
            message=message, snippet=ctx.snippet(node.lineno))
