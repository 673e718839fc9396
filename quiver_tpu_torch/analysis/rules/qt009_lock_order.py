"""QT009 — lock-order inversions over the acquisition-order graph.

The program model records every ``with <lock>:`` acquisition together
with the locks already held there — lexically, plus the *may-hold*
entry set propagated through the call graph (an inversion exists if
*any* path nests the pair).  Those pairs form a directed graph over
lock identities (``Class.attr`` / ``module.name``); a cycle is a
deadlock candidate and every strongly connected component with more
than one lock (or a non-reentrant self-edge) is reported once, with the
offending acquisition chain spelled out.

Re-entrant acquisition of an ``RLock``/``Condition`` by design is not
an inversion; re-acquiring a plain ``Lock`` you already hold is an
instant self-deadlock and is flagged even without a second lock.

The runtime complement (``QUIVER_SANITIZE=1``,
:mod:`quiver_tpu_torch.analysis.witness`) checks the same order relation
dynamically and can be pre-seeded with this rule's edges via
:func:`quiver_tpu_torch.analysis.concurrency.canonical_lock_edges`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

from ..concurrency import build_program
from ..concurrency.program import LockId
from ..core import Finding, ModuleContext, ProgramRule


class LockOrderRule(ProgramRule):
    code = "QT009"
    name = "lock-order-inversion"
    description = ("cyclic lock-acquisition order (deadlock candidate) "
                   "across the call graph; plain-Lock re-entry")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        prog = build_program(ctxs)
        edges: Dict[Tuple[LockId, LockId], object] = {}
        for held, acquired, acq in prog.order_edges():
            edges.setdefault((held, acquired), acq)

        # self-edges: re-acquiring a non-reentrant Lock
        for (a, b), acq in sorted(
                edges.items(), key=lambda kv: self._sort_key(kv[1])):
            if a == b:
                yield self._finding(
                    acq,
                    f"`{a.label}` is a non-reentrant Lock acquired while "
                    f"already held on this path — instant self-deadlock "
                    f"(use an RLock or restructure the callers)")

        graph: Dict[LockId, List[LockId]] = {}
        for (a, b) in edges:
            if a != b:
                graph.setdefault(a, []).append(b)
        for cycle in self._cycles(graph):
            chain = []
            for i, lock in enumerate(cycle):
                nxt = cycle[(i + 1) % len(cycle)]
                acq = edges.get((lock, nxt))
                site = self._site(acq) if acq is not None else "?"
                chain.append(f"{lock.label} -> {nxt.label} at {site}")
            rep = edges[(cycle[0], cycle[1 % len(cycle)])]
            yield self._finding(
                rep,
                "lock-order inversion (deadlock candidate): "
                + "; ".join(chain))

    # -- cycle enumeration ---------------------------------------------
    @staticmethod
    def _cycles(graph: Dict[LockId, List[LockId]],
                ) -> List[List[LockId]]:
        """One representative cycle per strongly connected component
        with >= 2 locks (iterative Tarjan, then a path walk)."""
        index: Dict[LockId, int] = {}
        low: Dict[LockId, int] = {}
        on: Dict[LockId, bool] = {}
        stack: List[LockId] = []
        sccs: List[List[LockId]] = []
        counter = [0]

        def strongconnect(root: LockId) -> None:
            work = [(root, iter(graph.get(root, ())))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on[root] = True
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on[w] = True
                        work.append((w, iter(graph.get(w, ()))))
                        advanced = True
                        break
                    elif on.get(w):
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    u = work[-1][0]
                    low[u] = min(low[u], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on[w] = False
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)

        nodes = sorted(graph, key=lambda l: (l.owner, l.attr))
        for n in nodes:
            if n not in index:
                strongconnect(n)

        cycles = []
        for comp in sccs:
            comp_set = set(comp)
            start = min(comp, key=lambda l: (l.owner, l.attr))
            # walk edges inside the SCC until we loop back to start
            path = [start]
            seen = {start}
            cur = start
            while True:
                nxt = None
                for cand in graph.get(cur, ()):
                    if cand == start and len(path) > 1:
                        nxt = start
                        break
                    if cand in comp_set and cand not in seen:
                        nxt = cand
                        break
                if nxt is None or nxt == start:
                    break
                path.append(nxt)
                seen.add(nxt)
                cur = nxt
            cycles.append(path)
        return cycles

    # -- formatting ----------------------------------------------------
    @staticmethod
    def _site(acq) -> str:
        return (f"{acq.func.ctx.relpath}:{acq.node.lineno} "
                f"({acq.func.qual})")

    @staticmethod
    def _sort_key(acq) -> Tuple[str, int]:
        return (acq.func.ctx.relpath, acq.node.lineno)

    @staticmethod
    def _finding(acq, message: str) -> Finding:
        ctx = acq.func.ctx
        node = acq.node
        return Finding(
            rule=LockOrderRule.code, path=ctx.relpath, line=node.lineno,
            col=node.col_offset, scope=ctx.scope_of(node),
            message=message, snippet=ctx.snippet(node.lineno))
