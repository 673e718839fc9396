"""QT003 — lock discipline via class-level ``_guarded_by`` declarations.

The serving pipeline and the metrics registry are thread soups by
design: batcher workers, sampler workers, the device loop, and the
metrics endpoint all share object state.  A class declares its contract
as a literal map::

    class InferenceServer:
        _guarded_by = {"_fused_fns": "_lock"}

and this rule enforces that every *mutation* of a declared attribute
(``self._fused_fns[...] = ...``, ``self._fused_fns.pop(...)``,
rebinding, augmented assignment) happens lexically inside a
``with self._lock:`` block naming the declared lock.  ``__init__`` and
``__post_init__`` are exempt (construction happens-before publication),
and so are ``@classmethod`` bodies — the alternate-constructor idiom
builds an instance named ``self`` before publication, and a classmethod
has no real ``self`` to mutate otherwise.  Reads are not
checked: the codebase intentionally uses double-checked locking on
CPython where a racy read is benign (e.g. ``MetricsRegistry._get``).
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, Optional

from ..core import Finding, ModuleContext, Rule

# method names that mutate the common containers in place
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "popitem",
    "appendleft", "clear", "update", "setdefault", "add", "discard",
    "__setitem__", "sort", "reverse",
}


def _guarded_map(cls: ast.ClassDef) -> Optional[Dict[str, str]]:
    """Parse a literal class-level ``_guarded_by = {"attr": "lock"}``."""
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            target, value = stmt.targets[0].id, stmt.value
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name) \
                and stmt.value is not None:
            target, value = stmt.target.id, stmt.value
        if target != "_guarded_by":
            continue
        if not isinstance(value, ast.Dict):
            return None
        out: Dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant) \
                    and isinstance(k.value, str) and isinstance(v.value, str):
                out[k.value] = v.value
        return out
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _with_locks(stmt: ast.With) -> FrozenSet[str]:
    names = set()
    for item in stmt.items:
        attr = _self_attr(item.context_expr)
        if attr:
            names.add(attr)
    return frozenset(names)


class LockDisciplineRule(Rule):
    code = "QT003"
    name = "lock-discipline"
    description = ("attributes declared in a class-level _guarded_by map "
                   "must only be mutated under `with self.<lock>`")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                guarded = _guarded_map(node)
                if guarded:
                    yield from self._check_class(ctx, node, guarded)

    def _check_class(self, ctx: ModuleContext, cls: ast.ClassDef,
                     guarded: Dict[str, str]) -> Iterator[Finding]:
        qual_base = ctx.scope_of(cls)
        cls_qual = (f"{qual_base}.{cls.name}"
                    if qual_base != "<module>" else cls.name)
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name in ("__init__", "__post_init__"):
                    continue
                if any(isinstance(d, ast.Name) and d.id == "classmethod"
                       for d in stmt.decorator_list):
                    continue  # alternate constructor: pre-publication
                yield from self._walk(
                    ctx, stmt, guarded, frozenset(),
                    f"{cls_qual}.{stmt.name}")

    def _walk(self, ctx: ModuleContext, node: ast.AST,
              guarded: Dict[str, str], locks: FrozenSet[str],
              scope: str) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            child_locks = locks
            if isinstance(child, ast.With):
                child_locks = locks | _with_locks(child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def's body runs later, outside any with-block
                # active at its definition site
                child_locks = frozenset()
            yield from self._mutations(ctx, child, guarded, locks, scope)
            yield from self._walk(ctx, child, guarded, child_locks, scope)

    def _mutations(self, ctx: ModuleContext, node: ast.AST,
                   guarded: Dict[str, str], locks: FrozenSet[str],
                   scope: str) -> Iterator[Finding]:
        hits = []  # (attr, node)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = _self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                if attr in guarded:
                    hits.append((attr, node))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr in guarded:
                hits.append((attr, node))
        for attr, n in hits:
            lock = guarded[attr]
            if lock not in locks:
                yield ctx.finding(
                    self.code, n,
                    f"`self.{attr}` is declared _guarded_by "
                    f"`self.{lock}` but is mutated outside `with "
                    f"self.{lock}:`",
                    scope=scope)
