"""The whole-program model behind QT008/QT009/QT010.

Built from the same :class:`~quiver_tpu_torch.analysis.core.ModuleContext`
objects the per-file rules consume, in four passes:

1. **Index** — every module's imports, classes (with bases), functions
   (including nested defs and methods), module-level locks.
2. **Types** — a deliberately shallow type environment: parameter
   annotations (including quoted forward references and
   ``Optional[...]``), ``x = ClassName(...)`` constructor assignments,
   and ``self.attr = <typed value>`` instance-attribute types; plus
   per-class lock attributes (``self._lock = threading.Lock()``) and
   merged ``_guarded_by`` contracts.
3. **Facts** — one walk per function collecting call edges (with the
   lexical lock set at each call site), thread spawns
   (``threading.Thread(target=...)``, ``Thread`` subclasses overriding
   ``run``, ``<pool>.submit(fn)``), attribute/global accesses with the
   locks lexically held, and lock acquisitions (``with <lock>:``) with
   the locks already held.
4. **Fixpoints** — per-root reachability over the call graph ("main" is
   a synthetic root seeded by every public entry point that is not a
   thread body), a *must-hold* entry-lock set per function
   (intersection over call sites — used by QT008 to credit callers'
   locks), and a *may-hold* set (union — used by QT009 so an order edge
   exists if any path holds A when B is acquired).

Precision notes (documented in docs/STATIC_ANALYSIS.md): resolution is
name-based and first-order — no flow sensitivity, no aliasing beyond
the type environment above, callable arguments (``register(cb)``) add a
conservative call edge from the registration site.  The design goal is
the same as QT001-007: catch the structural violations that matter in
this codebase with near-zero false positives, and let the runtime
witness (``QUIVER_SANITIZE=1``) cover what static analysis cannot.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from ..core import ModuleContext

__all__ = [
    "Access", "CallEdge", "ClassInfo", "FuncInfo", "LockId", "Program",
    "SpawnSite", "MAIN_ROOT",
]

MAIN_ROOT = "main"

# threading constructors that create a lock-like object; the kind
# matters to QT009 (re-entrant acquisition of an RLock/Condition is not
# a self-deadlock, re-acquiring a plain Lock is).
_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

# Methods that build the instance before publication: writes inside them
# are construction, not shared-state mutation (dataclasses run
# ``__post_init__`` inside ``__init__``).
_INIT_NAMES = ("__init__", "__post_init__")

# method names that mutate the common containers in place (kept in sync
# with qt003_locks; duplicated so the concurrency package has no import
# edge into the per-file rules).
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "popitem",
    "appendleft", "clear", "update", "setdefault", "add", "discard",
    "__setitem__", "sort", "reverse",
}


@dataclass(frozen=True)
class LockId:
    """A lock identity: (owning class key | module, attribute name)."""

    owner: str   # "pkg.mod:Class" for instance locks, "pkg.mod" for globals
    attr: str
    kind: str = "lock"

    @property
    def label(self) -> str:
        short = self.owner.rsplit(":", 1)[-1].rsplit(".", 1)[-1]
        return f"{short}.{self.attr}"

    def __repr__(self):
        return f"LockId({self.label})"


@dataclass
class ClassInfo:
    key: str                       # "pkg.mod:Qual.Class"
    name: str                      # local qualname within the module
    node: ast.ClassDef
    ctx: ModuleContext
    base_names: List[str] = field(default_factory=list)   # raw dotted
    base_keys: List[str] = field(default_factory=list)    # resolved
    methods: Dict[str, "FuncInfo"] = field(default_factory=dict)
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr->kind
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr->clskey
    sync_attrs: Set[str] = field(default_factory=set)  # Event/Queue/...
    guarded: Dict[str, str] = field(default_factory=dict)     # own decl
    is_thread_subclass: bool = False


@dataclass
class FuncInfo:
    key: str                       # "pkg.mod:qualname"
    qual: str                      # qualname within the module
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    ctx: ModuleContext
    cls: Optional[ClassInfo] = None          # innermost enclosing class
    parent: Optional["FuncInfo"] = None      # enclosing def for nested
    local_types: Dict[str, str] = field(default_factory=dict)
    nested: Dict[str, str] = field(default_factory=dict)  # name->funckey
    requires_raw: List[str] = field(default_factory=list)  # directives

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]

    @property
    def label(self) -> str:
        cls = f"{self.cls.name}." if self.cls else ""
        mod = self.ctx.relpath
        return f"{mod}:{self.qual}"


@dataclass
class CallEdge:
    caller: str
    callee: str
    locks: FrozenSet[LockId]       # lexical locks held at the call site
    node: ast.AST
    indirect: bool = False         # callable passed as an argument


@dataclass
class SpawnSite:
    kind: str                      # "thread" | "submit" | "thread-subclass"
    func: Optional[FuncInfo]       # creating function (None for subclass)
    target: Optional[str]          # funckey the new thread runs, if known
    node: ast.AST
    ctx: ModuleContext
    owner_class: Optional[ClassInfo]
    borrowed: bool = False         # submit on a pool the owner doesn't own

    @property
    def root_id(self) -> str:
        if self.kind == "thread-subclass" and self.target:
            return self.target
        where = self.func.key if self.func else self.ctx.module
        return f"{where}@{getattr(self.node, 'lineno', 0)}"

    @property
    def label(self) -> str:
        if self.target:
            short = self.target.rsplit(":", 1)[-1]
        else:
            short = "<unresolved>"
        return f"{self.kind}:{short}"


@dataclass
class Access:
    owner: str                     # class key, or module for globals
    attr: str
    write: bool
    func: FuncInfo
    node: ast.AST
    locks: FrozenSet[LockId]       # lexical locks at the access
    in_init: bool                  # inside the owner class's __init__
    via_self: bool                 # receiver is `self` (vs cross-object)


@dataclass
class _Acquisition:
    func: FuncInfo
    lock: LockId
    held_before: FrozenSet[LockId]   # lexical locks already held
    node: ast.AST


class _ModuleIndex:
    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.imports: Dict[str, str] = {}        # alias -> dotted module
        self.from_names: Dict[str, Tuple[str, str]] = {}  # name->(mod,attr)
        self.functions: Dict[str, str] = {}      # top-level name -> funckey
        self.classes: Dict[str, str] = {}        # local qualname -> clskey
        self.module_locks: Dict[str, str] = {}   # name -> kind
        self.globals_written: Set[str] = set()


class Program:
    """Whole-program concurrency facts over a list of module contexts."""

    def __init__(self, ctxs: Sequence[ModuleContext]):
        self.ctxs = list(ctxs)
        self.modules: Dict[str, _ModuleIndex] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.class_by_name: Dict[str, List[str]] = {}
        self.call_edges: List[CallEdge] = []
        self.spawns: List[SpawnSite] = []
        self.accesses: List[Access] = []
        self.acquisitions: List[_Acquisition] = []
        self._callers: Dict[str, List[CallEdge]] = {}
        self._callees: Dict[str, List[CallEdge]] = {}
        self._index()
        self._collect_types()
        self._collect_facts()
        self._fixpoints()

    # ------------------------------------------------------------------
    # pass 1: index modules, classes, functions

    def _index(self) -> None:
        for ctx in self.ctxs:
            mod = _ModuleIndex(ctx)
            self.modules[ctx.module] = mod
            for stmt in ctx.tree.body:
                if isinstance(stmt, ast.Import):
                    for a in stmt.names:
                        mod.imports[a.asname or a.name.split(".")[0]] = \
                            a.name if a.asname else a.name.split(".")[0]
                        if a.asname:
                            mod.imports[a.asname] = a.name
                elif isinstance(stmt, ast.ImportFrom):
                    base = self._resolve_from(ctx, stmt)
                    for a in stmt.names:
                        if a.name == "*":
                            continue
                        mod.from_names[a.asname or a.name] = (base, a.name)
                elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    kind = _lock_ctor_kind(stmt.value)
                    if kind:
                        mod.module_locks[stmt.targets[0].id] = kind
            self._index_scope(ctx, mod, ctx.tree, qual="", cls=None,
                              parent=None)
        # resolve class bases now every class exists
        for ci in self.classes.values():
            for raw in ci.base_names:
                key = self._resolve_class_name(ci.ctx, raw)
                if key:
                    ci.base_keys.append(key)
                if raw.split(".")[-1] == "Thread":
                    ci.is_thread_subclass = True
        # inherited thread-ness (one level of fixpoint is plenty here,
        # but iterate to closure for deep towers)
        changed = True
        while changed:
            changed = False
            for ci in self.classes.values():
                if ci.is_thread_subclass:
                    continue
                for bk in ci.base_keys:
                    base = self.classes.get(bk)
                    if base is not None and base.is_thread_subclass:
                        ci.is_thread_subclass = True
                        changed = True

    @staticmethod
    def _resolve_from(ctx: ModuleContext, stmt: ast.ImportFrom) -> str:
        if not stmt.level:
            return stmt.module or ""
        parts = ctx.module.split(".")
        # level 1 = the containing package: a plain module drops its
        # leaf, a package __init__ *is* its own package
        drop = stmt.level
        if ctx.relpath.endswith("__init__.py"):
            drop -= 1
        if drop:
            parts = parts[: len(parts) - drop]
        if stmt.module:
            parts.append(stmt.module)
        return ".".join(parts)

    def _index_scope(self, ctx: ModuleContext, mod: _ModuleIndex,
                     node: ast.AST, qual: str, cls: Optional[ClassInfo],
                     parent: Optional[FuncInfo]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                q = f"{qual}.{child.name}" if qual else child.name
                ci = ClassInfo(key=f"{ctx.module}:{q}", name=q, node=child,
                               ctx=ctx)
                for b in child.bases:
                    dotted = _dotted(b)
                    if dotted:
                        ci.base_names.append(
                            self._canon_base(mod, dotted))
                self.classes[ci.key] = ci
                self.class_by_name.setdefault(
                    child.name, []).append(ci.key)
                if not qual:
                    mod.classes[q] = ci.key
                self._index_scope(ctx, mod, child, q, ci, parent)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                fi = FuncInfo(key=f"{ctx.module}:{q}", qual=q, node=child,
                              ctx=ctx, cls=cls, parent=parent,
                              requires_raw=_requires_directives(ctx, child))
                self.functions[fi.key] = fi
                if cls is not None and parent is None \
                        and child.name not in cls.methods:
                    cls.methods[child.name] = fi
                if not qual:
                    mod.functions[child.name] = fi.key
                if parent is not None:
                    parent.nested[child.name] = fi.key
                self._index_scope(ctx, mod, child, q, cls, fi)
            else:
                self._index_scope(ctx, mod, child, qual, cls, parent)

    def _canon_base(self, mod: _ModuleIndex, dotted: str) -> str:
        head = dotted.split(".")[0]
        if head in mod.from_names and "." not in dotted:
            m, a = mod.from_names[head]
            return f"{m}.{a}"
        return dotted

    # ------------------------------------------------------------------
    # name resolution helpers

    def _resolve_class_name(self, ctx: ModuleContext,
                            name: str) -> Optional[str]:
        """Resolve a (possibly dotted / quoted) class name to a key."""
        mod = self.modules[ctx.module]
        name = name.strip()
        parts = name.split(".")
        local = mod.classes.get(name)
        if local:
            return local
        if parts[0] in mod.from_names:
            m, a = mod.from_names[parts[0]]
            target = self.modules.get(m)
            rest = ".".join([a] + parts[1:])
            if target and rest in target.classes:
                return target.classes[rest]
            # "from x import y" where y is a module
            sub = self.modules.get(f"{m}.{a}")
            if sub and parts[1:] and ".".join(parts[1:]) in sub.classes:
                return sub.classes[".".join(parts[1:])]
        if parts[0] in mod.imports and len(parts) > 1:
            sub = self.modules.get(mod.imports[parts[0]])
            if sub and ".".join(parts[1:]) in sub.classes:
                return sub.classes[".".join(parts[1:])]
        # quoted forward reference to a class defined elsewhere: accept a
        # program-wide unique simple-name match (annotations are the
        # sanctioned way to teach the analyzer cross-module types)
        if len(parts) == 1:
            hits = self.class_by_name.get(name, [])
            if len(hits) == 1:
                return hits[0]
        return None

    def _annotation_class(self, ctx: ModuleContext,
                          ann: Optional[ast.AST]) -> Optional[str]:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return self._resolve_class_name(ctx, ann.value)
        if isinstance(ann, ast.Subscript):
            base = _dotted(ann.value) or ""
            if base.split(".")[-1] in ("Optional", "Annotated"):
                inner = ann.slice
                if isinstance(inner, ast.Tuple) and inner.elts:
                    inner = inner.elts[0]
                return self._annotation_class(ctx, inner)
            return None
        dotted = _dotted(ann)
        if dotted:
            return self._resolve_class_name(ctx, dotted)
        return None

    def _mro(self, key: str) -> Iterator[ClassInfo]:
        seen: Set[str] = set()
        stack = [key]
        while stack:
            k = stack.pop(0)
            if k in seen:
                continue
            seen.add(k)
            ci = self.classes.get(k)
            if ci is None:
                continue
            yield ci
            stack.extend(ci.base_keys)

    def lookup_method(self, clskey: str, name: str) -> Optional[FuncInfo]:
        for ci in self._mro(clskey):
            if name in ci.methods:
                return ci.methods[name]
        return None

    def guarded_map(self, clskey: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for ci in self._mro(clskey):
            for k, v in ci.guarded.items():
                out.setdefault(k, v)
        return out

    def lock_kind(self, clskey: str, attr: str) -> Optional[str]:
        for ci in self._mro(clskey):
            if attr in ci.lock_attrs:
                return ci.lock_attrs[attr]
        return None

    def is_sync_attr(self, clskey: str, attr: str) -> bool:
        return any(attr in ci.sync_attrs for ci in self._mro(clskey))

    # ------------------------------------------------------------------
    # pass 2: shallow type environment

    def _collect_types(self) -> None:
        for ci in self.classes.values():
            g = _literal_guarded(ci.node)
            if g:
                ci.guarded = g
        for fi in self.functions.values():
            node = fi.node
            args = getattr(node, "args", None)
            if args is not None:
                for a in list(args.args) + list(args.kwonlyargs):
                    t = self._annotation_class(fi.ctx, a.annotation)
                    if t:
                        fi.local_types[a.arg] = t
            for stmt in _own_statements(node):
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    t = self._annotation_class(fi.ctx, stmt.annotation)
                    if t:
                        fi.local_types[stmt.target.id] = t
                if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                    continue
                target, value = stmt.targets[0], stmt.value
                vtype = self._value_class(fi, value)
                if isinstance(target, ast.Name):
                    kind = _lock_ctor_kind(value)
                    if kind is None and vtype:
                        fi.local_types[target.id] = vtype
                elif _self_attr(target) and fi.cls is not None:
                    attr = _self_attr(target)
                    kind = _lock_ctor_kind(value)
                    if kind:
                        fi.cls.lock_attrs.setdefault(attr, kind)
                    elif _is_sync_ctor(value):
                        fi.cls.sync_attrs.add(attr)
                    elif vtype:
                        fi.cls.attr_types.setdefault(attr, vtype)
                    elif isinstance(value, ast.Name) \
                            and value.id in fi.local_types:
                        fi.cls.attr_types.setdefault(
                            attr, fi.local_types[value.id])

    def _value_class(self, fi: FuncInfo, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            dotted = _dotted(value.func)
            if dotted:
                return self._resolve_class_name(fi.ctx, dotted)
        if isinstance(value, ast.Name):
            return fi.local_types.get(value.id)
        return None

    # ------------------------------------------------------------------
    # pass 3: per-function facts

    def _collect_facts(self) -> None:
        for fi in self.functions.values():
            _FactWalker(self, fi).run()
        for ci in self.classes.values():
            if ci.is_thread_subclass and "run" in ci.methods:
                self.spawns.append(SpawnSite(
                    kind="thread-subclass", func=None,
                    target=ci.methods["run"].key, node=ci.node, ctx=ci.ctx,
                    owner_class=ci))
        for e in self.call_edges:
            self._callers.setdefault(e.callee, []).append(e)
            self._callees.setdefault(e.caller, []).append(e)

    def receiver_class(self, fi: FuncInfo, expr: ast.AST) -> Optional[str]:
        """Type of a receiver expression: self / typed local / typed
        self-attribute, looked up through the enclosing-def chain."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fi.cls is not None:
                return fi.cls.key
            f: Optional[FuncInfo] = fi
            while f is not None:
                if expr.id in f.local_types:
                    return f.local_types[expr.id]
                f = f.parent
            return None
        attr = _self_attr(expr)
        if attr and fi.cls is not None:
            for ci in self._mro(fi.cls.key):
                if attr in ci.attr_types:
                    return ci.attr_types[attr]
        return None

    def _module_key(self, fi: FuncInfo, dotted: str) -> Optional[str]:
        """Resolve a dotted receiver to a program module key, handling
        both ``import pkg.mod`` and ``from pkg import mod`` spellings."""
        mod = self.modules[fi.ctx.module]
        if dotted in mod.from_names:
            m, a = mod.from_names[dotted]
            key = f"{m}.{a}"
            if key in self.modules:
                return key
            return None
        key = mod.imports.get(dotted, dotted)
        return key if key in self.modules else None

    def resolve_lock(self, fi: FuncInfo, expr: ast.AST) -> Optional[LockId]:
        """``with <expr>:`` — is expr a known lock?"""
        if isinstance(expr, ast.Name):
            mod = self.modules[fi.ctx.module]
            if expr.id in mod.module_locks:
                return LockId(fi.ctx.module, expr.id,
                              mod.module_locks[expr.id])
            if expr.id in mod.from_names:
                m, a = mod.from_names[expr.id]
                target = self.modules.get(m)
                if target and a in target.module_locks:
                    return LockId(m, a, target.module_locks[a])
            return None
        if isinstance(expr, ast.Attribute):
            owner = self.receiver_class(fi, expr.value)
            if owner:
                kind = self.lock_kind(owner, expr.attr)
                if kind:
                    return LockId(owner, expr.attr, kind)
            # module-level lock referenced through an import alias
            dotted = _dotted(expr.value)
            if dotted:
                mkey = self._module_key(fi, dotted)
                target = self.modules.get(mkey) if mkey else None
                if target and expr.attr in target.module_locks:
                    return LockId(mkey, expr.attr,
                                  target.module_locks[expr.attr])
        return None

    def resolve_callable(self, fi: FuncInfo,
                         expr: ast.AST) -> Optional[str]:
        """Function key a callable expression refers to, if resolvable."""
        if isinstance(expr, ast.Name):
            f: Optional[FuncInfo] = fi
            while f is not None:
                if expr.id in f.nested:
                    return f.nested[expr.id]
                f = f.parent
            mod = self.modules[fi.ctx.module]
            if expr.id in mod.functions:
                return mod.functions[expr.id]
            if expr.id in mod.from_names:
                m, a = mod.from_names[expr.id]
                target = self.modules.get(m)
                if target and a in target.functions:
                    return target.functions[a]
                if target and a in target.classes:
                    init = self.lookup_method(target.classes[a], "__init__")
                    return init.key if init else None
            if expr.id in mod.classes:
                init = self.lookup_method(mod.classes[expr.id], "__init__")
                return init.key if init else None
            return None
        if isinstance(expr, ast.Attribute):
            owner = self.receiver_class(fi, expr.value)
            if owner:
                m = self.lookup_method(owner, expr.attr)
                return m.key if m else None
            dotted = _dotted(expr.value)
            if dotted:
                mkey = self._module_key(fi, dotted)
                target = self.modules.get(mkey) if mkey else None
                if target:
                    if expr.attr in target.functions:
                        return target.functions[expr.attr]
                    if expr.attr in target.classes:
                        init = self.lookup_method(
                            target.classes[expr.attr], "__init__")
                        return init.key if init else None
                    if expr.attr in target.from_names:
                        # one re-export hop (package __init__ facades)
                        m2, a2 = target.from_names[expr.attr]
                        t2 = self.modules.get(m2)
                        if t2 and a2 in t2.functions:
                            return t2.functions[a2]
        return None

    # ------------------------------------------------------------------
    # pass 4: roots, reachability, entry-lock fixpoints

    def _fixpoints(self) -> None:
        # requires-lock directives: the annotated function's entry set is
        # guaranteed to hold the named locks (trusted in the body; call
        # sites are verified by QT008)
        self.requires: Dict[str, FrozenSet[LockId]] = {}
        for k, fi in self.functions.items():
            locks: Set[LockId] = set()
            for raw in fi.requires_raw:
                cname, _, attr = raw.rpartition(".")
                if not cname or not attr:
                    continue
                clskey = self._resolve_class_name(fi.ctx, cname)
                if clskey is None:
                    continue
                kind = self.lock_kind(clskey, attr) or "lock"
                locks.add(LockId(clskey, attr, kind))
            if locks:
                self.requires[k] = frozenset(locks)

        root_targets: Dict[str, str] = {}
        for s in self.spawns:
            if s.target and s.target in self.functions:
                root_targets.setdefault(s.target, s.root_id)
        thread_bodies = set(root_targets)

        # main seeds: every public entry point that is not a thread body
        main_seeds = [
            k for k, f in self.functions.items()
            if k not in thread_bodies and not (
                f.name.startswith("_") and not f.name.startswith("__"))
            and not (f.cls is not None and f.cls.is_thread_subclass
                     and f.name == "run")
            and f.parent is None
        ]

        def reach(seeds: Sequence[str]) -> Set[str]:
            seen: Set[str] = set()
            stack = list(seeds)
            while stack:
                k = stack.pop()
                if k in seen:
                    continue
                seen.add(k)
                for e in self._callees.get(k, ()):
                    if e.callee not in seen:
                        stack.append(e.callee)
            return seen

        self.roots_of: Dict[str, Set[str]] = {k: set()
                                              for k in self.functions}
        for fk in reach(main_seeds):
            self.roots_of[fk].add(MAIN_ROOT)
        self.root_labels: Dict[str, str] = {MAIN_ROOT: "main"}
        for s in self.spawns:
            if not s.target or s.target not in self.functions:
                continue
            rid = s.root_id
            self.root_labels[rid] = \
                f"{self.functions[s.target].qual} [{s.kind}]"
            for fk in reach([s.target]):
                self.roots_of[fk].add(rid)

        # entry-lock fixpoints: must (intersection) and may (union)
        self.entry_must: Dict[str, Optional[FrozenSet[LockId]]] = {
            k: None for k in self.functions}
        self.entry_may: Dict[str, FrozenSet[LockId]] = {
            k: frozenset() for k in self.functions}
        empty: FrozenSet[LockId] = frozenset()
        for k in list(thread_bodies) + main_seeds:
            self.entry_must[k] = self.requires.get(k, empty)
        for k in self.requires:  # annotated helpers keep their floor
            if self.entry_must[k] is None:
                self.entry_must[k] = self.requires[k]
        for _ in range(40):  # call-graph depth bound; converges far sooner
            changed = False
            for e in self.call_edges:
                caller_must = self.entry_must.get(e.caller)
                if caller_must is not None:
                    contrib = caller_must | e.locks
                    cur = self.entry_must.get(e.callee)
                    nxt = contrib if cur is None else (cur & contrib)
                    nxt |= self.requires.get(e.callee, empty)
                    if nxt != cur:
                        self.entry_must[e.callee] = nxt
                        changed = True
                may = self.entry_may.get(e.caller, empty) | e.locks
                cur_may = self.entry_may.get(e.callee, empty)
                if not may <= cur_may:
                    self.entry_may[e.callee] = cur_may | may
                    changed = True
            if not changed:
                break

    # ------------------------------------------------------------------
    # consumers

    def held_at(self, acc: Access) -> FrozenSet[LockId]:
        entry = self.entry_must.get(acc.func.key) or frozenset()
        return acc.locks | entry

    def order_edges(self) -> List[Tuple[LockId, LockId, _Acquisition]]:
        """(held, acquired, site) for every acquisition made while some
        other lock may be held (lexically or via any caller).

        Cross-lock edges use the *may* entry set (an inversion exists if
        any path nests the pair); the self-edge — re-acquiring a
        non-reentrant ``Lock`` you already hold, an instant deadlock —
        uses lexical + *must* context only, so a public helper that is
        merely callable both ways doesn't false-positive."""
        out = []
        for acq in self.acquisitions:
            may = self.entry_may.get(acq.func.key, frozenset())
            must = self.entry_must.get(acq.func.key) or frozenset()
            for held in acq.held_before | may:
                if held != acq.lock:
                    out.append((held, acq.lock, acq))
            if acq.lock.kind == "lock" \
                    and acq.lock in (acq.held_before | must):
                out.append((acq.lock, acq.lock, acq))
        return out


class _FactWalker:
    """One pass over a single function body (nested defs excluded —
    they are separate FuncInfos) collecting calls, spawns, accesses and
    acquisitions with the lexical lock set threaded through."""

    def __init__(self, prog: Program, fi: FuncInfo):
        self.prog = prog
        self.fi = fi
        self.globals_decl: Set[str] = set()
        # locals constructed in this body (``x = SomeClass(...)``): they
        # are pre-publication, so writes through them are construction
        self.fresh: Set[str] = set()
        self.in_init = (fi.name in _INIT_NAMES and fi.cls is not None
                        and fi.parent is None)

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self._walk(stmt, frozenset())

    # -- statement/expression walk with lock context -------------------
    def _walk(self, node: ast.AST, locks: FrozenSet[LockId]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate FuncInfo / class scope
        if isinstance(node, ast.Global):
            self.globals_decl.update(node.names)
            return
        if isinstance(node, ast.With):
            inner = locks
            for item in node.items:
                self._visit_expr(item.context_expr, locks)
                lid = self.prog.resolve_lock(self.fi, item.context_expr)
                if lid is not None:
                    self.prog.acquisitions.append(_Acquisition(
                        func=self.fi, lock=lid, held_before=locks,
                        node=item.context_expr))
                    inner = inner | {lid}
            for child in node.body:
                self._walk(child, inner)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                self._record_store(t, locks,
                                   augmented=isinstance(node, ast.AugAssign))
            if node.value is not None:
                self._visit_expr(node.value, locks)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if self._is_fresh_ctor(node.value):
                    self.fresh.add(name)
                else:
                    self.fresh.discard(name)
            return
        if isinstance(node, ast.expr):
            self._visit_expr(node, locks)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, locks)

    def _visit_expr(self, node: ast.AST, locks: FrozenSet[LockId]) -> None:
        if isinstance(node, ast.Call):
            self._visit_call(node, locks)
            return
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            self._record_attr_access(node, locks, write=False)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            self._record_global_access(node, locks, write=False)
        if isinstance(node, ast.Lambda):
            return  # opaque; a lambda thread target stays unresolved
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, locks)
            else:
                self._walk(child, locks)

    # -- stores --------------------------------------------------------
    def _record_store(self, target: ast.AST, locks: FrozenSet[LockId],
                      augmented: bool = False) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._record_store(el, locks)
            return
        node = target
        if isinstance(node, ast.Subscript):
            self._visit_expr(node.slice, locks)
            node = node.value
        if isinstance(node, ast.Attribute):
            self._record_attr_access(node, locks, write=True)
            self._visit_expr(node.value, locks)
        elif isinstance(node, ast.Name):
            self._record_global_access(node, locks, write=True)

    def _record_attr_access(self, node: ast.Attribute,
                            locks: FrozenSet[LockId], write: bool) -> None:
        owner = self.prog.receiver_class(self.fi, node.value)
        if owner is None:
            return
        via_self = (isinstance(node.value, ast.Name)
                    and node.value.id == "self")
        owner_cls = self.fi.cls
        in_init = False
        if write:
            f = self.fi
            while f is not None:
                if f.parent is None and f.name in _INIT_NAMES \
                        and f.cls is not None and f.cls.key == owner:
                    in_init = True
                    break
                f = f.parent
            # alternate constructors build self before publication too
            if not in_init and self.fi.parent is None \
                    and owner_cls is not None and owner_cls.key == owner \
                    and _is_constructor_like(self.fi.node):
                in_init = True
        # a local built here is pre-publication regardless of its class
        if isinstance(node.value, ast.Name) and node.value.id in self.fresh:
            in_init = True
        self.prog.accesses.append(Access(
            owner=owner, attr=node.attr, write=write, func=self.fi,
            node=node, locks=locks, in_init=in_init, via_self=via_self))

    def _record_global_access(self, node: ast.Name,
                              locks: FrozenSet[LockId], write: bool) -> None:
        mod = self.prog.modules[self.fi.ctx.module]
        if write:
            if node.id not in self.globals_decl:
                return
            mod.globals_written.add(node.id)
        elif node.id not in mod.globals_written \
                and node.id not in self.globals_decl:
            return
        self.prog.accesses.append(Access(
            owner=self.fi.ctx.module, attr=node.id, write=write,
            func=self.fi, node=node, locks=locks, in_init=False,
            via_self=False))

    def _is_fresh_ctor(self, value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        dotted = _dotted(value.func)
        if not dotted:
            return False
        key = self.prog._resolve_class_name(self.fi.ctx, dotted)
        return key is not None and key in self.prog.classes

    # -- calls ---------------------------------------------------------
    def _visit_call(self, node: ast.Call, locks: FrozenSet[LockId]) -> None:
        prog, fi = self.prog, self.fi
        dotted = _dotted(node.func)
        is_thread_ctor = dotted is not None and (
            dotted in ("threading.Thread", "Thread")
            and self._names_threading(dotted))
        if is_thread_ctor:
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = prog.resolve_callable(fi, kw.value)
            prog.spawns.append(SpawnSite(
                kind="thread", func=fi, target=target, node=node,
                ctx=fi.ctx, owner_class=fi.cls))
            for a in node.args:
                self._visit_expr(a, locks)
            for kw in node.keywords:
                self._visit_expr(kw.value, locks)
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "submit" and node.args:
            target = prog.resolve_callable(fi, node.args[0])
            prog.spawns.append(SpawnSite(
                kind="submit", func=fi, target=target, node=node,
                ctx=fi.ctx, owner_class=fi.cls,
                borrowed=_receiver_is_param(fi, node.func.value)))
            if target:
                # pool workers run the submitted fn with a fresh stack;
                # root seeding (not a call edge) models the lock context
                pass
            for a in node.args[1:]:
                self._visit_expr(a, locks)
            self._visit_expr(node.func.value, locks)
            return
        # mutator calls count as writes on the receiver attribute
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS \
                and isinstance(node.func.value, ast.Attribute):
            self._record_attr_access(node.func.value, locks, write=True)
        callee = prog.resolve_callable(fi, node.func)
        if callee:
            prog.call_edges.append(CallEdge(
                caller=fi.key, callee=callee, locks=locks, node=node))
        # conservative: a function reference passed as an argument may
        # be invoked by the callee (callbacks, functools.partial, jit)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, (ast.Name, ast.Attribute)):
                ref = prog.resolve_callable(fi, arg)
                if ref and ref != callee:
                    prog.call_edges.append(CallEdge(
                        caller=fi.key, callee=ref, locks=locks,
                        node=arg, indirect=True))
        for a in node.args:
            self._visit_expr(a, locks)
        for kw in node.keywords:
            self._visit_expr(kw.value, locks)
        if isinstance(node.func, ast.Attribute):
            self._visit_expr(node.func.value, locks)

    def _names_threading(self, dotted: str) -> bool:
        if dotted == "threading.Thread":
            mod = self.prog.modules[self.fi.ctx.module]
            return mod.imports.get("threading", "threading") == "threading"
        mod = self.prog.modules[self.fi.ctx.module]
        src = mod.from_names.get("Thread")
        return src is not None and src[0] == "threading"


# ---------------------------------------------------------------------------
# small AST helpers


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _receiver_is_param(fi: FuncInfo, recv: ast.AST) -> bool:
    """True when ``recv`` names a parameter of the enclosing def (or of
    an enclosing def, for closures) — a pool passed in is owned by the
    caller, so its worker lifecycle is not this scope's to reap."""
    if not isinstance(recv, ast.Name):
        return False
    cur: Optional[FuncInfo] = fi
    while cur is not None:
        a = cur.node.args
        names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        if recv.id in names:
            return True
        cur = cur.parent
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.BoolOp):
        # ``self._lock = lock or threading.Lock()`` (injected-lock idiom)
        for v in value.values:
            kind = _lock_ctor_kind(v)
            if kind:
                return kind
        return None
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func)
    if not dotted:
        return None
    head, _, leaf = dotted.rpartition(".")
    if leaf in _LOCK_CTORS and head in ("", "threading"):
        return _LOCK_CTORS[leaf]
    return None


# Internally-synchronized stdlib primitives: mutating them without a
# user lock is safe by contract, so QT008 must not treat e.g.
# ``self._stop.clear()`` (an Event) as an unguarded write.
_SYNC_CTORS = {
    "Event": ("", "threading"),
    "Semaphore": ("", "threading"),
    "BoundedSemaphore": ("", "threading"),
    "Barrier": ("", "threading"),
    "Queue": ("", "queue"),
    "SimpleQueue": ("", "queue"),
    "LifoQueue": ("", "queue"),
    "PriorityQueue": ("", "queue"),
}


def _is_sync_ctor(value: ast.AST) -> bool:
    if isinstance(value, ast.BoolOp):
        return any(_is_sync_ctor(v) for v in value.values)
    if not isinstance(value, ast.Call):
        return False
    dotted = _dotted(value.func)
    if not dotted:
        return False
    head, _, leaf = dotted.rpartition(".")
    return leaf in _SYNC_CTORS and head in _SYNC_CTORS[leaf]


def _literal_guarded(cls: ast.ClassDef) -> Optional[Dict[str, str]]:
    for stmt in cls.body:
        target = value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            target, value = stmt.targets[0].id, stmt.value
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name) \
                and stmt.value is not None:
            target, value = stmt.target.id, stmt.value
        if target != "_guarded_by" or not isinstance(value, ast.Dict):
            continue
        out: Dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant) \
                    and isinstance(k.value, str) and isinstance(v.value, str):
                out[k.value] = v.value
        return out
    return None


_REQUIRES_RE = re.compile(
    r"#\s*quiverlint:\s*requires-lock\[([A-Za-z0-9_.\s,]+)\]")


def _requires_directives(ctx: ModuleContext, node: ast.AST) -> List[str]:
    """``# quiverlint: requires-lock[Class._lock]`` on the ``def`` line
    (or the comment line directly above it): the function's contract is
    that every caller already holds the named lock — the analyzer
    assumes it inside the body and verifies it at resolved call sites.
    """
    out: List[str] = []
    lineno = getattr(node, "lineno", 0)
    for ln in (lineno - 1, lineno):  # line above, then the def line
        if 1 <= ln <= len(ctx.lines):
            m = _REQUIRES_RE.search(ctx.lines[ln - 1])
            if m:
                out.extend(p.strip() for p in m.group(1).split(",")
                           if p.strip())
    return out


def _own_statements(node: ast.AST) -> Iterator[ast.AST]:
    """All descendant statements of a def, not descending into nested
    defs or classes (those are separate scopes)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def _is_constructor_like(node: ast.AST) -> bool:
    """classmethod constructors (``from_*`` / decorated classmethod that
    returns an instance) build objects before publication, like
    __init__."""
    decos = getattr(node, "decorator_list", [])
    for d in decos:
        if isinstance(d, ast.Name) and d.id == "classmethod":
            return True
    return False
