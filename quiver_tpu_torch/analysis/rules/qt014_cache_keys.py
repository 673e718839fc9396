"""QT014 — unbounded executable-cache key.

Every distinct key inserted into a :class:`ProgramCache`
(``recovery/registry.py``) is one compiled XLA executable held for the
life of the process.  The repo's standing invariant is "0 new
executables steady-state" (``retrace_budget``, ``seal()``), but those
are *runtime* guards: they fire after warmup, on silicon, one blowup at
a time.  QT014 bounds the key's cardinality symbolically at lint time.

For each insertion site (``self._cache[key] = fn`` or
``cache.setdefault(key, fn)`` on an attribute initialised from
``program_cache(...)`` / ``ProgramCache(...)``), the key expression is
decomposed into components and each component must trace — through
locals, parameters (meet over resolved call sites), constructor-only
instance attributes, dataclass/NamedTuple fields (meet over
constructor sites) — to something finite:

  * a literal / bool / comparison,
  * a constructor-frozen config attribute (``self.n_shards``),
  * a bucket helper (``_pow2_bucket`` / ``_fresh_bucket`` /
    ``_fanout_bucket`` / ``_next_bucket`` — extendable via
    ``LintConfig.bucket_helpers``) or any function carrying a
    ``# quiverlint: bucketed[reason]`` directive on its def line,
  * ``len()`` / arithmetic / subscripts of such values.

A component fed by unbucketed runtime data — a raw batch size, a raw
delta count, a float, a tenant string — is a finding, because it is
exactly the retrace blowup ``seal()`` only reports after it happened.
An intentional raw key (a path whose callers all pad upstream) takes a
justified ``# quiverlint: ignore[QT014]`` on the insertion line.

Everything resolves over the concurrency :class:`Program` (call graph, classes)
plus the staging dataflow's instance typing for receiver attributes.
Unresolvable components are conservatively *unbounded*: an opaque key
is precisely the situation the rule exists for.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from ..core import Finding, ModuleContext, ProgramRule, dotted_call_name

_CACHE_FACTORIES = {"program_cache", "ProgramCache"}
# builtins through which boundedness propagates (result enumerable when
# every argument is)
_TRANSPARENT = {
    "len", "int", "bool", "str", "min", "max", "abs", "round", "tuple",
    "sorted", "frozenset", "hash",
}
# array metadata that is finite per deployment vs. per request
_BOUNDED_ATTRS = {"dtype", "ndim"}

_BUCKETED_RE = re.compile(r"#\s*quiverlint:\s*bucketed\[([^\]]*)\]")


def _has_bucketed_directive(ctx: ModuleContext, node: ast.AST) -> bool:
    """``# quiverlint: bucketed[reason]`` on the def line or the line
    directly above it blesses the function's result as bucketed."""
    for ln in (node.lineno - 1, node.lineno):
        if 1 <= ln <= len(ctx.lines) and _BUCKETED_RE.search(
                ctx.lines[ln - 1]):
            return True
    return False


class UnboundedExecutableKeyRule(ProgramRule):
    code = "QT014"
    name = "unbounded-executable-key"
    description = ("ProgramCache key component fed by unbucketed runtime "
                   "data — every distinct value compiles and retains a "
                   "fresh executable")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        from ..staging.dataflow import build_dataflow

        df = build_dataflow(ctxs)
        prog = df.prog
        bucket_helpers = set(
            getattr(ctxs[0].config, "bucket_helpers", ()) if ctxs else ())

        # -- pass 1: which attributes hold executable caches ------------
        cache_attrs: Set[Tuple[str, str]] = set()   # (clskey, attr)
        subsystems: Dict[Tuple[str, str], str] = {}
        for fi in prog.functions.values():
            if fi.cls is None:
                continue
            for node in ast.walk(fi.node):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                name = dotted_call_name(node.value.func)
                if not name or name.split(".")[-1] not in _CACHE_FACTORIES:
                    continue
                for t in node.targets:
                    attr = _self_attr_name(t)
                    if attr:
                        cache_attrs.add((fi.cls.key, attr))
                        if (node.value.args and isinstance(
                                node.value.args[0], ast.Constant)):
                            subsystems[(fi.cls.key, attr)] = str(
                                node.value.args[0].value)

        if not cache_attrs:
            return

        bound = _Boundedness(df, bucket_helpers)

        # -- pass 2: insertion sites -----------------------------------
        for fi in prog.functions.values():
            for node in ast.walk(fi.node):
                key_expr, attr_key = self._insertion(fi, node, cache_attrs,
                                                     prog)
                if key_expr is None:
                    continue
                subsystem = subsystems.get(attr_key, attr_key[1])
                for comp, why in bound.unbounded_components(fi, key_expr):
                    src = _unparse(comp)
                    yield fi.ctx.finding(
                        self.code, node,
                        f"ProgramCache['{subsystem}'] key component "
                        f"`{src}` is not provably bounded ({why}) — every "
                        f"distinct value compiles a fresh executable; "
                        f"bucket it (pow2/quarter-octave helper or a "
                        f"`# quiverlint: bucketed[...]` directive) or "
                        f"justify with ignore[QT014]")

    def _insertion(self, fi, node: ast.AST,
                   cache_attrs: Set[Tuple[str, str]], prog,
                   ) -> Tuple[Optional[ast.AST],
                              Optional[Tuple[str, str]]]:
        """(key expression, cache identity) when ``node`` inserts into a
        known cache, else (None, None)."""
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    ak = self._cache_of(fi, t.value, cache_attrs, prog)
                    if ak is not None:
                        return t.slice, ak
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "setdefault" and node.args):
            ak = self._cache_of(fi, node.func.value, cache_attrs, prog)
            if ak is not None:
                return node.args[0], ak
        return None, None

    def _cache_of(self, fi, recv: ast.AST,
                  cache_attrs: Set[Tuple[str, str]], prog,
                  ) -> Optional[Tuple[str, str]]:
        attr = _self_attr_name(recv)
        if attr is None or fi.cls is None:
            return None
        for ci in prog._mro(fi.cls.key):
            if (ci.key, attr) in cache_attrs:
                return (ci.key, attr)
        return None


def _self_attr_name(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse covers all exprs we see
        return f"<expr at line {getattr(node, 'lineno', '?')}>"


class _Boundedness:
    """Symbolic cardinality check over the program model."""

    def __init__(self, df, bucket_helpers: Set[str]):
        self.df = df
        self.prog = df.prog
        self.bucket_helpers = {
            "_pow2_bucket", "_fresh_bucket", "_fanout_bucket",
            "_next_bucket", "_pow2", "pow2_bucket",
        } | bucket_helpers
        self._assigns: Dict[str, Dict[str, List[ast.AST]]] = {}
        self._callers: Optional[Dict[str, List]] = None
        self._ctor_sites: Optional[Dict[str, List]] = None

    # -- public --------------------------------------------------------

    def unbounded_components(self, fi, key_expr: ast.AST,
                             ) -> Iterator[Tuple[ast.AST, str]]:
        comps = (key_expr.elts if isinstance(key_expr, ast.Tuple)
                 else [key_expr])
        for comp in comps:
            ok, why = self.bounded(fi, comp, set())
            if not ok:
                yield comp, why

    # -- core recursion -------------------------------------------------

    def bounded(self, fi, expr: ast.AST,
                visited: Set) -> Tuple[bool, str]:
        if isinstance(expr, ast.Constant):
            return True, ""
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            for e in expr.elts:
                ok, why = self.bounded(fi, e, visited)
                if not ok:
                    return ok, why
            return True, ""
        if isinstance(expr, ast.Compare):
            return True, ""                     # comparisons are bools
        if isinstance(expr, ast.BoolOp):
            for e in expr.values:
                ok, why = self.bounded(fi, e, visited)
                if not ok:
                    return ok, why
            return True, ""
        if isinstance(expr, ast.IfExp):
            ok, why = self.bounded(fi, expr.body, visited)
            if not ok:
                return ok, why
            return self.bounded(fi, expr.orelse, visited)
        if isinstance(expr, ast.BinOp):
            ok, why = self.bounded(fi, expr.left, visited)
            if not ok:
                return ok, why
            return self.bounded(fi, expr.right, visited)
        if isinstance(expr, ast.UnaryOp):
            return self.bounded(fi, expr.operand, visited)
        if isinstance(expr, ast.Subscript):
            # indexing a bounded structure yields a bounded value
            return self.bounded(fi, expr.value, visited)
        if isinstance(expr, ast.JoinedStr):
            for v in expr.values:
                if isinstance(v, ast.FormattedValue):
                    ok, why = self.bounded(fi, v.value, visited)
                    if not ok:
                        return False, f"f-string over {why}"
            return True, ""
        if isinstance(expr, ast.Name):
            return self._bounded_name(fi, expr.id, visited)
        if isinstance(expr, ast.Attribute):
            return self._bounded_attr(fi, expr, visited)
        if isinstance(expr, ast.Call):
            return self._bounded_call(fi, expr, visited)
        return False, f"opaque expression `{_unparse(expr)}`"

    # -- names ----------------------------------------------------------

    def _bounded_name(self, fi, name: str,
                      visited: Set) -> Tuple[bool, str]:
        key = ("name", fi.key, name)
        if key in visited:
            return True, ""                     # cycle: optimistic
        visited.add(key)

        assigns = self._local_assigns(fi).get(name)
        if assigns:
            for value in assigns:
                ok, why = self.bounded(fi, value, visited)
                if not ok:
                    return False, why
            return True, ""
        # enclosing defs (closures)
        f = fi.parent
        while f is not None:
            assigns = self._local_assigns(f).get(name)
            if assigns:
                for value in assigns:
                    ok, why = self.bounded(f, value, visited)
                    if not ok:
                        return False, why
                return True, ""
            f = f.parent
        if self._is_param(fi, name):
            return self._bounded_param(fi, name, visited)
        if self._module_constant(fi.ctx, name):
            return True, ""
        return False, f"`{name}` has no bounded definition in scope"

    def _local_assigns(self, fi) -> Dict[str, List[ast.AST]]:
        from ..staging.dataflow import ordered_nodes

        cached = self._assigns.get(fi.key)
        if cached is not None:
            return cached
        out: Dict[str, List[ast.AST]] = {}
        for node in ordered_nodes(fi.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._record_target(out, t, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._record_target(out, node.target, node.value)
            elif isinstance(node, ast.For):
                # element of a bounded iterable is bounded
                self._record_target(out, node.target, node.iter)
            elif isinstance(node, ast.NamedExpr):
                self._record_target(out, node.target, node.value)
        self._assigns[fi.key] = out
        return out

    @staticmethod
    def _record_target(out: Dict[str, List[ast.AST]], target: ast.AST,
                       value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                _Boundedness._record_target(out, e, value)
        elif isinstance(target, ast.Starred):
            _Boundedness._record_target(out, target.value, value)

    @staticmethod
    def _is_param(fi, name: str) -> bool:
        args = getattr(fi.node, "args", None)
        if args is None:
            return False
        every = (list(args.args) + list(args.kwonlyargs)
                 + list(args.posonlyargs))
        return any(a.arg == name for a in every)

    def _bounded_param(self, fi, name: str,
                       visited: Set) -> Tuple[bool, str]:
        """Meet over every resolved call site's argument."""
        key = ("param", fi.key, name)
        if key in visited:
            return True, ""
        visited.add(key)
        edges = self._caller_edges().get(fi.key, [])
        if not edges:
            return False, (f"parameter `{name}` of {fi.qual} has no "
                           f"resolvable call sites")
        args = fi.node.args
        names = [a.arg for a in args.args]
        offset = 1 if names and names[0] in ("self", "cls") else 0
        try:
            pos = names.index(name) - offset
        except ValueError:
            pos = None
        checked = False
        for caller_fi, call in edges:
            arg_expr = None
            if pos is not None and pos >= 0 and pos < len(call.args):
                a = call.args[pos]
                if not isinstance(a, ast.Starred):
                    arg_expr = a
            for kw in call.keywords:
                if kw.arg == name:
                    arg_expr = kw.value
            if arg_expr is None:
                # defaulted at this site: bounded iff the default is
                d = self._default_for(fi, name)
                if d is None:
                    return False, (f"argument `{name}` unresolvable at a "
                                   f"call site of {fi.qual}")
                arg_expr = d
            checked = True
            ok, why = self.bounded(caller_fi, arg_expr, visited)
            if not ok:
                return False, (f"argument `{name}` of {fi.qual} fed by "
                               f"{why}")
        if not checked:
            return False, f"parameter `{name}` of {fi.qual} never bound"
        return True, ""

    @staticmethod
    def _default_for(fi, name: str) -> Optional[ast.AST]:
        args = fi.node.args
        pos_args = list(args.args)
        defaults = list(args.defaults)
        for a, d in zip(reversed(pos_args), reversed(defaults)):
            if a.arg == name:
                return d
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if a.arg == name and d is not None:
                return d
        return None

    def _caller_edges(self) -> Dict[str, List]:
        """callee funckey -> [(caller FuncInfo, Call node)] over every
        resolvable call in the program."""
        if self._callers is not None:
            return self._callers
        out: Dict[str, List] = {}
        for fi in self.prog.functions.values():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.prog.resolve_callable(fi, node.func)
                if callee is not None:
                    out.setdefault(callee, []).append((fi, node))
        self._callers = out
        return out

    # -- attributes ------------------------------------------------------

    def _bounded_attr(self, fi, expr: ast.Attribute,
                      visited: Set) -> Tuple[bool, str]:
        if expr.attr in _BOUNDED_ATTRS:
            return True, ""
        src = _unparse(expr)
        attr = _self_attr_name(expr)
        if attr is not None and fi.cls is not None:
            return self._bounded_field(fi.cls.key, attr, src, visited)
        # non-self receiver: use the staging dataflow's instance typing
        v = self.df.classify(fi, expr.value)
        if v is not None and v.inst is not None:
            return self._bounded_field(v.inst, expr.attr, src, visited)
        clskey = self.prog.receiver_class(fi, expr.value)
        if clskey is not None:
            return self._bounded_field(clskey, expr.attr, src, visited)
        # a bounded receiver denotes finitely many objects (e.g. the
        # process-frozen config via a bucketed[] factory): its
        # attribute loads are bounded too
        ok, _ = self.bounded(fi, expr.value, visited)
        if ok:
            return True, ""
        return False, f"`{src}` has an unresolvable receiver"

    def _bounded_field(self, clskey: str, attr: str, src: str,
                       visited: Set) -> Tuple[bool, str]:
        key = ("field", clskey, attr)
        if key in visited:
            return True, ""
        visited.add(key)
        sites: List[Tuple] = []      # (owning fi, value expr)
        ctor_only = True
        for ci in self.prog._mro(clskey):
            # class-level assignment (annotated or not) is a frozen default
            for stmt in ci.node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id == attr
                        and stmt.value is not None):
                    sites.append((None, stmt.value))
                elif isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and t.id == attr:
                            sites.append((None, stmt.value))
            for mname, m in ci.methods.items():
                for node in ast.walk(m.node):
                    targets: List[ast.AST] = []
                    value: Optional[ast.AST] = None
                    if isinstance(node, ast.Assign):
                        targets, value = node.targets, node.value
                    elif isinstance(node, ast.AnnAssign) \
                            and node.value is not None:
                        targets, value = [node.target], node.value
                    for t in targets:
                        if _self_attr_name(t) == attr:
                            sites.append((m, value))
                            if mname not in ("__init__", "__post_init__"):
                                ctor_only = False
        if sites:
            if not ctor_only:
                return False, (f"`{src}` is reassigned outside the "
                               f"constructor")
            for m, value in sites:
                if m is None:
                    ok, why = self.bounded_classlevel(value)
                else:
                    ok, why = self.bounded(m, value, visited)
                if not ok:
                    return False, f"`{src}` <- {why}"
            return True, ""
        # dataclass / NamedTuple field: meet over constructor sites
        ci = self.prog.classes.get(clskey)
        if ci is not None and any(
                isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name) and s.target.id == attr
                for s in ci.node.body):
            return self._bounded_ctor_field(clskey, attr, src, visited)
        return False, f"`{src}` is never assigned anywhere visible"

    def bounded_classlevel(self, value: ast.AST) -> Tuple[bool, str]:
        for sub in ast.walk(value):
            if isinstance(sub, (ast.Name, ast.Call, ast.Attribute)):
                return False, "non-literal class-level default"
        return True, ""

    def _bounded_ctor_field(self, clskey: str, attr: str, src: str,
                            visited: Set) -> Tuple[bool, str]:
        ci = self.prog.classes[clskey]
        fields = [s.target.id for s in ci.node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        try:
            pos = fields.index(attr)
        except ValueError:
            return False, f"`{src}` not a declared field"
        sites = self._class_ctor_sites().get(clskey, [])
        if not sites:
            return False, f"`{src}`: no visible constructor site"
        for caller_fi, call in sites:
            arg_expr = None
            if pos < len(call.args) and not isinstance(call.args[pos],
                                                       ast.Starred):
                arg_expr = call.args[pos]
            for kw in call.keywords:
                if kw.arg == attr:
                    arg_expr = kw.value
            if arg_expr is None:
                continue        # defaulted — class-level default, finite
            ok, why = self.bounded(caller_fi, arg_expr, visited)
            if not ok:
                return False, f"`{src}` <- {why}"
        return True, ""

    def _class_ctor_sites(self) -> Dict[str, List]:
        if self._ctor_sites is not None:
            return self._ctor_sites
        out: Dict[str, List] = {}
        for fi in self.prog.functions.values():
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                dotted = dotted_call_name(node.func)
                if not dotted:
                    continue
                clskey = self.prog._resolve_class_name(fi.ctx, dotted)
                if clskey is not None:
                    out.setdefault(clskey, []).append((fi, node))
        self._ctor_sites = out
        return out

    # -- module-level constants -----------------------------------------

    @staticmethod
    def _module_constant(ctx, name: str) -> bool:
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return all(
                            isinstance(sub, (ast.Constant, ast.Tuple,
                                             ast.List, ast.Load))
                            or isinstance(sub, ast.expr_context)
                            for sub in ast.walk(stmt.value))
        return False

    # -- calls -----------------------------------------------------------

    def _bounded_call(self, fi, call: ast.Call,
                      visited: Set) -> Tuple[bool, str]:
        dotted = dotted_call_name(call.func)
        leaf = dotted.split(".")[-1] if dotted else None
        if leaf in self.bucket_helpers:
            return True, ""
        if dotted in _TRANSPARENT:
            for a in call.args:
                ok, why = self.bounded(fi, a, visited)
                if not ok:
                    return False, f"`{dotted}()` of {why}"
            return True, ""
        callee = self.prog.resolve_callable(fi, call.func)
        if callee is None and isinstance(call.func, ast.Name):
            callee = self._deferred_import_key(fi, call.func.id)
        if callee is not None:
            m = self.prog.functions.get(callee)
            if m is not None:
                if _has_bucketed_directive(m.ctx, m.node):
                    return True, ""
                return self._bounded_returns(m, visited)
        src = _unparse(call)
        return False, f"opaque call `{src}`"

    def _deferred_import_key(self, fi, name: str) -> Optional[str]:
        """Resolve ``name`` bound by a function-level ``from X import``
        (the repo's deferred-import idiom for cycle breaking) to a
        program funckey."""
        from ..core import _dotted_module
        from ..staging.dataflow import ordered_nodes

        f = fi
        while f is not None:
            for n in ordered_nodes(f.node):
                if not isinstance(n, ast.ImportFrom):
                    continue
                for alias in n.names:
                    if (alias.asname or alias.name) != name:
                        continue
                    here = _dotted_module(f.ctx.relpath).split(".")
                    if f.ctx.relpath.endswith("__init__.py"):
                        pkg = here
                    else:
                        pkg = here[:-1]
                    if n.level:
                        pkg = pkg[: len(pkg) - (n.level - 1)]
                        base = pkg
                    else:
                        base = []
                    mod = ".".join(base + (n.module.split(".")
                                           if n.module else []))
                    return f"{mod}:{alias.name}"
            f = getattr(f, "parent", None)
        return None

    def _bounded_returns(self, fi, visited: Set) -> Tuple[bool, str]:
        from ..staging.dataflow import ordered_nodes

        key = ("ret", fi.key)
        if key in visited:
            return True, ""
        visited.add(key)
        rets = [n for n in ordered_nodes(fi.node)
                if isinstance(n, ast.Return) and n.value is not None]
        if not rets:
            return False, f"`{fi.qual}()` returns nothing bounded"
        for r in rets:
            ok, why = self.bounded(fi, r.value, visited)
            if not ok:
                return False, f"`{fi.qual}()` may return {why}"
        return True, ""
