"""QT015 — collective discipline over the sharded tiers.

The mesh tier's correctness story rests on three structural facts:

  1. every axis a sharded structure names is one a :class:`Mesh`
     actually declares — a typo'd axis name surfaces at run time at
     best, or silently binds a different mesh dimension at worst;
  2. the halo combines are *bit-exact*: cross-shard reductions of
     float payloads use the ``pmax``-sentinel formulation, never
     ``psum`` (float addition is order-sensitive across shard
     layouts); ``psum`` is reserved for integer counts;
  3. every shard presents the same shape to a collective — an operand
     whose shape is data-dependent per shard (boolean-mask subscripts,
     ``nonzero`` / ``unique``) breaks the exchange's shape agreement.

The port is single-controller: its collectives are the in-process
functions ``psum`` / ``pmax`` / ``all_to_all`` / ``ppermute`` of
``dist/comm.py``, each over a list of per-shard tensors.  QT015 resolves
every call to them through the concurrency :class:`Program`'s module
index (imports at the top or in the def, and ``dist/comm.py``'s own
definitions), and checks all three statically.  Axis names are the operands of the mesh's
accessors (``Mesh.axis_devices``, ``mesh.shape[...]``,
``mesh/topology.row_shard``); they resolve through locals, closures,
constructor-frozen ``self`` attributes and cross-module constants
(``SHARD_AXIS``); declared axes are harvested from every ``Mesh(...)`` /
``make_mesh(...)`` / ``build_mesh(...)`` construction in the program.
The float-``psum`` check applies only inside
``LintConfig.bitexact_modules`` (default: the mesh tier), where every
part a ``psum`` adds must be *provably integer* — a
``.to(torch.int32)`` / ``.int()`` / ``.long()``, an integer
``dtype=``, a comparison, an integer literal, or a composition of those.

Unresolvable axis names or operands are skipped, not flagged: this
rule's findings must each be actionable.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterator, Optional, Sequence, Set, Tuple

from ..core import Finding, ModuleContext, ProgramRule, dotted_call_name

_COLLECTIVES = {"psum", "pmax", "all_to_all", "ppermute"}
# where the collectives live: ``<package>.dist.comm`` (or re-exported by
# ``<package>.dist``)
_COMM_MODULES = ("dist.comm", "dist")
_INT_PREFIXES = ("int", "uint", "bool", "long", "short")
_INT_METHODS = {"int", "long", "short", "bool"}
_SHAPE_POLYMORPHIC = {"nonzero", "unique", "flatnonzero", "argwhere",
                      "masked_select", "unique_consecutive"}
# accessors whose operand names a mesh axis: method -> positional index
_AXIS_METHODS = {"axis_devices": 0}
_AXIS_FUNCS = {"row_shard": 1}


def _leaf(dotted: Optional[str]) -> Optional[str]:
    return dotted.split(".")[-1] if dotted else None


class CollectiveDisciplineRule(ProgramRule):
    code = "QT015"
    name = "collective-discipline"
    description = ("sharded collectives and mesh accessors: undeclared "
                   "axis names, float psum in bit-exactness-contract "
                   "modules, per-shard data-dependent operand shapes")

    def check_program(self, ctxs: Sequence[ModuleContext],
                      ) -> Iterator[Finding]:
        from ..concurrency import build_program

        prog = build_program(ctxs)
        axes = _declared_axes(prog, ctxs)
        bitexact = tuple(getattr(ctxs[0].config, "bitexact_modules", ())
                         if ctxs else ())

        for fi in prog.functions.values():
            exact = _match_any(fi.ctx.relpath, bitexact)
            for node in _own_nodes(fi.node):
                if isinstance(node, ast.Subscript):
                    if (isinstance(node.value, ast.Attribute)
                            and node.value.attr == "shape"):
                        yield from self._check_axis(
                            prog, fi, node, node.slice, "shape[...]", axes)
                    continue
                if not isinstance(node, ast.Call):
                    continue
                axis = _axis_operand(prog, fi, node)
                if axis is not None:
                    yield from self._check_axis(prog, fi, node, axis[1],
                                                axis[0], axes)
                    continue
                leaf = _collective(prog, fi, node)
                if leaf is None or not node.args:
                    continue
                if leaf == "psum" and exact:
                    yield from self._check_psum(fi, node)
                yield from self._check_shape(fi, node, leaf)

    # -- axis names ------------------------------------------------------

    def _check_axis(self, prog, fi, node: ast.AST, axis_expr: ast.AST,
                    what: str, axes: Set[str]) -> Iterator[Finding]:
        if not axes:
            return      # no Mesh declared anywhere in the linted set
        for name in _axis_strings(prog, fi, axis_expr):
            if name not in axes:
                yield fi.ctx.finding(
                    self.code, node,
                    f"mesh accessor `{what}` names axis '{name}' but no "
                    f"Mesh in the program declares it (declared: "
                    f"{', '.join(sorted(axes))})")

    # -- bit-exactness ---------------------------------------------------

    def _check_psum(self, fi, node: ast.Call) -> Iterator[Finding]:
        operand = node.args[0]
        if _parts_int(fi, operand):
            return
        yield fi.ctx.finding(
            self.code, node,
            f"`psum` over `{ast.unparse(operand)}` in a bit-exactness-"
            f"contract module: float psum is reduction-order-sensitive "
            f"across shard layouts — use the pmax-sentinel combine for "
            f"payloads, or make integer counts provable with "
            f"`.to(torch.int32)`")

    # -- shape agreement -------------------------------------------------

    def _check_shape(self, fi, node: ast.Call,
                     leaf: str) -> Iterator[Finding]:
        operand = node.args[0]
        reason = _shape_data_dependent(fi, operand)
        if reason:
            yield fi.ctx.finding(
                self.code, node,
                f"`{leaf}` operand `{ast.unparse(operand)}` has a "
                f"data-dependent per-shard shape ({reason}) — every "
                f"shard must present the same shape to a collective; "
                f"pad to a static bucket first")


def _own_nodes(node: ast.AST) -> Iterator[ast.AST]:
    """Descendants of a def, not descending into nested defs / classes
    (their own FuncInfo walks them)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            continue
        yield child
        yield from _own_nodes(child)


def _qualified(prog, fi, func: ast.AST) -> Optional[str]:
    """Qualified name of a called name through the program's module
    index: ``psum`` after ``from ..dist.comm import psum`` (at the top or
    in the def) or inside ``dist/comm.py`` itself is
    ``<package>.dist.comm.psum``."""
    dotted = dotted_call_name(func)
    if not dotted:
        return None
    mod = prog.modules[fi.ctx.module]
    head, _, rest = dotted.partition(".")
    local = _local_import(prog, fi, head)
    if local is not None:
        base = local
    elif head in mod.from_names:
        m, a = mod.from_names[head]
        base = f"{m}.{a}"
    elif head in mod.imports:
        base = mod.imports[head]
    elif head in mod.functions:
        base = f"{fi.ctx.module}.{head}"
    else:
        return dotted
    return base + (f".{rest}" if rest else "")


def _local_import(prog, fi, name: str) -> Optional[str]:
    """Qualified name ``name`` was imported as inside the def (or an
    enclosing one): ``from .dist.comm import pmax`` in a method body."""
    f = fi
    while f is not None:
        for node in _own_nodes(f.node):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if (a.asname or a.name) == name:
                        base = prog._resolve_from(f.ctx, node)
                        return f"{base}.{a.name}"
        f = getattr(f, "parent", None)
    return None


def _collective(prog, fi, call: ast.Call) -> Optional[str]:
    """The collective ``call`` invokes, if any."""
    qual = _qualified(prog, fi, call.func)
    if not qual or "." not in qual:
        return None
    module, _, leaf = qual.rpartition(".")
    if leaf in _COLLECTIVES and any(module == m or module.endswith("." + m)
                                    for m in _COMM_MODULES):
        return leaf
    return None


def _axis_operand(prog, fi, call: ast.Call,
                  ) -> Optional[Tuple[str, ast.AST]]:
    """(accessor, axis expression) when ``call`` reads a mesh axis."""
    leaf = _leaf(dotted_call_name(call.func))
    if isinstance(call.func, ast.Attribute) and leaf in _AXIS_METHODS:
        idx = _AXIS_METHODS[leaf]
    elif leaf in _AXIS_FUNCS:
        idx = _AXIS_FUNCS[leaf]
    else:
        return None
    for kw in call.keywords:
        if kw.arg == "axis":
            return leaf, kw.value
    if len(call.args) > idx:
        return leaf, call.args[idx]
    return None


# ---------------------------------------------------------------------------
# declared axes: every Mesh(...) / make_mesh(...) / build_mesh(...)

_MESH_CTORS = {"Mesh", "make_mesh", "build_mesh"}


def _declared_axes(prog, ctxs: Sequence[ModuleContext]) -> Set[str]:
    axes: Set[str] = set()
    for fi in prog.functions.values():
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if _leaf(dotted_call_name(node.func)) not in _MESH_CTORS:
                continue
            exprs = list(node.args) + [kw.value for kw in node.keywords
                                       if kw.arg in ("axis_names", None)]
            for e in exprs:
                axes.update(_axis_strings(prog, fi, e))
    # module-level Mesh constructions (rare but legal)
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and _leaf(dotted_call_name(node.func)) in _MESH_CTORS):
                for e in list(node.args) + [kw.value
                                            for kw in node.keywords]:
                    for sub in ast.walk(e):
                        if isinstance(sub, ast.Constant) \
                                and isinstance(sub.value, str):
                            axes.add(sub.value)
    return axes


def _axis_strings(prog, fi, expr: ast.AST,
                  depth: int = 0) -> Iterator[str]:
    """Every axis-name string ``expr`` can denote, resolved through
    locals, closures, ctor-frozen self attributes and module constants.
    Yields nothing when unresolvable (callers must skip, not flag)."""
    if depth > 8:
        return
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, str):
            yield expr.value
        return
    if isinstance(expr, (ast.Tuple, ast.List)):
        for e in expr.elts:
            yield from _axis_strings(prog, fi, e, depth + 1)
        return
    if isinstance(expr, ast.Name):
        f = fi
        while f is not None:
            for v in _local_values(f, expr.id):
                yield from _axis_strings(prog, f, v, depth + 1)
                return
            default = _param_default(f, expr.id)
            if default is not None:
                yield from _axis_strings(prog, f, default, depth + 1)
                return
            f = getattr(f, "parent", None)
        yield from _module_const_strings(prog, fi.ctx, expr.id)
        return
    if isinstance(expr, ast.Attribute):
        recv_cls = None
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and fi.cls is not None:
            recv_cls = fi.cls.key
        else:
            recv_cls = prog.receiver_class(fi, expr.value)
        if recv_cls is not None:
            for ci in prog._mro(recv_cls):
                for m in ci.methods.values():
                    for node in ast.walk(m.node):
                        if not isinstance(node, ast.Assign):
                            continue
                        for t in node.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                    and t.attr == expr.attr):
                                yield from _axis_strings(
                                    prog, m, node.value, depth + 1)
        return


def _param_default(fi, name: str) -> Optional[ast.AST]:
    """The default of parameter ``name`` of the def, if it has one."""
    args = getattr(fi.node, "args", None)
    if args is None:
        return None
    pos = list(args.posonlyargs) + list(args.args)
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if a.arg == name:
            return d
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if a.arg == name:
            return d
    return None


def _local_values(fi, name: str) -> Iterator[ast.AST]:
    from ..staging.dataflow import ordered_nodes

    for node in ordered_nodes(fi.node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    yield node.value


def _module_const_strings(prog, ctx, name: str) -> Iterator[str]:
    mod = prog.modules.get(ctx.module)
    if mod is not None and name in mod.from_names:
        m, a = mod.from_names[name]
        target = prog.modules.get(m) or prog.modules.get(f"{m}.{a}")
        if target is not None:
            yield from _module_body_strings(target.ctx, a)
            return
    yield from _module_body_strings(ctx, name)


def _module_body_strings(ctx, name: str) -> Iterator[str]:
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str):
                    yield stmt.value.value


# ---------------------------------------------------------------------------
# provably-integer operands

def _parts_int(fi, parts: ast.AST) -> bool:
    """Every part of a collective's operand list is provably integer:
    a list / tuple of such parts, a comprehension whose element is one,
    or a name bound to either."""
    if isinstance(parts, (ast.List, ast.Tuple)):
        return all(_provably_int(fi, e, set()) for e in parts.elts)
    if isinstance(parts, (ast.ListComp, ast.GeneratorExp)):
        return _provably_int(fi, parts.elt, set())
    if isinstance(parts, ast.Name):
        f = fi
        while f is not None:
            vals = list(_local_values(f, parts.id))
            if vals:
                return all(_parts_int(f, v) for v in vals)
            f = getattr(f, "parent", None)
    return False


def _provably_int(fi, expr: ast.AST, visited: Set[str]) -> bool:
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (int, bool)) \
            and not isinstance(expr.value, float)
    if isinstance(expr, ast.Compare):
        return True                                # bool tensor
    if isinstance(expr, ast.BoolOp):
        return all(_provably_int(fi, v, visited) for v in expr.values)
    if isinstance(expr, ast.BinOp):
        return (not isinstance(expr.op, ast.Div)
                and _provably_int(fi, expr.left, visited)
                and _provably_int(fi, expr.right, visited))
    if isinstance(expr, ast.UnaryOp):
        return _provably_int(fi, expr.operand, visited)
    if isinstance(expr, ast.Subscript):
        return _provably_int(fi, expr.value, visited)
    if isinstance(expr, ast.Call):
        # .to(torch.int32) / .int() / .long() on any receiver, including
        # subscripts the dotted-name walk can't cross
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in _INT_METHODS and not expr.args:
                return True
            if expr.func.attr == "to":
                dtypes = [kw.value for kw in expr.keywords
                          if kw.arg == "dtype"] + list(expr.args)
                return any(_int_dtype(d) for d in dtypes)
        dotted = dotted_call_name(expr.func)
        leaf = _leaf(dotted)
        if dotted and dotted.startswith(("torch.", "np.", "numpy.")):
            for kw in expr.keywords:
                if kw.arg == "dtype":
                    return _int_dtype(kw.value)
            if leaf == "where" and len(expr.args) == 3:
                return (_provably_int(fi, expr.args[1], visited)
                        and _provably_int(fi, expr.args[2], visited))
            if leaf in ("sum", "count_nonzero", "argmax", "argmin",
                        "searchsorted", "arange", "argsort", "bincount") \
                    and expr.args:
                if leaf == "sum":
                    return _provably_int(fi, expr.args[0], visited)
                return leaf != "arange" or all(
                    _provably_int(fi, a, visited) for a in expr.args)
        return False
    if isinstance(expr, ast.Name):
        if expr.id in visited:
            return False
        visited.add(expr.id)
        f = fi
        while f is not None:
            vals = list(_local_values(f, expr.id))
            if vals:
                return all(_provably_int(f, v, visited) for v in vals)
            f = getattr(f, "parent", None)
        return False
    return False


def _int_dtype(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith(_INT_PREFIXES)
    dotted = dotted_call_name(expr)
    leaf = _leaf(dotted)
    return bool(leaf) and leaf.startswith(_INT_PREFIXES)


# ---------------------------------------------------------------------------
# per-shard shape dependence

def _shape_data_dependent(fi, operand: ast.AST) -> Optional[str]:
    for sub in ast.walk(operand):
        if isinstance(sub, ast.Call):
            leaf = _leaf(dotted_call_name(sub.func))
            if leaf in _SHAPE_POLYMORPHIC:
                return f"`{leaf}()` yields a data-dependent length"
            if leaf == "where" and len(sub.args) == 1:
                return "single-argument `where()` yields a " \
                       "data-dependent length"
        if isinstance(sub, ast.Subscript) and _is_mask_slice(fi,
                                                            sub.slice):
            return "boolean-mask subscript selects a data-dependent " \
                   "row count"
    return None


def _is_mask_slice(fi, sl: ast.AST) -> bool:
    if isinstance(sl, ast.Compare):
        return True
    if isinstance(sl, ast.Name):
        f = fi
        while f is not None:
            for v in _local_values(f, sl.id):
                return isinstance(v, ast.Compare)
            f = getattr(f, "parent", None)
    return False


def _match_any(relpath: str, patterns: Tuple[str, ...]) -> bool:
    return any(fnmatch.fnmatch(relpath, p) for p in patterns)
