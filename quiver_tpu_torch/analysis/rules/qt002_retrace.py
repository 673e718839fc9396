"""QT002 — retrace hazards.

A compiled function is keyed by (function identity, guarded shapes and
values); a kernel library is built once per source hash and loaded once
per process.  Four Python-side patterns silently defeat that and turn a
"compile once, serve forever" pipeline into a compile-per-call one:

  * a fresh ``lambda`` passed to ``torch.compile`` / ``torch.jit.script``
    / ``torch.jit.trace`` at a call site — every call makes a new
    function object, so the compile cache can never hit (unless the
    caller caches the wrapped result; if it provably does, suppress with
    a justification or restructure to ``torch.compile(self._method)``);
  * any compile entry, or a call of one of the package's builders
    (``ops/cuda/build.build_all`` / ``load_libraries``,
    ``cpp/native.build`` / ``load``, ``ctypes.CDLL``), inside a loop body
    — one compile, build or library load per iteration.  The builder
    modules themselves are exempt: ``load_libraries`` loops over names
    by design, and ``build.load`` is a cached symbol lookup, no builder;
  * a ``@torch.compile``-decorated function whose plain parameter flows
    into a shape (``torch.zeros(n)``, ``x.reshape(b, -1)``,
    ``x.new_zeros(n)``): Dynamo specializes on each distinct value, i.e.
    recompiles.  Pass ``dynamic=True`` (and bucket its values) or derive
    the size from an input tensor's shape;
  * a ``@torch.compile``-decorated function reading ``self.<attr>``:
    Dynamo guards on the instance, so every instance (and every
    mutation of the attribute) is a recompile, and ``torch.compile``
    directly on a method traces ``self`` as an argument.  Bind the
    needed values to locals before the ``def``.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import Finding, ModuleContext, Rule, dotted_call_name

_COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
# qualified-name suffixes of the package's builders, and the one
# standard-library loader
_BUILDERS = ("ops.cuda.build.build_all", "ops.cuda.build.load_libraries",
             "cpp.native.build", "cpp.native.load")
_STDLIB_BUILDERS = {"ctypes.CDLL"}
_BUILDER_MODULES = ("*ops/cuda/build.py", "*cpp/native.py")

# func dotted name -> which positional args are shape-like
# ("first" = arg 0 incl. tuple elements, "all" = every positional arg)
_SHAPE_FUNCS = {
    "torch.zeros": "all", "torch.ones": "all", "torch.empty": "all",
    "torch.full": "first", "torch.eye": "all", "torch.arange": "all",
}
_SHAPE_METHODS = {
    "reshape": "all", "view": "all", "expand": "all",
    "new_zeros": "all", "new_ones": "all", "new_empty": "all",
    "new_full": "first",
}


def _is_compile(func: ast.AST) -> bool:
    return dotted_call_name(func) in _COMPILE_NAMES


def _compile_decoration(dec: ast.AST) -> Optional[bool]:
    """``dynamic`` if ``dec`` is a ``torch.compile`` decorator (bare
    ``@torch.compile``, ``@torch.compile(...)``, or
    ``@partial(torch.compile, ...)``), else None."""
    if dotted_call_name(dec) == "torch.compile":
        return False
    if not isinstance(dec, ast.Call):
        return None
    kwargs = None
    if dotted_call_name(dec.func) == "torch.compile":
        kwargs = dec.keywords
    elif (dotted_call_name(dec.func) in ("functools.partial", "partial")
          and dec.args and dotted_call_name(dec.args[0]) == "torch.compile"):
        kwargs = dec.keywords
    if kwargs is None:
        return None
    return any(kw.arg == "dynamic" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in kwargs)


def _param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def _shape_name_uses(fn: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(param-candidate name, node) pairs where a bare Name appears in a
    shape position inside ``fn``."""

    def names_in(expr: ast.AST) -> Iterator[str]:
        if isinstance(expr, ast.Name):
            yield expr.id
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                if isinstance(e, ast.Name):
                    yield e.id

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_call_name(node.func)
        spec = _SHAPE_FUNCS.get(name or "")
        if spec is None and isinstance(node.func, ast.Attribute) \
                and not (name or "").startswith("torch."):
            spec = _SHAPE_METHODS.get(node.func.attr)
        if spec == "first" and node.args:
            picked = [node.args[0]]
        elif spec == "all":
            picked = list(node.args)
        else:
            picked = []
        for arg in picked:
            for n in names_in(arg):
                yield n, node


def _imported_names(ctx: ModuleContext) -> Dict[str, str]:
    """local name -> qualified name, from the module's imports (relative
    imports resolved against the module's own dotted name)."""
    out: Dict[str, str] = {}
    pkg = ctx.module.split(".")
    if not ctx.relpath.endswith("__init__.py"):
        pkg = pkg[:-1]
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - (node.level - 1)] \
                    if node.level > 1 else list(pkg)
                mod = ".".join(base + ([node.module] if node.module
                                       else []))
            else:
                mod = node.module or ""
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{mod}.{a.name}"
    return out


def _is_builder(func: ast.AST, imports: Dict[str, str]) -> bool:
    dotted = dotted_call_name(func)
    if not dotted:
        return False
    head, _, rest = dotted.partition(".")
    qual = imports.get(head, head) + (f".{rest}" if rest else "")
    return qual in _STDLIB_BUILDERS or any(
        qual == b or qual.endswith("." + b) for b in _BUILDERS)


class RetraceRule(Rule):
    code = "QT002"
    name = "retrace-hazard"
    description = ("compile and build call-site and signature patterns "
                   "that defeat the compile and library caches (fresh "
                   "closures, compiles or builds in loops, shape-affecting "
                   "parameters, instance capture)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        builders = not any(fnmatch.fnmatch(ctx.relpath, p)
                           for p in _BUILDER_MODULES)
        imports = _imported_names(ctx) if builders else {}
        yield from self._call_sites(ctx.tree, ctx, False, builders, imports)
        yield from self._decorated(ctx)

    # -- torch.compile(...) and builder call sites ---------------------
    def _call_sites(self, node: ast.AST, ctx: ModuleContext, in_loop: bool,
                    builders: bool, imports: Dict[str, str],
                    ) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            child_in_loop = in_loop or isinstance(child, (ast.For,
                                                          ast.While))
            if isinstance(child, ast.Call) and _is_compile(child.func):
                what = dotted_call_name(child.func)
                if in_loop:
                    yield ctx.finding(
                        self.code, child,
                        f"{what}(...) inside a loop: one fresh compiled "
                        "program per iteration; hoist and cache it")
                elif child.args and isinstance(child.args[0], ast.Lambda):
                    yield ctx.finding(
                        self.code, child,
                        f"fresh lambda passed to {what}: each evaluation "
                        "creates a new function object, so the compile "
                        "cache never hits; compile a named function "
                        "instead")
            elif (in_loop and builders and isinstance(child, ast.Call)
                  and _is_builder(child.func, imports)):
                yield ctx.finding(
                    self.code, child,
                    f"{dotted_call_name(child.func)}(...) inside a loop: "
                    "a kernel build or library load per iteration; build "
                    "once, before the loop")
            yield from self._call_sites(child, ctx, child_in_loop,
                                        builders, imports)

    # -- @torch.compile-decorated defs ---------------------------------
    def _decorated(self, ctx: ModuleContext) -> Iterator[Finding]:
        for qual, fn in ctx.functions:
            dynamic: Optional[bool] = None
            for dec in fn.decorator_list:
                dynamic = _compile_decoration(dec)
                if dynamic is not None:
                    break
            if dynamic is None:
                continue
            params = set(_param_names(fn))
            reported: Set[str] = set()
            for name, node in _shape_name_uses(fn):
                if name in params and not dynamic \
                        and name not in reported:
                    reported.add(name)
                    yield ctx.finding(
                        self.code, node,
                        f"plain parameter `{name}` flows into a shape: "
                        "Dynamo specializes on every distinct value and "
                        "recompiles; pass dynamic=True (and bucket its "
                        "values) or derive the size from an input "
                        "tensor's shape",
                        scope=qual)
            if "self" in params:
                yield ctx.finding(
                    self.code, fn,
                    "torch.compile on a method traces `self` as an "
                    "argument (guards and recompiles per instance); "
                    "compile a free function or a closure over explicit "
                    "locals",
                    scope=qual)
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                    yield ctx.finding(
                        self.code, node,
                        f"compiled function reads `self.{node.attr}`: "
                        "Dynamo guards on the instance, so every "
                        "instance and every mutation recompiles; bind it "
                        "to a local before the def",
                        scope=qual)
                    break
