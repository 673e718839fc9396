"""Staging dataflow — DEVICE / HOST / EITHER value classification.

quiverlint v3's interprocedural tier.  The per-file rules (QT001) stop
at function boundaries: ``out = self._fused_forward(padded)`` looks like
an opaque call, so the ``np.asarray(out)`` two lines later goes
unflagged even though the callee returns a live device array.  This
module layers a residency lattice over the concurrency :class:`Program` model —
same file set, same name resolution, same call graph — and solves it to
a fixed point across calls, returns, attribute loads, and containers.

Lattice (per value)::

        EITHER          may be device- or host-resident
        /    \\
    DEVICE   HOST       proven residency
        \\    /
        (unknown)       bottom — never reported

Each classified value also carries:

* ``hot`` — True when its device-ness originated inside a hot module
  (the sampler/feature/serving/mesh pipeline).  A harness file like
  ``bench.py`` computing its own throwaway ``jnp`` arrays stays cold;
  the batch it got back from ``sampler.sample`` is hot, and coercing
  *that* is a finding.
* ``inst`` — the class key when the value is a known instance
  (``wb = sampler.sample(...)`` → ``SampledBatch``), which is how
  ``wb.n_id`` resolves to the device field annotation three files away.

Sources: ``jnp.*`` / ``jax.*`` calls are DEVICE; numpy calls, casts,
``len()``, ``.item()`` / ``.tolist()``, ``jax.device_get`` and array
metadata (``.shape`` / ``.dtype`` / ...) are HOST; joins of both are
EITHER.  ``B = seeds.shape[0]`` is therefore host — shape metadata
never costs a transfer — which is what keeps the cache-key rule
(QT014) and this one from tripping over ordinary batch-size plumbing.

Everything is stdlib AST analysis; building the flow for the whole
repo shares the one memoized :func:`build_program` model and is itself
memoized per context list (QT013/14/15 all read the same solve).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..concurrency import build_program
from ..concurrency.program import (
    FuncInfo,
    Program,
    _dotted,
    _self_attr,
)
from ..core import ModuleContext

__all__ = [
    "DEVICE", "EITHER", "HOST", "Dataflow", "Val", "build_dataflow", "join",
]

DEVICE = "device"
HOST = "host"
EITHER = "either"


@dataclass(frozen=True)
class Val:
    """Abstract value: residency class + hot-path origin + instance type."""

    cls: Optional[str] = None      # DEVICE | HOST | EITHER | None
    hot: bool = False              # device-ness born in a hot module
    inst: Optional[str] = None     # class key for known instances
    fn: bool = False               # jitted callable: calling it -> DEVICE


def join(a: Optional[Val], b: Optional[Val]) -> Optional[Val]:
    if a is None:
        return b
    if b is None:
        return a
    if a.cls is None:
        cls = b.cls
    elif b.cls is None or a.cls == b.cls:
        cls = a.cls
    else:
        cls = EITHER
    inst = a.inst if a.inst == b.inst else None
    return Val(cls=cls, hot=a.hot or b.hot, inst=inst, fn=a.fn or b.fn)


def broadcast(a: Optional[Val], b: Optional[Val]) -> Optional[Val]:
    """Join under array-op semantics: ``dev + 0`` / ``dev > 0`` is a
    device array (jax broadcasts the host scalar up), so DEVICE wins a
    mixed pairing instead of widening to EITHER."""
    j = join(a, b)
    if j is not None and j.cls == EITHER:
        if (a is not None and a.cls == DEVICE) or \
                (b is not None and b.cls == DEVICE):
            return Val(cls=DEVICE, hot=j.hot, inst=j.inst, fn=j.fn)
    return j


_DEVICE_ROOTS = {"jnp", "jax"}
_HOST_ROOTS = {"np", "numpy", "math"}
_HOST_CALLS = {
    "jax.device_get", "int", "float", "bool", "str", "repr", "len",
    "range", "hash",
}
_HOST_METHODS = {"item", "tolist"}
# metadata reads are free: aval fields live on the host-side handle
_METADATA_ATTRS = {
    "shape", "dtype", "ndim", "size", "nbytes", "itemsize", "weak_type",
    "sharding",
}
# builtins transparent to residency: classify as the join of their args
_TRANSPARENT_CALLS = {
    "list", "tuple", "set", "sorted", "reversed", "sum", "min", "max",
    "abs", "zip", "enumerate", "next", "iter",
}
# staging transforms: the *result* is a callable whose outputs live on
# device — not a device value itself (``if fn is None`` is not a sync)
_DEVICE_FN_CALLS = {
    "jax.jit", "jax.pmap", "pmap", "pjit", "jit", "shard_map",
    "jax.experimental.shard_map.shard_map", "jax.experimental.pjit.pjit",
}

_MAX_PASSES = 10


def ordered_nodes(node: ast.AST):
    """Descendant nodes of a def in source order, not descending into
    nested defs / classes / lambdas (separate scopes with their own
    FuncInfo).  The nested def/class node itself IS yielded — a
    ``@jax.jit``-decorated nested def binds a callable name in this
    scope."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Lambda):
            continue
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            continue
        yield from ordered_nodes(child)


def _ann_residency(ann: Optional[ast.AST]) -> Optional[str]:
    """DEVICE/HOST hint from an annotation expression, if any."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        txt = ann.value
        if txt.startswith(("jnp.", "jax.")):
            return DEVICE
        if txt.startswith(("np.", "numpy.")):
            return HOST
        return None
    if isinstance(ann, ast.Subscript):      # Optional[jnp.ndarray] etc.
        inner = ann.slice
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return _ann_residency(inner)
    dotted = _dotted(ann)
    if dotted:
        root = dotted.split(".")[0]
        if root in _DEVICE_ROOTS:
            return DEVICE
        if root in _HOST_ROOTS and dotted.split(".")[-1] == "ndarray":
            return HOST
    return None


class Dataflow:
    """Solved residency facts over one :class:`Program`."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.ret: Dict[str, Val] = {}             # funckey -> return val
        self.param: Dict[Tuple[str, str], Val] = {}
        self.attr: Dict[Tuple[str, str], Val] = {}   # (clskey, attr)
        self.envs: Dict[str, Dict[str, Val]] = {}    # funckey -> locals
        self._fields: Dict[str, List[str]] = {}      # dataclass field order
        self._changed = False
        self._seed()
        self._solve()

    # ------------------------------------------------------------------
    # seeding: class field annotations give cross-module ground truth

    def _seed(self) -> None:
        for ci in self.prog.classes.values():
            hot = ci.ctx.is_hot()
            fields: List[str] = []
            for stmt in ci.node.body:
                if not isinstance(stmt, ast.AnnAssign) \
                        or not isinstance(stmt.target, ast.Name):
                    continue
                fields.append(stmt.target.id)
                res = _ann_residency(stmt.annotation)
                if res is not None:
                    self.attr[(ci.key, stmt.target.id)] = Val(
                        cls=res, hot=hot and res == DEVICE)
            self._fields[ci.key] = fields

    # ------------------------------------------------------------------
    # fixpoint driver

    def _solve(self) -> None:
        for _ in range(_MAX_PASSES):
            self._changed = False
            for fi in self.prog.functions.values():
                self._pass(fi)
            if not self._changed:
                break

    def _join_into(self, table: Dict, key, val: Optional[Val]) -> None:
        if val is None or (val.cls is None and val.inst is None
                           and not val.fn):
            return
        old = table.get(key)
        new = join(old, val)
        if new != old:
            table[key] = new
            self._changed = True

    # ------------------------------------------------------------------
    # per-function abstract interpretation

    def _pass(self, fi: FuncInfo) -> None:
        env = self.envs.setdefault(fi.key, {})
        self._seed_params(fi, env)
        self._walk(fi, fi.node, env)

    def _seed_params(self, fi: FuncInfo, env: Dict[str, Val]) -> None:
        args = getattr(fi.node, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                if a.arg == "self" and fi.cls is not None:
                    env["self"] = Val(inst=fi.cls.key)
                    continue
                res = _ann_residency(a.annotation)
                seeded = Val(cls=res, hot=res == DEVICE
                             and fi.ctx.is_hot()) if res else None
                v = join(seeded, self.param.get((fi.key, a.arg)))
                if v is not None:
                    env[a.arg] = v
                elif a.annotation is not None:
                    t = fi.local_types.get(a.arg)
                    if t:
                        env[a.arg] = Val(inst=t)

    def _walk(self, fi: FuncInfo, node: ast.AST,
              env: Dict[str, Val]) -> None:
        for stmt in ordered_nodes(node):
            self._stmt(fi, stmt, env)

    def replay(self, fi: FuncInfo, visit) -> None:
        """Flow-sensitive re-walk for the rules: re-interpret ``fi`` in
        source order against the *solved* interprocedural tables,
        calling ``visit(node, env)`` at every node with the local env as
        it stands at that program point.  A name not yet bound locally
        falls back to the fixpoint env (loop-carried values); a name
        rebound through a materializer is HOST from that point on, so a
        branch-local DEVICE doesn't leak into the other branch the way
        the flow-insensitive final env would."""
        env: Dict[str, Val] = {}
        self._seed_params(fi, env)
        for node in ordered_nodes(fi.node):
            visit(node, env)
            self._stmt(fi, node, env)

    def _stmt(self, fi: FuncInfo, stmt: ast.AST,
              env: Dict[str, Val]) -> None:
        if isinstance(stmt, ast.Assign):
            v = self.classify(fi, stmt.value, env)
            for t in stmt.targets:
                self._bind(fi, t, v, env)
        elif isinstance(stmt, ast.AugAssign):
            v = self.classify(fi, stmt.value, env)
            if isinstance(stmt.target, ast.Name):
                env[stmt.target.id] = join(env.get(stmt.target.id), v) \
                    or Val()
            else:
                self._bind(fi, stmt.target, v, env)
        elif isinstance(stmt, ast.AnnAssign):
            res = _ann_residency(stmt.annotation)
            v = Val(cls=res, hot=res == DEVICE and fi.ctx.is_hot()) \
                if res else (self.classify(fi, stmt.value, env)
                             if stmt.value is not None else None)
            self._bind(fi, stmt.target, v, env)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._join_into(self.ret, fi.key,
                                self.classify(fi, stmt.value, env))
        elif isinstance(stmt, ast.For):
            self._bind(fi, stmt.target,
                       self._element_of(fi, stmt.iter, env), env)
        elif isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            for item in stmt.items:
                v = self.classify(fi, item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(fi, item.optional_vars, v, env)
        elif isinstance(stmt, ast.Expr):
            self.classify(fi, stmt.value, env)
        elif isinstance(stmt, (ast.If, ast.While)):
            self.classify(fi, stmt.test, env)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # @jax.jit def fn(...) binds a jitted callable in this scope
            for d in stmt.decorator_list:
                dd = _dotted(d)
                if dd is None and isinstance(d, ast.Call):
                    dd = _dotted(d.func)
                    if dd not in _DEVICE_FN_CALLS and d.args:
                        dd = _dotted(d.args[0])   # @partial(jax.jit, ...)
                if dd in _DEVICE_FN_CALLS:
                    env[stmt.name] = Val(fn=True, hot=fi.ctx.is_hot())
                    break
        # compound bodies are visited by _own_statements' flattening

    def _bind(self, fi: FuncInfo, target: ast.AST, v: Optional[Val],
              env: Dict[str, Val]) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = v or Val()
        elif isinstance(target, (ast.Tuple, ast.List)):
            vv = self._element_val(v)
            for e in target.elts:
                self._bind(fi, e, vv, env)
        elif isinstance(target, ast.Starred):
            self._bind(fi, target.value, v, env)
        else:
            attr = _self_attr(target)
            if attr and fi.cls is not None:
                self._join_into(self.attr, (fi.cls.key, attr), v)

    @staticmethod
    def _element_val(v: Optional[Val]) -> Optional[Val]:
        """Value of one element of ``v`` (tuple unpack / iteration):
        residency survives, instance identity doesn't."""
        if v is None:
            return None
        return Val(cls=v.cls, hot=v.hot)

    def _element_of(self, fi: FuncInfo, expr: ast.AST,
                    env: Dict[str, Val]) -> Optional[Val]:
        return self._element_val(self.classify(fi, expr, env))

    # ------------------------------------------------------------------
    # expression classification

    def lookup(self, fi: FuncInfo, name: str) -> Optional[Val]:
        """Name lookup through the enclosing-def chain (closures)."""
        f: Optional[FuncInfo] = fi
        while f is not None:
            env = self.envs.get(f.key)
            if env and name in env:
                return env[name]
            f = f.parent
        return None

    def attr_val(self, clskey: str, attr: str) -> Optional[Val]:
        for ci in self.prog._mro(clskey):
            v = self.attr.get((ci.key, attr))
            if v is not None:
                return v
        return None

    def classify(self, fi: FuncInfo, expr: Optional[ast.AST],
                 env: Optional[Dict[str, Val]] = None) -> Optional[Val]:
        if expr is None:
            return None
        if env is None:
            env = self.envs.get(fi.key, {})
        return self._classify(fi, expr, env)

    def _classify(self, fi: FuncInfo, expr: ast.AST,
                  env: Dict[str, Val]) -> Optional[Val]:
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            v = self.lookup(fi, expr.id)
            if v is not None:
                return v
            t = fi.local_types.get(expr.id)
            return Val(inst=t) if t else None
        if isinstance(expr, ast.Constant):
            # None is "no value", not a host value: `self.paged = None`
            # must not poison the later PagedStore assignment to EITHER
            return None if expr.value is None else Val(cls=HOST)
        if isinstance(expr, ast.JoinedStr):
            return Val(cls=HOST)
        if isinstance(expr, ast.Call):
            return self._classify_call(fi, expr, env)
        if isinstance(expr, ast.Attribute):
            return self._classify_attr(fi, expr, env)
        if isinstance(expr, ast.Subscript):
            return self._classify_subscript(fi, expr, env)
        if isinstance(expr, ast.BinOp):
            return broadcast(self._classify(fi, expr.left, env),
                             self._classify(fi, expr.right, env))
        if isinstance(expr, ast.UnaryOp):
            return self._classify(fi, expr.operand, env)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return Val(cls=HOST)       # identity tests are python bools
            v = self._classify(fi, expr.left, env)
            for c in expr.comparators:
                v = broadcast(v, self._classify(fi, c, env))
            return self._element_val(v)
        if isinstance(expr, ast.BoolOp):
            v = None
            for e in expr.values:
                v = join(v, self._classify(fi, e, env))
            return v
        if isinstance(expr, ast.IfExp):
            return join(self._classify(fi, expr.body, env),
                        self._classify(fi, expr.orelse, env))
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            v = None
            for e in expr.elts:
                v = join(v, self._classify(fi, e, env))
            return self._element_val(v) if v else None
        if isinstance(expr, ast.Dict):
            v = None
            for e in expr.values:
                if e is not None:
                    v = join(v, self._classify(fi, e, env))
            return self._element_val(v) if v else None
        if isinstance(expr, ast.Starred):
            return self._classify(fi, expr.value, env)
        if isinstance(expr, ast.Await):
            return self._classify(fi, expr.value, env)
        if isinstance(expr, ast.NamedExpr):
            v = self._classify(fi, expr.value, env)
            if isinstance(expr.target, ast.Name):
                env[expr.target.id] = v or Val()
            return v
        return None

    def _classify_call(self, fi: FuncInfo, call: ast.Call,
                       env: Dict[str, Val]) -> Optional[Val]:
        dotted = _dotted(call.func)
        arg_vals = [self._classify(fi, a, env) for a in call.args]
        any_hot = any(v.hot for v in arg_vals if v is not None)
        if dotted:
            root = dotted.split(".")[0]
            if dotted in _HOST_CALLS or root in _HOST_ROOTS:
                return Val(cls=HOST)
            if dotted in _TRANSPARENT_CALLS:
                v = None
                for av in arg_vals:
                    v = join(v, av)
                return v
            if dotted in _DEVICE_FN_CALLS:
                return Val(fn=True, hot=fi.ctx.is_hot() or any_hot)
            if root in _DEVICE_ROOTS:
                return Val(cls=DEVICE,
                           hot=fi.ctx.is_hot() or any_hot)
            clskey = self.prog._resolve_class_name(fi.ctx, dotted)
            if clskey is not None:
                self._record_ctor(fi, call, clskey, env)
                return Val(inst=clskey)
            callee = self.prog.resolve_callable(fi, call.func)
            if callee is not None:
                offset = self._callee_offset(callee, call)
                self._record_args(fi, call, callee, offset, env)
                r = self.ret.get(callee)
                if r is not None:
                    return r
                # fall through: a name bound to a jitted callable may
                # shadow-resolve to its (opaque) nested def
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in _HOST_METHODS:
                return Val(cls=HOST)
            if call.func.attr == "setdefault" and len(call.args) >= 2:
                # dict.setdefault returns either the stored value or the
                # one just inserted: at least as device-ish as the insert
                # (`fn = cache.setdefault(B, fn)` keeps fn a jitted
                # callable)
                return arg_vals[1]
            recv = self._classify(fi, call.func.value, env)
            if recv is not None and recv.inst is not None:
                m = self.prog.lookup_method(recv.inst, call.func.attr)
                if m is not None:
                    self._record_args(fi, call, m.key, 1, env)
                    return self.ret.get(m.key)
                return None
            if recv is not None and recv.cls is not None:
                # array method (astype / reshape / sum / ...): residency
                # is preserved
                return Val(cls=recv.cls, hot=recv.hot)
            callee = self.prog.resolve_callable(fi, call.func)
            if callee is not None:
                offset = self._callee_offset(callee, call)
                self._record_args(fi, call, callee, offset, env)
                return self.ret.get(callee)
        # factory results: ``fn = self._merge_fn(B); fn(x)`` or a direct
        # ``self._combine_fn(B, k)(*stack)`` — calling a jitted callable
        # yields a device value
        fv = self._classify(fi, call.func, env)
        if fv is not None and fv.fn:
            return Val(cls=DEVICE, hot=fv.hot or any_hot)
        return None

    def _callee_offset(self, callee: str, call: ast.Call) -> int:
        m = self.prog.functions.get(callee)
        if m is None:
            return 0
        args = getattr(m.node, "args", None)
        if args and args.args and args.args[0].arg in ("self", "cls") \
                and (isinstance(call.func, ast.Attribute)
                     or m.name == "__init__"):
            return 1
        return 0

    def _record_args(self, fi: FuncInfo, call: ast.Call, callee: str,
                     offset: int, env: Dict[str, Val]) -> None:
        m = self.prog.functions.get(callee)
        if m is None:
            return
        args = getattr(m.node, "args", None)
        if args is None:
            return
        names = [a.arg for a in args.args]
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                continue
            idx = i + offset
            if idx < len(names):
                self._join_into(self.param, (callee, names[idx]),
                                self._classify(fi, a, env))
        kw_ok = set(names) | {a.arg for a in args.kwonlyargs}
        for kw in call.keywords:
            if kw.arg and kw.arg in kw_ok:
                self._join_into(self.param, (callee, kw.arg),
                                self._classify(fi, kw.value, env))

    def _record_ctor(self, fi: FuncInfo, call: ast.Call, clskey: str,
                     env: Dict[str, Val]) -> None:
        init = self.prog.lookup_method(clskey, "__init__")
        if init is not None:
            self._record_args(fi, call, init.key, 1, env)
            return
        # dataclass-style: positional/keyword args map to annotated fields
        fields = self._fields.get(clskey, [])
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                continue
            if i < len(fields):
                self._join_into(self.attr, (clskey, fields[i]),
                                self._classify(fi, a, env))
        for kw in call.keywords:
            if kw.arg:
                self._join_into(self.attr, (clskey, kw.arg),
                                self._classify(fi, kw.value, env))

    def _classify_attr(self, fi: FuncInfo, expr: ast.Attribute,
                       env: Dict[str, Val]) -> Optional[Val]:
        if expr.attr in _METADATA_ATTRS:
            return Val(cls=HOST)
        v = self._classify(fi, expr.value, env)
        if v is not None and v.inst is not None:
            return self.attr_val(v.inst, expr.attr)
        if v is not None and v.cls == DEVICE:
            # unknown attribute of a device array (.T, .at, ...) stays
            # device-resident
            return Val(cls=DEVICE, hot=v.hot)
        return None

    def _classify_subscript(self, fi: FuncInfo, expr: ast.Subscript,
                            env: Dict[str, Val]) -> Optional[Val]:
        v = self._classify(fi, expr.value, env)
        if v is not None and v.inst is not None:
            m = self.prog.lookup_method(v.inst, "__getitem__")
            if m is not None:
                args = getattr(m.node, "args", None)
                if args and len(args.args) > 1:
                    self._join_into(
                        self.param, (m.key, args.args[1].arg),
                        self._classify(fi, expr.slice, env))
                return self.ret.get(m.key)
            return None
        if v is not None and v.cls is not None:
            return Val(cls=v.cls, hot=v.hot)
        return None


# ---------------------------------------------------------------------------
# one-slot identity memo, same shape as concurrency.build_program: within
# one analyze_paths() run every staging rule receives the identical
# context list, so the fixpoint solve runs once.

_CACHE_KEY: Tuple[int, ...] = ()
_CACHE_VAL: Optional[Dataflow] = None


def build_dataflow(ctxs: Sequence[ModuleContext]) -> Dataflow:
    """Build (or reuse) the solved residency model for ``ctxs``."""
    global _CACHE_KEY, _CACHE_VAL
    key = tuple(id(c) for c in ctxs)
    if key != _CACHE_KEY or _CACHE_VAL is None:
        _CACHE_VAL = Dataflow(build_program(ctxs))
        _CACHE_KEY = key
    return _CACHE_VAL
