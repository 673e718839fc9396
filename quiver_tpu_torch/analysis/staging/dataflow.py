"""Staging dataflow — DEVICE / HOST / EITHER value classification.

quiverlint's interprocedural tier.  The per-file rule (QT001) stops at
function boundaries: ``out = self._fused_forward(padded)`` looks like an
opaque call, so the ``out.cpu()`` two lines later in a caller goes
unflagged even though the callee returns a live card tensor.  This
module layers a residency lattice over the concurrency
:class:`Program` model — same file set, same name resolution, same call
graph — and solves it to a fixed point across calls, returns,
attribute loads, and containers.

Lattice (per value)::

        EITHER          may be card- or host-resident
        /    \\
    DEVICE   HOST       proven residency
        \\    /
        (unknown)       bottom — never reported

Each classified value also carries:

* ``hot`` — True when its card residency originated inside a hot module
  (the sampler/feature/serving/mesh pipeline and the kernel wrappers).
  A harness computing its own throwaway card tensors stays cold; the
  batch it got back from ``sampler.sample`` is hot, and coercing *that*
  is a finding.
* ``inst`` — the class key when the value is a known instance
  (``out = sample_neighbors(...)`` → ``SampleOut``), which is how
  ``out.nbrs`` resolves to the field its constructor filled three files
  away.

DEVICE sources: the result of a kernel entry (a public function of an
``ops/cuda`` module that counts a launch), ``.cuda()``, ``.to(d)`` where
``d`` is not provably the CPU, a ``torch.*`` call with a ``device=``
that is not literally the CPU (the package's entry points run on the
card unless asked otherwise), and any ``torch.*`` call or tensor method
with a DEVICE operand.  HOST sources: ``.cpu()``, ``.to("cpu")``,
``.numpy()``, ``.item()``, ``.tolist()``, ``torch.from_numpy``,
``torch.tensor`` / ``torch.as_tensor`` without a device, numpy calls,
casts, ``len()`` and tensor metadata (``.shape``, ``.numel()``, ...).
Everything else is EITHER or unknown and is never reported — a
``torch.Tensor`` annotation says nothing about the device.
``B = seeds.shape[0]`` is therefore host — shape metadata never costs a
transfer — which is what keeps the cache-key rule (QT014) and this one
from tripping over ordinary batch-size plumbing.

Everything is stdlib AST analysis; building the flow for the whole
repo shares the one memoized :func:`build_program` model and is itself
memoized per context list (QT013/14/15 all read the same solve).
"""

from __future__ import annotations

import ast
import fnmatch
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..concurrency import build_program
from ..concurrency.program import (
    FuncInfo,
    Program,
    _dotted,
    _self_attr,
)
from ..core import ModuleContext
from ..rules.qt001_host_sync import (
    _METADATA_ATTRS,
    _METADATA_METHODS,
    _NOT_TENSOR,
    _cpu_literal,
    _device_arg,
    _is_dtype,
)

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
    hot: bool = False              # card residency born in a hot module
    inst: Optional[str] = None     # class key for known instances
    # a tuple of known length: each position's value (``cls`` is their
    # join), so ``a, b = f()`` binds each name to its own position
    elts: Optional[Tuple[Optional["Val"], ...]] = None


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
    elts = None
    if a.elts is not None and b.elts is not None \
            and len(a.elts) == len(b.elts):
        elts = tuple(join(x, y) for x, y in zip(a.elts, b.elts))
    return Val(cls=cls, hot=a.hot or b.hot, inst=inst, elts=elts)


def broadcast(a: Optional[Val], b: Optional[Val]) -> Optional[Val]:
    """Join under tensor-op semantics: ``dev + 0`` / ``dev > 0`` is a
    card tensor (the host scalar is promoted to it), so DEVICE wins a
    mixed pairing instead of widening to EITHER."""
    j = join(a, b)
    if j is not None and j.cls == EITHER:
        if (a is not None and a.cls == DEVICE) or \
                (b is not None and b.cls == DEVICE):
            return Val(cls=DEVICE, hot=j.hot, inst=j.inst)
    return j


def _position(v: Optional[Val], index: ast.AST) -> Optional[int]:
    """``i`` when ``v[i]`` takes a literal position of a tuple of known
    length, else None."""
    if v is None or v.elts is None or not isinstance(index, ast.Constant) \
            or not isinstance(index.value, int) \
            or isinstance(index.value, bool) \
            or not -len(v.elts) <= index.value < len(v.elts):
        return None
    return index.value


_TORCH_ROOT = "torch"
_HOST_ROOTS = {"np", "numpy", "math"}
_HOST_CALLS = {
    "int", "float", "bool", "str", "repr", "len", "range", "hash",
    "torch.from_numpy",
}
# a CPU tensor from host data unless a device is named
_HOST_FACTORIES = {"torch.tensor", "torch.as_tensor"}
# results that live on the host: the materializers, and the metadata
# reads of the host-side handle
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"} | _METADATA_METHODS
# keyword operands of a torch call that are no tensor
_NOT_OPERANDS = {"device", "dtype", "out", "layout", "memory_format",
                 "pin_memory", "requires_grad", "non_blocking", "dim"}
# builtins transparent to residency: classify as the join of their args
_TRANSPARENT_CALLS = {
    "list", "tuple", "set", "dict", "sorted", "reversed", "sum", "min",
    "max", "abs", "zip", "enumerate", "next", "iter", "functools.reduce",
    "reduce",
}
# container methods that store an element
_APPENDS = {"append", "add", "extend", "appendleft"}
# a kernel wrapper module: its public functions that count a launch are
# the kernel entries, whose results live on the card
_KERNEL_MODULES = ("*ops/cuda/*.py",)

_MAX_PASSES = 10


def ordered_nodes(node: ast.AST):
    """Descendant nodes of a def in source order, not descending into
    nested defs / classes / lambdas (separate scopes with their own
    FuncInfo).  The nested def/class node itself IS yielded."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Lambda):
            continue
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            continue
        yield from ordered_nodes(child)


def _ann_residency(ann: Optional[ast.AST]) -> Optional[str]:
    """HOST for a numpy array annotation, else None: a tensor annotation
    names no device, so only the flows into the value decide."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Subscript):      # Optional[torch.Tensor] etc.
        inner = ann.slice
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return _ann_residency(inner)
    dotted = _dotted(ann)
    if dotted:
        parts = dotted.split(".")
        if parts[0] in _HOST_ROOTS and parts[-1] == "ndarray":
            return HOST
    return None


def _kernel_entries(prog: Program) -> Set[str]:
    """Public module-level functions of the kernel wrapper modules that
    count a launch (``<fn>.launches += 1``), themselves or through the
    module's own helpers (``_launch``)."""
    fns = {k: fi for k, fi in prog.functions.items()
           if fi.parent is None and fi.cls is None
           and any(fnmatch.fnmatch(fi.ctx.relpath, p)
                   for p in _KERNEL_MODULES)}
    counting = {k for k, fi in fns.items()
                if any(isinstance(n, ast.AugAssign)
                       and isinstance(n.target, ast.Attribute)
                       and n.target.attr == "launches"
                       for n in ast.walk(fi.node))}
    changed = True
    while changed:
        changed = False
        for k, fi in fns.items():
            if k in counting:
                continue
            module = k.partition(":")[0]
            if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and f"{module}:{n.func.id}" in counting
                   for n in ast.walk(fi.node)):
                counting.add(k)
                changed = True
    return {k for k in counting if not fns[k].name.startswith("_")}


def _to_target(call: ast.Call) -> Optional[str]:
    """What ``x.to(...)`` moves to: HOST for the CPU, None for a dtype
    conversion (residency kept), DEVICE for anything else."""
    target = _device_arg(call)
    if target is None:
        return None
    if _cpu_literal(target):
        return HOST
    if _is_dtype(target) or (
            _dotted(target) or "").split(".")[-1].endswith("dtype"):
        return None
    return DEVICE


class Dataflow:
    """Solved residency facts over one :class:`Program`."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.ret: Dict[str, Val] = {}             # funckey -> return val
        self.param: Dict[Tuple[str, str], Val] = {}
        self.attr: Dict[Tuple[str, str], Val] = {}   # (clskey, attr)
        self.envs: Dict[str, Dict[str, Val]] = {}    # funckey -> locals
        self._fields: Dict[str, List[str]] = {}      # dataclass field order
        self.kernel_entries: Set[str] = _kernel_entries(prog)
        self._changed = False
        self._seed()
        self._solve()

    # ------------------------------------------------------------------
    # seeding: class field annotations give cross-module ground truth

    def _seed(self) -> None:
        for ci in self.prog.classes.values():
            fields: List[str] = []
            for stmt in ci.node.body:
                if not isinstance(stmt, ast.AnnAssign) \
                        or not isinstance(stmt.target, ast.Name):
                    continue
                fields.append(stmt.target.id)
                if _ann_residency(stmt.annotation) == HOST:
                    self.attr[(ci.key, stmt.target.id)] = Val(cls=HOST)
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
        if val is None or (val.cls is None and val.inst is None):
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
                seeded = Val(cls=res) if res else None
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
            v = (self.classify(fi, stmt.value, env)
                 if stmt.value is not None else None)
            if _ann_residency(stmt.annotation) == HOST:
                v = Val(cls=HOST)
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
        # compound bodies are visited by ordered_nodes' flattening

    def _bind(self, fi: FuncInfo, target: ast.AST, v: Optional[Val],
              env: Dict[str, Val]) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = v or Val()
        elif isinstance(target, (ast.Tuple, ast.List)):
            if v is not None and v.elts is not None \
                    and len(v.elts) == len(target.elts) \
                    and not any(isinstance(e, ast.Starred)
                                for e in target.elts):
                for e, ev in zip(target.elts, v.elts):
                    self._bind(fi, e, ev, env)
                return
            vv = self._element_val(v)
            for e in target.elts:
                self._bind(fi, e, vv, env)
        elif isinstance(target, ast.Starred):
            self._bind(fi, target.value, v, env)
        elif isinstance(target, ast.Subscript):
            # `d[k] = v`: the container holds v's residency from now on
            self._store_into(fi, target.value, self._element_val(v), env)
        else:
            attr = _self_attr(target)
            if attr and fi.cls is not None:
                self._join_into(self.attr, (fi.cls.key, attr), v)

    def _store_into(self, fi: FuncInfo, container: ast.AST,
                    v: Optional[Val], env: Dict[str, Val]) -> None:
        """An element stored into a local or ``self`` container (a store
        or an append): a card element makes it hold a card value, and a
        host one stored into a card tensor (``t[i] = 0``) leaves the
        tensor on the card."""
        if v is None or v.cls is None:
            return
        if isinstance(container, ast.Name):
            old = env.get(container.id)
            if old is None or old.inst is None:
                env[container.id] = broadcast(old, v) or Val()
            return
        attr = _self_attr(container)
        if attr and fi.cls is not None:
            key = (fi.cls.key, attr)
            old = self.attr.get(key)
            new = broadcast(old, v)
            if (old is None or old.inst is None) and new != old:
                self.attr[key] = new
                self._changed = True

    @staticmethod
    def _element_val(v: Optional[Val]) -> Optional[Val]:
        """Value of one element of ``v`` (iteration, an unknown
        position): residency survives, instance identity doesn't."""
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
            vals = [self._classify(fi, e, env) for e in expr.elts]
            v = None
            for ev in vals:
                v = join(v, ev)
            if v is None:
                return None
            v = self._element_val(v)
            if isinstance(expr, ast.Tuple) and not any(
                    isinstance(e, ast.Starred) for e in expr.elts):
                v = Val(cls=v.cls, hot=v.hot, elts=tuple(vals))
            return v
        if isinstance(expr, ast.Dict):
            v = None
            for e in expr.values:
                if e is not None:
                    v = join(v, self._classify(fi, e, env))
            return self._element_val(v) if v else None
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._element_val(self._comprehension(fi, expr, env,
                                                         expr.elt))
        if isinstance(expr, ast.DictComp):
            return self._element_val(self._comprehension(fi, expr, env,
                                                         expr.value))
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

    def _comprehension(self, fi: FuncInfo, expr: ast.AST,
                       env: Dict[str, Val], elt: ast.AST) -> Optional[Val]:
        """The element of a comprehension, its targets bound in a scope
        of their own (``[o[2] for o in outs]`` is an element of an
        element of ``outs``)."""
        inner = dict(env)
        for gen in expr.generators:
            self._bind(fi, gen.target,
                       self._element_of(fi, gen.iter, inner), inner)
        return self._classify(fi, elt, inner)

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
                for av in arg_vals + [self._classify(fi, kw.value, env)
                                      for kw in call.keywords]:
                    v = join(v, av)
                return v
            if root == _TORCH_ROOT:
                return self._torch_call(fi, call, dotted, arg_vals, env)
            clskey = self.prog._resolve_class_name(fi.ctx, dotted)
            if clskey is not None:
                self._record_ctor(fi, call, clskey, env)
                return Val(inst=clskey)
            callee = self.prog.resolve_callable(fi, call.func)
            if callee is not None:
                offset = self._callee_offset(callee, call)
                self._record_args(fi, call, callee, offset, env)
                return self._returned(fi, callee)
        if isinstance(call.func, ast.Attribute):
            method = call.func.attr
            if method in _HOST_METHODS:
                return Val(cls=HOST)
            if method in _APPENDS and len(call.args) == 1:
                # `xs.append(v)`: the container holds v's residency
                self._store_into(fi, call.func.value,
                                 self._element_val(arg_vals[0]), env)
                return None
            if method == "setdefault" and len(call.args) >= 2:
                # dict.setdefault returns either the stored value or the
                # one just inserted: at least as card-ish as the insert
                return arg_vals[1]
            recv = self._classify(fi, call.func.value, env)
            if recv is not None and recv.inst is not None:
                m = self.prog.lookup_method(recv.inst, method)
                if m is not None:
                    self._record_args(fi, call, m.key, 1, env)
                    return self.ret.get(m.key)
                return None
            hot = fi.ctx.is_hot() or any_hot or (recv is not None
                                                 and recv.hot)
            if method == "cuda":
                return Val(cls=DEVICE, hot=hot)
            if method == "to":
                where = _to_target(call)
                if where == HOST:
                    return Val(cls=HOST)
                if where == DEVICE:
                    return Val(cls=DEVICE, hot=hot)
            if recv is not None and recv.cls is not None:
                # tensor method (long / view / index_select / ...): a
                # card operand makes a card result, else residency is
                # the receiver's
                v = Val(cls=recv.cls, hot=recv.hot)
                for av in arg_vals:
                    if av is not None and av.cls == DEVICE:
                        v = broadcast(v, av)
                return v
            callee = self.prog.resolve_callable(fi, call.func)
            if callee is not None:
                offset = self._callee_offset(callee, call)
                self._record_args(fi, call, callee, offset, env)
                return self._returned(fi, callee)
        return None

    def _returned(self, fi: FuncInfo, callee: str) -> Optional[Val]:
        """What a call of ``callee`` yields: a kernel entry's result is
        on the card, anything else is what its returns join to."""
        if callee in self.kernel_entries:
            return Val(cls=DEVICE,
                       hot=self.prog.functions[callee].ctx.is_hot()
                       or fi.ctx.is_hot())
        return self.ret.get(callee)

    def _torch_call(self, fi: FuncInfo, call: ast.Call, dotted: str,
                    arg_vals: List[Optional[Val]],
                    env: Dict[str, Val]) -> Optional[Val]:
        """``torch.*``: a named device decides; without one a card
        operand makes a card result."""
        if dotted.startswith(_NOT_TENSOR):
            return None
        device = None
        for kw in call.keywords:
            if kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None):
                device = kw.value
        operands = list(arg_vals) + [
            self._classify(fi, kw.value, env) for kw in call.keywords
            if kw.arg not in _NOT_OPERANDS]
        for a in call.args:      # torch.cat([host, card]): each element
            if isinstance(a, (ast.List, ast.Tuple)):
                operands += [self._classify(fi, e, env) for e in a.elts]
        any_hot = any(v.hot for v in operands if v is not None)
        if device is not None:
            if _cpu_literal(device):
                return Val(cls=HOST)
            return Val(cls=DEVICE, hot=fi.ctx.is_hot() or any_hot)
        if dotted in _HOST_FACTORIES:
            return Val(cls=HOST)
        v = None
        for ov in operands:
            v = broadcast(v, ov)
        if v is not None and v.cls == DEVICE:
            return Val(cls=DEVICE, hot=fi.ctx.is_hot() or any_hot)
        return self._element_val(v)

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
            # unknown attribute of a card tensor (.T, .mT, ...) stays on
            # the card
            return Val(cls=DEVICE, hot=v.hot)
        return None

    def _classify_subscript(self, fi: FuncInfo, expr: ast.Subscript,
                            env: Dict[str, Val]) -> Optional[Val]:
        v = self._classify(fi, expr.value, env)
        pos = _position(v, expr.slice)
        if pos is not None:
            return v.elts[pos]
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
