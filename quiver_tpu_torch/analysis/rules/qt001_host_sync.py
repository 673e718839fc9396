"""QT001 — host sync in a hot path.

Every ``torch.cuda.synchronize()`` / ``.cpu()`` / host cast of a card
tensor inside the sampling -> gather -> serve pipeline stalls the host
until the stream drains; at serving rates that is the difference between
"as fast as the hardware allows" and a host-bound pipeline (the
GNNSampler / SALIENT data-layer tax).  So is an upload from pageable
host memory without ``non_blocking=True``: the copy waits for the
stream before it starts.  Sync points that are part of the design
(timing probes, the answer's read-back) get an inline
``# quiverlint: ignore[QT001]`` with a justification.

Detection is deliberately local and conservative:

  * ``torch.cuda.synchronize()``, any ``<expr>.synchronize()`` (an event
    or a stream), ``<expr>.cpu()`` and ``<expr>.to("cpu")`` /
    ``.to(torch.device("cpu"))`` in a hot module are flagged outright;
  * ``.item()`` / ``.tolist()`` and ``int`` / ``float`` / ``bool`` /
    ``np.asarray`` / ``np.array`` are flagged only when the receiver or
    argument is *known* to be a tensor — a name assigned (possibly
    through arithmetic or a tensor-method chain) from a ``torch.*`` call
    in the same function, or a direct ``torch.*`` call expression.
    Host numpy stays unflagged (``.item()`` exists there too), and so do
    metadata reads (``t.shape[0]``, ``t.numel()``): they never touch the
    card;
  * ``.numpy()`` is not flagged: it works only on a CPU tensor, so the
    ``.cpu()`` before it is the sync;
  * ``.to(<device>)`` / ``.cuda()`` of a ``torch.from_numpy(...)`` chain
    without ``non_blocking=True``, and ``torch.tensor(..., device=...)``,
    are flagged as uploads from pageable memory.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from ..core import Finding, ModuleContext, Rule, dotted_call_name

_SYNC_CALLS = {"torch.cuda.synchronize"}
_CASTS = {"int", "float", "bool"}
_MATERIALIZE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_TENSOR_ROOTS = {"torch"}
# torch.* calls whose result is not a tensor (devices, dtypes, flags,
# streams and events, context managers)
_NOT_TENSOR = ("torch.cuda.", "torch.device", "torch.dtype", "torch.finfo",
               "torch.iinfo", "torch.is_", "torch.get_", "torch.set_",
               "torch.Size", "torch.Generator", "torch.no_grad",
               "torch.inference_mode", "torch.enable_grad",
               "torch.manual_seed")
# methods whose result is a host value (a materialized tensor is host
# afterwards: casting it again is free)
_HOST_METHODS = {"cpu", "numpy", "item", "tolist"}
# tensor metadata: read from the host-side handle, never from the card
_METADATA_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                   "layout", "nbytes", "itemsize", "requires_grad"}
_METADATA_METHODS = {"size", "numel", "dim", "element_size", "data_ptr",
                     "stride", "storage_offset", "is_contiguous",
                     "is_pinned", "get_device", "nelement"}


def _is_tensor_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_call_name(node.func)
    if not name or name.split(".", 1)[0] not in _TENSOR_ROOTS:
        return False
    return not name.startswith(_NOT_TENSOR)


def _walk_values(expr: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` that skips metadata reads: ``t.shape[0]`` and
    ``t.numel()`` are host values even where ``t`` is a card tensor."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute) and node.attr in _METADATA_ATTRS:
            continue
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr in _METADATA_METHODS):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _materialized(value: ast.AST) -> bool:
    """True if ``value`` is a host value at the top of its chain — e.g.
    ``t.cpu()``, ``t.cpu().numpy().copy()``, ``int(t)``, ``np.asarray(t)``,
    ``t.tolist()``.  Such an assignment yields a HOST value: downstream
    casts of it are free."""
    node = value
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)):
            if node.func.attr in _HOST_METHODS or _is_cpu_to(node):
                return True
            if node.func.attr in ("copy", "astype", "ravel", "reshape"):
                node = node.func.value
                continue
        break
    if isinstance(node, ast.Call):
        name = dotted_call_name(node.func)
        return name in _MATERIALIZE or name in _CASTS
    return False


def _target_names(target: ast.AST) -> Set[str]:
    """Plain names (re)bound by an assignment target.  Attribute and
    subscript targets bind no local name (``self.x = torch...`` must not
    mark ``self`` as a tensor)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in target.elts:
            out |= _target_names(e)
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return set()


def _tracked_names(fn: ast.AST) -> Set[str]:
    """Names assigned from ``torch.*`` calls in ``fn``, propagated through
    arithmetic and method chains to a fixed point; a name rebound from a
    materializer (``t.cpu()``, ``t.tolist()``) is host, not a tensor."""
    tracked: Set[str] = set()
    assigns = [n for n in ast.walk(fn) if isinstance(n, (ast.Assign,
                                                         ast.AugAssign))]
    changed = True
    while changed:
        changed = False
        for a in assigns:
            if _materialized(a.value) or not _mentions(a.value, tracked):
                continue
            targets = a.targets if isinstance(a, ast.Assign) else [a.target]
            for t in targets:
                for name in _target_names(t):
                    if name not in tracked:
                        tracked.add(name)
                        changed = True
    return tracked


def _mentions(expr: ast.AST, tracked: Set[str]) -> bool:
    for sub in _walk_values(expr):
        if _is_tensor_call(sub):
            return True
        if isinstance(sub, ast.Name) and sub.id in tracked:
            return True
    return False


def _cpu_literal(node: Optional[ast.AST]) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if (isinstance(node, ast.Call)
            and dotted_call_name(node.func) == "torch.device"
            and node.args):
        return _cpu_literal(node.args[0])
    return False


def _device_arg(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return call.args[0] if call.args else None


def _is_cpu_to(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute) and call.func.attr == "to"
            and _cpu_literal(_device_arg(call)))


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _from_numpy_chain(expr: ast.AST) -> bool:
    """``torch.from_numpy(a)`` possibly followed by methods/subscripts
    (``torch.from_numpy(a).long()[:n]``), but not pinned on the way."""
    node = expr
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and dotted_call_name(node.func) != "torch.from_numpy"):
            if node.func.attr == "pin_memory":
                return False
            node = node.func.value
        else:
            break
    return (isinstance(node, ast.Call)
            and dotted_call_name(node.func) == "torch.from_numpy")


def _pageable_upload(call: ast.Call) -> bool:
    if dotted_call_name(call.func) == "torch.tensor":
        return any(kw.arg == "device" and not _cpu_literal(kw.value)
                   and not (isinstance(kw.value, ast.Constant)
                            and kw.value.value is None)
                   for kw in call.keywords)
    if not isinstance(call.func, ast.Attribute):
        return False
    attr = call.func.attr
    if attr == "cuda" or (attr == "to" and _device_arg(call) is not None
                          and not _is_cpu_to(call)
                          and not _is_dtype(_device_arg(call))):
        return not _non_blocking(call) and _from_numpy_chain(call.func.value)
    return False


def _is_dtype(node: ast.AST) -> bool:
    name = dotted_call_name(node) if isinstance(node, ast.Attribute) else None
    return bool(name) and name.startswith("torch.") and not name.startswith(
        "torch.device")


class HostSyncRule(Rule):
    code = "QT001"
    name = "host-sync-in-hot-path"
    description = ("synchronize / .cpu() / host casts of tensors / pageable "
                   "uploads inside hot-path modules")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.is_hot():
            return
        for qual, fn in ctx.functions:
            tracked = None  # computed lazily: most functions are clean
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_call_name(node.func) or ""
                attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else "")
                if name in _SYNC_CALLS or attr == "synchronize":
                    yield ctx.finding(
                        self.code, node,
                        f"explicit host sync `{name or '.synchronize()'}` "
                        "in hot path (the host waits for the card per "
                        "batch)", scope=qual)
                    continue
                if attr == "cpu" or _is_cpu_to(node):
                    yield ctx.finding(
                        self.code, node,
                        "device-to-host copy in hot path (waits for the "
                        "stream)", scope=qual)
                    continue
                if _pageable_upload(node):
                    yield ctx.finding(
                        self.code, node,
                        "upload from pageable host memory in hot path "
                        "(waits for the stream; stage it pinned and pass "
                        "non_blocking=True)", scope=qual)
                    continue
                if attr in ("item", "tolist") and not node.args:
                    subject, what = node.func.value, f".{attr}()"
                elif (name in _CASTS or name in _MATERIALIZE) and node.args:
                    subject, what = node.args[0], f"{name}(...)"
                else:
                    continue
                # a sync inside the subject was already flagged above
                if any(isinstance(s, ast.Call) and (
                        dotted_call_name(s.func) in _SYNC_CALLS
                        or (isinstance(s.func, ast.Attribute)
                            and s.func.attr in ("cpu", "synchronize"))
                        or _is_cpu_to(s))
                       for s in ast.walk(subject)):
                    continue
                if tracked is None:
                    tracked = _tracked_names(fn)
                if _mentions(subject, tracked):
                    yield ctx.finding(
                        self.code, node,
                        f"`{what}` materializes a tensor on host in a hot "
                        "path (an implicit device-to-host copy)",
                        scope=qual)
