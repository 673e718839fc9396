"""Runtime device-transfer witness — the dynamic half of quiverlint v3.

QT001 flags host syncs in the hot modules, function by function; this
module watches the transfers and waits the process *actually* performs.
With ``QUIVER_SANITIZE=1`` in the environment, ``quiver_tpu_torch``
installs the witness at the end of its import (the lock witness installs
*before* any submodule imports), wrapping every coercion point of a
tensor on the watched device type (``cuda`` by default):

* ``Tensor.item`` / ``tolist`` — scalar/list read-back;
* ``Tensor.cpu`` / ``numpy`` / ``__array__``, and ``Tensor.to`` when the
  target is the CPU — materialization on the host;
* ``Tensor.__bool__`` / ``__int__`` / ``__float__`` / ``__index__`` — the
  implicit coercions an ``if x:`` or ``int(x)`` performs;
* ``torch.cuda.synchronize`` and ``Event.synchronize`` /
  ``Stream.synchronize`` — explicit waits for the card.

The card's own synchronizing operations (a copy from pageable memory,
``nonzero``, boolean-mask indexing, ``repeat_interleave`` without
``output_size``) are no Python coercion.  While installed on ``cuda``
the witness turns on ``torch.cuda.set_sync_debug_mode("warn")``, lets
that warning through the ``warnings`` filter every time (``"always"``:
repeats would be dropped otherwise) and takes each one from
``warnings.showwarning``.  The warning is raised in the thread that
synchronized, so it lands on the region open there.  A wait inside a
wrapped call above is one transfer, not two.

Every observed transfer is attributed: the
``sanitize_host_transfers_total{site}`` counter ticks, and when a
flight-recorder trace (or the always-on timeline) is live the transfer
lands on it as a ``host_transfer`` event, so a trace of a slow request
shows exactly where it blocked on the device.

A transfer is a *violation* only inside a declared no-sync region
(``with staging.no_sync("serving device loop"):`` — see
:mod:`quiver_tpu_torch.analysis.staging.regions`).  Violations are
**recorded, never raised**: the run keeps going and its harness fails
the owner from :func:`drain`, exactly like the lock witness.  With the
env var unset this module is never imported, the region gate stays a
single-global-read no-op, and torch is untouched — the zero-overhead
contract ``tests/test_torch_sanitize.py`` pins.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
import warnings
from typing import List, Optional, Tuple

from .staging import regions

__all__ = [
    "Transfer", "Violation", "drain", "install", "installed",
    "transfers", "uninstall", "violations",
]

_INTERNAL_FILES: Tuple[str, ...] = (__file__, warnings.__file__)
# the package's directory: a frame in it is attributed by its path
# relative to the directory above (``quiver_tpu_torch/sampler.py``), the
# path the linter reports
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MISSING = object()

# the text of torch's sync-debug warning (c10 ``warn_or_error_on_sync``)
_SYNC_WARNING = "called a synchronizing CUDA operation"


class Violation:
    """One recorded sanitizer finding (kind, message, capture stack)."""

    __slots__ = ("kind", "message", "stack", "thread")

    def __init__(self, kind: str, message: str):
        self.kind = kind
        self.message = message
        self.thread = threading.current_thread().name
        self.stack = "".join(traceback.format_stack(sys._getframe(2), 8))

    def __repr__(self):
        return f"Violation({self.kind}: {self.message} [{self.thread}])"


class Transfer:
    """One observed device-to-host transfer (attribution record).

    ``where`` is ``basename:line`` of the first frame outside the
    witness; ``path`` is that frame's file relative to the directory
    holding the package (``quiver_tpu_torch/utils/staging.py``, as the
    linter names it) when the frame lies in the package, else None —
    basenames repeat across the package (three ``sampler.py``), so a
    transfer is matched to a lint finding by ``path`` and the line in
    ``where``."""

    __slots__ = ("site", "where", "region", "thread", "path")

    def __init__(self, site: str, where: str, region: Optional[str],
                 path: Optional[str] = None):
        self.site = site
        self.where = where
        self.region = region
        self.thread = threading.current_thread().name
        self.path = path

    def __repr__(self):
        tail = f" in no-sync region `{self.region}`" if self.region else ""
        return f"Transfer({self.site} at {self.where}{tail})"


class _State:
    def __init__(self, device_type: str):
        self.lock = threading.Lock()      # guards the two lists
        self.violations: List[Violation] = []
        self.transfers: List[Transfer] = []
        # (owner, name, original-or-_MISSING) restore records
        self.saved: List[Tuple[object, str, object]] = []
        self.tls = threading.local()      # .busy re-entry depth
        self.device_type = device_type    # tensors on it are watched
        self.filter = None                # our `warnings.filters` entry
        self.debug_mode: Optional[int] = None   # sync debug mode before


_state: Optional[_State] = None


def _caller_site() -> Tuple[str, Optional[str]]:
    """``(basename:line, package-relative path or None)`` of the first
    frame outside the witness."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            break
        fn = f.f_code.co_filename
        if fn not in _INTERNAL_FILES and "<" not in fn[:1]:
            full = os.path.abspath(fn)
            path = None
            if full.startswith(_PKG_DIR + os.sep):
                path = os.path.relpath(full, os.path.dirname(_PKG_DIR)) \
                    .replace(os.sep, "/")
            return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}", path
        f = f.f_back
    return "<unknown>", None


def _observe(site: str) -> None:
    """Record one transfer: tick the counter, attribute to any live
    trace/timeline, and flag it when inside a declared no-sync region.
    Never raises."""
    st = _state
    if st is None:
        return
    where, path = _caller_site()
    region = regions.active()
    t = Transfer(site, where, region, path)
    with st.lock:
        st.transfers.append(t)
        if region is not None:
            st.violations.append(Violation(
                "in-region-sync",
                f"host sync via `{site}` at {where} inside "
                f"no-sync region `{region}` — this path declared it never "
                f"blocks on the device"))
    try:
        from ..telemetry import counter, flightrec, timeline

        counter("sanitize_host_transfers_total", site=site).inc()
        if flightrec.tracing():
            flightrec.event("host_transfer",
                            {"site": site, "where": where,
                             "region": region})
        elif timeline.on():
            timeline.instant("host_transfer", cat="sanitize",
                             attrs={"site": site, "where": where})
    except Exception:
        pass  # telemetry must never break the suite under test


def _busy() -> bool:
    st = _state
    return st is not None and getattr(st.tls, "busy", 0) > 0


class _Busy:
    """Suppress nested observations: ``Tensor.__array__`` calling
    ``numpy()``, or the sync warning raised inside ``item()``, is ONE
    transfer, not two."""

    __slots__ = ()

    def __enter__(self):
        st = _state
        if st is not None:
            st.tls.busy = getattr(st.tls, "busy", 0) + 1

    def __exit__(self, *exc):
        st = _state
        if st is not None:
            st.tls.busy = getattr(st.tls, "busy", 1) - 1
        return False


_BUSY = _Busy()


def _save(st: _State, owner, name: str) -> object:
    """Record the pre-patch attribute for uninstall.  Distinguishes
    'inherited' from 'own' so restore doesn't pin a copied slot."""
    own = owner.__dict__.get(name, _MISSING) if hasattr(owner, "__dict__") \
        else _MISSING
    orig = getattr(owner, name)
    st.saved.append((owner, name, own if own is not _MISSING else _MISSING))
    return orig


def _watched(t) -> bool:
    st = _state
    try:
        return st is not None and t.device.type == st.device_type
    except Exception:
        return False


def _wrap_method(st: _State, cls, name: str, site: str,
                 when=_watched) -> bool:
    if getattr(cls, name, None) is None:
        return False
    orig = _save(st, cls, name)

    def wrapped(self, *a, **k):
        # only an observed call holds the re-entry guard: a wait inside
        # an unobserved one (``.to(cuda)`` from pageable memory) is the
        # card's own, and its sync-debug warning must get through
        if _busy() or not when(self, *a, **k):
            return orig(self, *a, **k)
        _observe(site)
        with _BUSY:
            return orig(self, *a, **k)

    wrapped.__name__ = name
    wrapped.__qualname__ = f"{cls.__name__}.{name}"
    try:
        setattr(cls, name, wrapped)
    except (AttributeError, TypeError):
        st.saved.pop()
        return False
    return True


def _to_host(t, *a, **k) -> bool:
    """``Tensor.to(...)`` whose target is the CPU, from a watched tensor."""
    if not _watched(t):
        return False
    target = k.get("device", a[0] if a else None)
    if hasattr(target, "device") and not isinstance(target, str):
        target = target.device  # .to(other_tensor)
    try:
        import torch

        if isinstance(target, (str, torch.device)):
            return torch.device(target).type == "cpu"
    except (RuntimeError, TypeError):
        pass
    return False


def _always(*a, **k) -> bool:
    return True


def _show_sync_warning(orig):
    """``warnings.showwarning`` that takes torch's sync-debug warnings as
    transfers and passes every other warning on."""
    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(_SYNC_WARNING):
            if not _busy():
                _observe("cuda sync")
            return None
        return orig(message, category, filename, lineno, file, line)

    return showwarning


def install(device_type: str = "cuda") -> None:
    """Wrap the coercion points of tensors on ``device_type`` and the
    explicit waits, turn on torch's sync-debug warnings for ``cuda``, and
    arm the no-sync region gate.  Idempotent.  The tests on a machine
    without a card watch ``"cpu"``."""
    global _state
    if _state is not None:
        return
    import torch

    st = _State(str(device_type))
    T = torch.Tensor
    for name, site in (
        ("item", ".item()"),
        ("tolist", ".tolist()"),
        ("cpu", ".cpu()"),
        ("numpy", ".numpy()"),
        ("__array__", "__array__"),
        ("__bool__", "bool()"),
        ("__int__", "int()"),
        ("__float__", "float()"),
        ("__index__", "__index__"),
    ):
        _wrap_method(st, T, name, site)
    _wrap_method(st, T, "to", ".to(cpu)", when=_to_host)
    _wrap_method(st, torch.cuda.Event, "synchronize", "Event.synchronize",
                 when=_always)
    _wrap_method(st, torch.cuda.Stream, "synchronize",
                 "Stream.synchronize", when=_always)

    real_sync = _save(st, torch.cuda, "synchronize")

    def synchronize(*a, **k):
        if not _busy():
            _observe("torch.cuda.synchronize")
        with _BUSY:
            return real_sync(*a, **k)

    torch.cuda.synchronize = synchronize

    _save(st, warnings, "showwarning")
    warnings.showwarning = _show_sync_warning(warnings.showwarning)
    warnings.filterwarnings("always", message=_SYNC_WARNING)
    st.filter = warnings.filters[0]
    if st.device_type == "cuda" and torch.cuda.is_available():
        st.debug_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    _state = st
    regions._ON = True      # arm `staging.no_sync()` region tracking


def uninstall() -> None:
    """Restore every patched attribute and drop recorded state.  The
    region gate disarms with it (``no_sync`` back to shared no-op)."""
    global _state
    st = _state
    if st is None:
        return
    regions._ON = False
    if st.debug_mode is not None:
        import torch

        torch.cuda.set_sync_debug_mode(st.debug_mode)
    try:
        warnings.filters.remove(st.filter)
        warnings._filters_mutated()
    except (ValueError, AttributeError):
        pass
    for owner, name, orig in reversed(st.saved):
        if orig is _MISSING:
            # attribute was inherited (or absent) pre-patch: drop ours
            try:
                delattr(owner, name)
            except AttributeError:
                pass
        else:
            setattr(owner, name, orig)
    st.saved.clear()
    _state = None


def installed() -> bool:
    return _state is not None


def violations() -> List[Violation]:
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.violations)


def transfers() -> List[Transfer]:
    """The attribution log since install/last drain (tests assert a
    transfer landed on the right trace through this)."""
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.transfers)


def drain() -> List[Violation]:
    """Return and clear recorded violations (and the attribution log) —
    the conftest autouse fixture fails the owning test on any."""
    st = _state
    if st is None:
        return []
    with st.lock:
        out = list(st.violations)
        st.violations.clear()
        st.transfers.clear()
        return out
