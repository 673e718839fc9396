"""Runtime lock-witness sanitizer — the dynamic half of quiverlint v2.

QT008/QT009 prove ordering properties over the static call graph; this
module watches the locks the process *actually* takes.  With
``QUIVER_SANITIZE=1`` in the environment, ``quiver_tpu_torch`` installs the
witness before any of its submodules import, so every
``threading.Lock()`` / ``threading.RLock()`` constructed afterwards is
wrapped in a :class:`_WitnessLock` that records, per thread:

* the **acquisition order** between every pair of distinct lock labels
  — a cycle in the observed order graph (or a contradiction of the
  canonical order exported by the static analyzer via
  :func:`seed_order`) is a lock-order-inversion violation, caught even
  when the interleaving that would deadlock never actually happens;
* **re-entry on a non-reentrant Lock** — recorded *before* delegating,
  since the real acquire would simply hang;
* **unguarded writes** to attributes declared in a class-level
  ``_guarded_by`` map: when a witness lock is constructed inside some
  object's ``__init__``, the owning class's ``__setattr__`` is wrapped
  to assert the declared lock is held at every later write
  (construction frames — ``__init__``/``__post_init__``/classmethod
  alternate constructors — are exempt, mirroring QT003/QT008).

Violations are **recorded, never raised**: the suite under test keeps
running and the harness (a test fixture, or ``chip_smoke.py``'s
sanitizer phase) fails its owner from :func:`drain`.  With the env var
unset this module is never imported and ``threading.Lock`` is untouched —
the zero-overhead contract ``tests/test_torch_sanitize.py`` pins.

Everything here is stdlib-only and must stay importable without torch.
"""

from __future__ import annotations

import sys
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Violation", "drain", "install", "installed", "seed_order",
    "uninstall", "violations",
]

_INIT_NAMES = ("__init__", "__post_init__")

# the real constructors, captured at import so the witness's own state
# can use them without recursing through the patch
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# frames to skip when attributing acquisitions to user code.  Exact
# paths, not suffixes — a user file named test_witness.py must NOT be
# treated as internal.
_INTERNAL_FILES = (__file__, threading.__file__)


def _is_internal(filename: str) -> bool:
    return filename in _INTERNAL_FILES


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


class _State:
    def __init__(self):
        self.lock = _REAL_LOCK()          # guards everything below
        self.violations: List[Violation] = []
        # observed order graph: held label -> {acquired labels}
        self.order: Dict[str, Set[str]] = {}
        # where each observed edge was first seen (for messages)
        self.edge_site: Dict[Tuple[str, str], str] = {}
        self.seeded: Set[Tuple[str, str]] = set()
        self.instrumented: Dict[type, object] = {}  # cls -> orig __setattr__
        self.tls = threading.local()      # .held: List[_WitnessLock]

    def held(self) -> List["_WitnessLock"]:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_state: Optional[_State] = None


def _record(kind: str, message: str) -> None:
    st = _state
    if st is None:
        return
    v = Violation(kind, message)
    with st.lock:
        st.violations.append(v)


def _reaches(st: _State, src: str, dst: str) -> bool:
    """DFS over the observed+seeded order graph (called under st.lock)."""
    seen: Set[str] = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(st.order.get(n, ()))
    return False


class _WitnessLock:
    """Delegating wrapper satisfying both the Lock and the Condition
    inner-lock protocols, with per-thread order witnessing."""

    def __init__(self, inner, kind: str):
        self._inner = inner
        self._kind = kind                 # "lock" | "rlock"
        self._depth = 0                   # re-entry depth (this thread's
        self._owner_ref = None            # view only; see _held_by_me)
        self._label: Optional[str] = None
        self._site = _construction_site(self)

    # -- labelling -----------------------------------------------------
    @property
    def label(self) -> str:
        if self._label is None:
            self._label = self._refine_label() or self._site
        return self._label

    def _refine_label(self) -> Optional[str]:
        owner = self._owner_ref() if self._owner_ref is not None else None
        if owner is None:
            return None
        try:
            attrs = dict(vars(owner))
        except TypeError:  # __slots__ class
            attrs = {}
            for klass in type(owner).__mro__:
                for k in getattr(klass, "__slots__", ()):
                    try:
                        attrs[k] = getattr(owner, k)
                    except AttributeError:
                        pass
        for k, v in attrs.items():
            if v is self:
                return f"{type(owner).__name__}.{k}"
            # a Condition built over this lock: name it by the Condition
            if getattr(v, "_lock", None) is self:
                return f"{type(owner).__name__}.{k}"
        return None

    # -- witness bookkeeping -------------------------------------------
    def _held_by_me(self) -> bool:
        st = _state
        return st is not None and any(h is self for h in st.held())

    def _note_acquired(self) -> None:
        st = _state
        if st is None:
            return
        held = st.held()
        me = self.label
        with st.lock:
            for h in held:
                other = h.label
                if other == me:
                    # same label covers both re-entry (handled before
                    # delegation) and same-role striped instances
                    continue
                edge = (other, me)
                if edge in st.edge_site:
                    continue
                rev = (me, other)
                if rev in st.seeded:
                    _append_violation(st, Violation(
                        "lock-order",
                        f"acquired `{me}` while holding `{other}`, "
                        f"contradicting the static canonical order "
                        f"{me} -> {other}"))
                elif _reaches(st, me, other):
                    _append_violation(st, Violation(
                        "lock-order",
                        f"acquired `{me}` while holding `{other}`, but "
                        f"the reverse order was witnessed at "
                        f"{st.edge_site.get(rev, '<seeded>')} — cyclic "
                        f"acquisition order (potential deadlock)"))
                st.order.setdefault(other, set()).add(me)
                st.edge_site[edge] = _caller_site()
        held.append(self)

    def _note_released(self) -> None:
        st = _state
        if st is None:
            return
        held = st.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    # -- Lock protocol -------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._kind == "lock" and self._held_by_me():
            _record(
                "self-deadlock",
                f"re-acquired non-reentrant `{self.label}` already held "
                f"by this thread (the real acquire blocks forever)")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self):
        self._note_released()
        return self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition inner-lock protocol ---------------------------------
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # plain-Lock fallback (mirrors threading.Condition's own)
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        self._note_released()
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._note_acquired()

    def _at_fork_reinit(self):
        # concurrent.futures.thread registers this via os.register_at_fork
        # on its module-level shutdown lock at first import
        return self._inner._at_fork_reinit()

    def __getattr__(self, name):
        # forward any remaining lock-protocol surface (CPython version
        # differences) straight to the real lock
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<WitnessLock {self.label} over {self._inner!r}>"


def _append_violation(st: _State, v: Violation) -> None:
    # caller already holds st.lock
    st.violations.append(v)


def _caller_site() -> str:
    f = sys._getframe(1)
    for _ in range(16):
        if f is None:
            break
        fn = f.f_code.co_filename
        if not _is_internal(fn):
            return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _construction_site(wl: "_WitnessLock") -> str:
    """Label fallback from the construction stack; also captures the
    owning object (the ``self`` of the nearest ``__init__`` frame) for
    lazy ``Class.attr`` refinement and ``_guarded_by`` instrumentation.
    """
    f = sys._getframe(2)
    site = "<unknown>"
    for _ in range(12):
        if f is None:
            break
        fn = f.f_code.co_filename
        if _is_internal(fn):
            f = f.f_back
            continue
        if site == "<unknown>":
            site = f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
        if f.f_code.co_name in _INIT_NAMES:
            owner = f.f_locals.get("self")
            if owner is not None:
                try:
                    wl._owner_ref = weakref.ref(owner)
                except TypeError:
                    pass
                _maybe_instrument(type(owner))
            break
        f = f.f_back
    return site


# -- guarded-attribute write checking ----------------------------------

def _maybe_instrument(cls: type) -> None:
    """Wrap ``cls.__setattr__`` to assert the ``_guarded_by`` contract
    at runtime.  Installed the first time a witness lock is constructed
    inside an instance's ``__init__``."""
    st = _state
    if st is None:
        return
    guarded = cls.__dict__.get("_guarded_by")
    if not isinstance(guarded, dict) or not guarded:
        return
    with st.lock:
        if cls in st.instrumented:
            return
        orig = cls.__setattr__
        st.instrumented[cls] = orig

    def checked_setattr(self, name, value, _orig=orig, _guarded=guarded,
                        _cls=cls):
        lock_attr = _guarded.get(name)
        if lock_attr is not None:
            lk = getattr(self, lock_attr, None)  # slots-safe
            if isinstance(lk, _WitnessLock) and not lk._held_by_me() \
                    and not _construction_frames(self, _cls):
                _record(
                    "unguarded-write",
                    f"`{_cls.__name__}.{name}` is _guarded_by "
                    f"`{lock_attr}` but was rebound at {_caller_site()} "
                    f"without holding it")
        _orig(self, name, value)

    cls.__setattr__ = checked_setattr


def _construction_frames(obj, cls: type) -> bool:
    """True when the write happens inside ``obj``'s own construction:
    an ``__init__``/``__post_init__`` frame for this object, or a
    classmethod frame of its class (alternate constructor) — the
    runtime mirror of the static pre-publication exemption."""
    f = sys._getframe(2)
    for _ in range(10):
        if f is None:
            return False
        loc = f.f_locals
        if f.f_code.co_name in _INIT_NAMES and loc.get("self") is obj:
            return True
        if loc.get("cls") is cls and loc.get("self") is obj:
            return True
        f = f.f_back
    return False


# -- factory patching ---------------------------------------------------

def _lock_factory():
    return _WitnessLock(_REAL_LOCK(), "lock")


def _rlock_factory():
    return _WitnessLock(_REAL_RLOCK(), "rlock")


def install() -> None:
    """Patch ``threading.Lock``/``threading.RLock`` so every lock
    constructed from here on is witnessed.  Idempotent."""
    global _state
    if _state is not None:
        return
    _state = _State()
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def uninstall() -> None:
    """Restore the real constructors and instrumented classes; drop all
    recorded state.  Locks already wrapped keep working (they delegate),
    they just stop reporting."""
    global _state
    st = _state
    if st is None:
        return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    with st.lock:
        for cls, orig in st.instrumented.items():
            cls.__setattr__ = orig
        st.instrumented.clear()
    _state = None


def installed() -> bool:
    return _state is not None


def seed_order(edges: Sequence[Tuple[str, str]]) -> None:
    """Load the canonical acquisition order exported by the static
    analyzer
    (:func:`quiver_tpu_torch.analysis.concurrency.canonical_lock_edges`)
    so a single runtime acquisition in the *wrong* direction is flagged
    without needing to witness both orders."""
    st = _state
    if st is None:
        return
    with st.lock:
        for a, b in edges:
            if a == b:
                continue
            st.seeded.add((a, b))
            st.order.setdefault(a, set()).add(b)


def violations() -> List[Violation]:
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.violations)


def drain() -> List[Violation]:
    """Return and clear the recorded violations (the test-harness hook:
    an autouse fixture drains after every test and fails the owner)."""
    st = _state
    if st is None:
        return []
    with st.lock:
        out = list(st.violations)
        st.violations.clear()
        return out
