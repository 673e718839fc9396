"""No-sync regions — the runtime contract half of the staging tier.

A *no-sync region* is a lexical span that promises "nothing in here
forces a device→host transfer": the serving fused-forward dispatch, the
paged gather, the mesh halo combine.  QT013 proves the property over
code the static model can resolve (the torch form of that rule is still
to come; QT001 checks each function alone); :mod:`..transfer_witness`
watches the transfers the process *actually* makes and attributes any
that land inside an open region.

The library brackets its hot spans unconditionally::

    from quiver_tpu_torch.analysis.staging import no_sync

    with no_sync("serving.fused_forward"):
        out = fn(padded)

so the gate must cost nothing when the sanitizer is off.  Same contract
as telemetry timeline gating: ``_ON`` is a single module global, read
once; when it is False :func:`no_sync` returns a shared no-op context
manager (no allocation, no thread-local touch).  ``_ON`` is rebound
only by :func:`quiver_tpu_torch.analysis.transfer_witness.install` /
``uninstall`` — tests pin the one-global-read property via
``on.__code__.co_names``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

__all__ = ["active", "no_sync", "on"]

_ON = False


def on() -> bool:
    """True while the transfer witness has regions armed.

    Kept to a single global read; the test suite asserts
    ``on.__code__.co_names == ("_ON",)`` so the off cost can never
    silently grow past one dict lookup.
    """
    return _ON


class _Noop:
    """Shared do-nothing context manager for the witness-off path."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()

_tls = threading.local()


def _stack() -> List[str]:
    st = getattr(_tls, "labels", None)
    if st is None:
        st = _tls.labels = []
    return st


class _Region:
    """An open no-sync span on the current thread."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> "_Region":
        _stack().append(self.label)
        return self

    def __exit__(self, *exc) -> bool:
        st = _stack()
        if st and st[-1] == self.label:
            st.pop()
        return False


def no_sync(label: str = "no-sync"):
    """Declare a no-sync region.  Nestable; per-thread.

    With the witness off this returns a shared no-op singleton — the
    hot paths take this branch unconditionally, so it must stay at one
    global read plus one return.
    """
    if not _ON:
        return _NOOP
    return _Region(label)


def active() -> Optional[str]:
    """Innermost open region label on this thread, or None.

    The transfer witness consults this at every intercepted coercion;
    it is only ever called with the witness installed, so the
    thread-local touch is sanitizer-mode-only cost.
    """
    if not _ON:
        return None
    st = getattr(_tls, "labels", None)
    return st[-1] if st else None
