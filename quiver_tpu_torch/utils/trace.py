"""Tracing, timing and debug utilities (counterpart of the JAX package's
``utils/trace.py``).

``trace_scope`` / ``Timer`` / ``trace_summary`` / ``reset_trace``, gated
by ``QUIVER_TPU_TRACE=1`` (or :func:`set_enabled`), delegate to the
port's process-wide :class:`~quiver_tpu_torch.telemetry.SpanTracer`, so
these call sites and the telemetry spans aggregate into one place.  Work
on the card is asynchronous: a scope around it measures the launch unless
``block=`` names a tensor (or a list of tensors) whose stream the scope
waits for before it closes.  :func:`profile_trace` records a
``torch.profiler`` capture and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict

import torch

from .. import telemetry as _telemetry

__all__ = ["trace_scope", "Timer", "trace_summary", "reset_trace",
           "show_tensor_info", "profile_trace"]

_ENABLED = os.environ.get("QUIVER_TPU_TRACE", "0") not in ("0", "", "false")


def _tracer():
    # the real tracer, not the noop: QUIVER_TPU_TRACE is this module's own
    # gate, apart from QUIVER_TELEMETRY
    return _telemetry._tracer


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool):
    global _ENABLED
    _ENABLED = on
    # "record spans" also keeps the Chrome-trace events
    _tracer().set_tracing(bool(on))


def trace_scope(name: str, block=None):
    """Aggregate wall-time span.  ``block``: a tensor (or a list or tuple
    of tensors) whose device stream is waited for on exit, so the span
    covers the device's work, not only its launch."""
    if not _ENABLED:
        return contextlib.nullcontext()
    return _tracer().span(name, block=block)


class Timer:
    """Prints a block's wall-clock seconds when it ends."""

    def __init__(self, name: str, printer=print):
        self.name = name
        self.printer = printer

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.printer(
            f"[timer] {self.name}: {time.perf_counter() - self.t0:.4f}s")


def trace_summary() -> Dict[str, Dict[str, float]]:
    """Per-scope {count, total_s, mean_ms}."""
    return _tracer().summary()


def reset_trace():
    _tracer().reset()


_PROFILE_WARNED = False
_PROFILE_COUNT = 0


def _warn_profile_once(msg: str):
    global _PROFILE_WARNED
    if not _PROFILE_WARNED:
        _PROFILE_WARNED = True
        print(f"[quiver_tpu_torch] {msg}", file=sys.stderr)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` capture of the block (host, and the card when
    there is one), written to ``log_dir/trace.<pid>.<n>.json`` as a Chrome
    trace (Perfetto, chrome://tracing).

    Best effort: when the profiler cannot start or its trace cannot be
    written, the block still runs, with one warning on stderr per
    process."""
    global _PROFILE_COUNT
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:
        prof = None
        _warn_profile_once(f"torch.profiler unavailable ({e!r}); "
                           "profile_trace is a no-op")
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                _PROFILE_COUNT += 1
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace.{os.getpid()}.{_PROFILE_COUNT}.json"))
            except Exception as e:
                _warn_profile_once(f"torch.profiler trace not written "
                                   f"({e!r})")


def show_tensor_info(t, name: str = "tensor", printer=print):
    """Print a tensor's shape, dtype and device; returns the tensor."""
    dev = getattr(t, "device", None)
    printer(f"{name}: shape={tuple(t.shape)} dtype={t.dtype}"
            + (f" device={dev}" if dev is not None else ""))
    return t
