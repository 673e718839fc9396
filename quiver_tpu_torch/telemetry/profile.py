"""Per-program time attribution over the port's kernel wrappers and
serving forwards (counterpart of the JAX package's ``telemetry.profile``,
which wraps the entries of its JIT program cache; the port has no such
cache, so it wraps the programs it launches instead).

The wrapped programs:

  * each kernel wrapper in ``ops/cuda`` (subsystem ``"kernel"``, key the
    wrapper's name: ``window_sample``, ``window_sample_frontier``,
    ``gather_rows``, ``element_gather``, ``element_gather_pair``,
    ``lane_select``, ``lane_select_rows``, ``page_gather``), through
    :func:`profiled`;
  * the server's fused and unfused forwards (subsystem ``"serving"``,
    key ``(form, bucket)``), through :func:`call`.

When profiling is on, each call records:

  * **host seconds** — until the Python call returned (the launches);
  * **total seconds** — until the call's work on the card finished (the
    host waits on an event recorded after the call on its stream);
  * **device seconds** — the time between two CUDA events recorded on
    the call's stream before and after it;
  * a ``device`` flag, True only when the call's tensors lie on the
    card: a CPU run (the plain versions) records host time only and can
    never read as the card's.

Aggregates land in ``program_time_seconds{subsystem=...}`` histograms
(total seconds, as in the JAX package) and a per-(subsystem, key) table
served at ``GET /debug/programs`` (:func:`top_programs`).  Each call also
lands on the unified timeline (:mod:`.timeline`) as a complete slice
when that is recording.

Waiting for each call serializes the card's queue: that is the point
(attribution needs the device time), and why this is opt-in.  Off, a
wrapped call pays one module-global read.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["on", "enable", "disable", "reset", "profiled", "call",
           "record", "top_programs", "stats", "debug_payload"]

_ON = False

_LOCK = threading.Lock()
# (subsystem, key-repr) -> [calls, host_s, total_s, device_calls, device_s]
_STATS: Dict[tuple, List[float]] = {}


def on() -> bool:
    """True iff program profiling is recording — one global read."""
    return _ON


def _device_of(args, kwargs) -> Optional[torch.device]:
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _timed(subsystem: str, key, device: Optional[torch.device], fn, args,
           kwargs):
    if device is None or device.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        record(subsystem, key, dt, dt, False)
        return out
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record(stream)
    out = fn(*args, **kwargs)
    end.record(stream)
    host_s = time.perf_counter() - t0
    end.synchronize()
    total_s = time.perf_counter() - t0
    record(subsystem, key, host_s, total_s, True,
           start.elapsed_time(end) / 1e3)
    return out


def profiled(subsystem: str, key: Optional[str] = None):
    """Decorator: attribute each call of the function to ``(subsystem,
    key)`` (``key`` defaults to the function's name) while profiling is
    on; the device is the first tensor argument's."""

    def deco(fn):
        k = key or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            return _timed(subsystem, k, _device_of(args, kwargs), fn, args,
                          kwargs)

        return wrapper

    return deco


def call(subsystem: str, key, device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, attributed to ``(subsystem, key)`` on
    ``device`` while profiling is on."""
    if not _ON:
        return fn(*args, **kwargs)
    return _timed(subsystem, key, torch.device(device), fn, args, kwargs)


def record(subsystem: str, key, host_s: float, total_s: float,
           device: bool, device_s: Optional[float] = None) -> None:
    """Fold one call into the table + histogram + timeline."""
    k = (subsystem, repr(key))
    dev_s = float(device_s or 0.0)
    with _LOCK:
        st = _STATS.get(k)
        if st is None:
            _STATS[k] = [1, host_s, total_s, 1 if device else 0, dev_s]
        else:
            st[0] += 1
            st[1] += host_s
            st[2] += total_s
            st[3] += 1 if device else 0
            st[4] += dev_s
    from . import histogram
    from . import timeline

    histogram("program_time_seconds", subsystem=subsystem).observe(total_s)
    if timeline._ON:
        timeline.emit(f"program.{subsystem}", cat="registry", dur_s=total_s,
                      attrs={"key": repr(key), "device": device,
                             "host_s": round(host_s, 6)})


def enable() -> bool:
    """Start attribution.  Returns False when telemetry is disabled."""
    global _ON
    from . import enabled

    if not enabled():
        return False
    _ON = True
    return True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    disable()
    with _LOCK:
        _STATS.clear()


def stats() -> Dict[tuple, List[float]]:
    with _LOCK:
        return {k: list(v) for k, v in _STATS.items()}


def top_programs(k: int = 20) -> List[dict]:
    """Top-K programs by total attributed seconds (the
    ``GET /debug/programs`` table)."""
    rows = []
    for (sub, key), (calls, host_s, total_s, dev_calls,
                     device_s) in stats().items():
        calls = int(calls)
        rows.append({
            "subsystem": sub,
            "key": key,
            "calls": calls,
            "host_s": round(host_s, 6),
            "total_s": round(total_s, 6),
            "mean_ms": round(total_s / calls * 1e3, 4) if calls else 0.0,
            # True only if EVERY call ran on the card: mixed runs read
            # as not-device
            "device": bool(calls) and int(dev_calls) == calls,
            "device_s": round(device_s, 6),
            "device_mean_ms": (round(device_s / dev_calls * 1e3, 4)
                               if dev_calls else None),
        })
    rows.sort(key=lambda r: r["total_s"], reverse=True)
    return rows[:max(int(k), 0)]


def debug_payload(k: int = 20) -> dict:
    return {"enabled": _ON, "top": top_programs(k),
            "programs": len(stats())}
