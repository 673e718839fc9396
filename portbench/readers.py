"""Helpers of the per-layer readers in ``metrics/``: each reader takes a
finished :class:`~portbench.core.Run` and returns its number, or ``None``
where the run has nothing to read."""

from __future__ import annotations

from typing import Optional

from . import counts, trace


def _peaks(run):
    name = run.layer.get("device_name")
    return counts.peaks(name) if name in counts.PEAKS else None


def roofline(run, fragment: str, bytes_key: str) -> Optional[float]:
    """A kernel's share of its bound, in %: the bytes the yardstick counts
    for the traced work at the card's HBM rate, over the device time of
    the operations whose names hold ``fragment``."""
    secs = trace.kernel_seconds(run.traced, fragment)
    nbytes = run.layer.get(bytes_key)
    pk = _peaks(run)
    if not secs or not nbytes or pk is None:
        return None
    return 100.0 * nbytes / pk["hbm_bytes"] / secs


def mfu(run, flops_key: str, units_key: str) -> Optional[float]:
    """The window's model FLOPs (``flops_key`` a unit, times the units
    done in the window) over its length, as % of the card's fp32 peak."""
    f, n, w = (run.layer.get(flops_key), run.layer.get(units_key),
               run.layer.get("window_s"))
    pk = _peaks(run)
    if not f or not n or not w or pk is None:
        return None
    return 100.0 * f * n / w / pk["fp32_flops"]


def idle_share(run) -> Optional[float]:
    t = run.traced
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def layer_ms(run, key: str) -> Optional[float]:
    v = run.layer.get(key)
    return None if v is None else 1e3 * v
