"""Short ``torch.profiler`` captures after the window, and their reduction
to the card's busy time, device time by operation, and idle gaps labelled
by what the host was doing.

Two captures of the same work on fresh inputs: the first records device
activity only, so the host runs as it does unprofiled, and gives every
number (busy and window seconds, device time by operation); the second
records the host's operations too and only labels the idle gaps of the
breakdown.  On the card's machine a capture can lose the device events
of its first milliseconds, so each capture opens with a few spin kernels
and a pause that take that loss in place of the work; a spin kernel
just before the work and one just after it mark the window on the
card's own clock (spins are left out of every count).  The benchmark's
spans around its calls into each layer are ``portbench.<layer>``.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PRIME_SPINS = 4
TOP = 10


def _profiled(work: Callable, arg, host: bool, span_name: Optional[str]):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        for _ in range(PRIME_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        torch.cuda._sleep(1)
        if span_name is None:
            work(arg)
        else:
            with record_function(f"portbench.{span_name}"):
                work(arg)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return prof.events()


def capture(work: Callable, device, args: Tuple, span: Optional[str] = None
            ) -> Optional[dict]:
    """``work(args[0])`` under a device-only capture, then ``work(args[1])``
    under one that records the host too (inside ``portbench.<span>`` when
    ``span`` is given); returns the first's :func:`reduce` with the
    second's gap labels."""
    if device.type != "cuda":
        return None
    out = reduce(_profiled(work, args[0], False, None))
    labelled = reduce(_profiled(work, args[1], True, span))
    if out is not None:
        out["gaps"] = labelled["gaps"] if labelled else {}
    return out


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(items, keys, t) -> Optional[str]:
    """The latest-starting of ``items`` (sorted by start) that holds
    ``t``."""
    i = bisect.bisect_right(keys, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        a, b, n = items[j]
        if b >= t:
            return n
    return None


def reduce(events) -> Optional[dict]:
    """``busy_s`` (the union of device operations in the window),
    ``window_s`` (from the end of the spin before the work to the start of
    the spin after it), ``ops`` (device seconds by name), and ``gaps``
    (idle seconds by the host's label: the benchmark's innermost span at
    the gap's start and the innermost other host operation there)."""
    from torch.autograd import DeviceType

    dev, spins, host, spans = [], [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation:
                continue
            (spins if "spin_kernel" in e.name else dev).append(
                (tr.start, tr.end, e.name))
        elif e.name.startswith("portbench."):
            spans.append((tr.start, tr.end, e.name[len("portbench."):]))
        else:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return None
    first, last = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    w0 = max([b for _, b, _ in spins if b <= first], default=first)
    w1 = min([a for a, _, _ in spins if a >= last], default=last)
    ops: Dict[str, float] = {}
    for a, b, n in dev:
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _ in dev])
    host.sort()
    spans.sort()
    starts, span_starts = [h[0] for h in host], [s[0] for s in spans]
    gaps: Dict[str, float] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        lab = _innermost(spans, span_starts, a) or "outside spans"
        op = _innermost(host, starts, a)
        key = f"{lab} / {op}" if op else lab
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                ops=ops, gaps=gaps)


def kernel_seconds(traced: Optional[dict], fragment: str) -> Optional[float]:
    """Device seconds of the operations whose names hold ``fragment``."""
    if not traced:
        return None
    s = sum(t for n, t in traced["ops"].items() if fragment in n)
    return s or None


def breakdown(traced: Optional[dict]) -> Optional[dict]:
    if not traced:
        return None

    def top(d):
        return [[n[:120], t] for n, t in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(traced["ops"]), "idle_gaps": top(traced["gaps"])}
