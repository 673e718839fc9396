"""Program registry (counterpart of ``quiver_tpu/recovery/registry.py``).

JAX's registry accounts for its JIT executable caches.  The port compiles
no programs at run time; what it builds once and reuses is:

  * subsystem ``kernel``: the CUDA kernel libraries ``ops/cuda/build.py``
    builds with ``nvcc`` and loads (one entry a library);
  * subsystem ``native``: the host libraries ``cpp/native.py`` builds
    with ``g++`` (the native sampler, the CRC-32C of ``recovery/``);
  * subsystem ``sampler``: each ``GraphSageSampler``'s pipeline entries,
    under JAX's keys — the batch size ``B``, or ``("stream", B, epad,
    delta_bucket, has_ts, windowed)`` for a streaming graph — so mutations
    within one delta bucket add no build.

Each is a :class:`ProgramCache` handed out by the one
:class:`ProgramRegistry`, with JAX's accounting surface:
``registry_hits_total`` / ``registry_misses_total`` /
``registry_builds_total`` and the ``registry_programs_total`` size gauge,
labelled by subsystem; :meth:`ProgramRegistry.seal` closes the warmup
window, after which every build ticks ``registry_retraces_post_seal_total``
and, past the subsystem's budget, raises :class:`RetraceBudgetExceeded` —
a kernel built after ``seal()`` fails as a cold compile fails in JAX.

JAX's persistent compilation cache becomes the build directory:
:meth:`ProgramRegistry.enable_persistent_cache` points the kernel and
native builds at a directory, and ``persistent_cache_hits`` counts
libraries found there already built.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Optional

from .. import telemetry
from ..telemetry import timeline as _timeline
from .errors import RetraceBudgetExceeded

__all__ = ["ProgramCache", "ProgramRegistry", "get_program_registry",
           "program_cache"]


class ProgramCache(dict):
    """A subsystem's cache of built things: a dict that reports to the
    registry.

    The probes — ``get`` and ``in`` — tick hit or miss; ``[]`` reads are
    silent (they follow a probe in the same lookup).  Insertions of a new
    key tick a build and pass through the seal gate."""

    def __init__(self, subsystem: str, registry: "ProgramRegistry"):
        super().__init__()
        self.subsystem = subsystem
        self._registry = registry

    def get(self, key, default=None):
        self._registry._tick(self.subsystem, dict.__contains__(self, key))
        return dict.get(self, key, default)

    def __contains__(self, key) -> bool:
        present = dict.__contains__(self, key)
        self._registry._tick(self.subsystem, present)
        return present

    def __setitem__(self, key, value) -> None:
        fresh = not dict.__contains__(self, key)
        dict.__setitem__(self, key, value)
        if fresh:
            self._registry._built(self.subsystem)

    def setdefault(self, key, default=None):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        self[key] = default
        return default


def _zero_stats() -> Dict[str, int]:
    return {"hits": 0, "misses": 0, "builds": 0, "post_seal_builds": 0}


class ProgramRegistry:
    """Process-wide ledger over every :class:`ProgramCache`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, int]] = {}
        self._caches: list = []  # (subsystem, weakref to ProgramCache)
        self._sealed = False
        self._budgets: Dict[str, int] = {}
        self._default_budget: Optional[int] = None
        self._pcache_hits = 0
        self._pcache_dir: Optional[str] = None

    def cache(self, subsystem: str, owner=None) -> ProgramCache:
        """A fresh cache accounted under ``subsystem``; held by weakref,
        so a dropped owner leaks nothing through the ledger."""
        c = ProgramCache(subsystem, self)
        with self._lock:
            self._stats.setdefault(subsystem, _zero_stats())
            self._caches.append((subsystem, weakref.ref(c)))
        return c

    # -- accounting (called by ProgramCache) --------------------------
    def _tick(self, subsystem: str, hit: bool) -> None:
        with self._lock:
            st = self._stats.setdefault(subsystem, _zero_stats())
            st["hits" if hit else "misses"] += 1
        if hit:
            telemetry.counter("registry_hits_total",
                              subsystem=subsystem).inc()
        else:
            telemetry.counter("registry_misses_total",
                              subsystem=subsystem).inc()

    def _built(self, subsystem: str) -> None:
        with self._lock:
            st = self._stats.setdefault(subsystem, _zero_stats())
            st["builds"] += 1
            sealed = self._sealed
            budget = self._budgets.get(subsystem, self._default_budget)
            over = False
            if sealed:
                st["post_seal_builds"] += 1
                over = budget is not None and st["post_seal_builds"] > budget
        telemetry.counter("registry_builds_total", subsystem=subsystem).inc()
        if _timeline._ON:
            _timeline.emit("registry.build", cat="registry",
                           attrs={"subsystem": subsystem,
                                  "post_seal": bool(sealed)})
        if sealed:
            telemetry.counter("registry_retraces_post_seal_total",
                              subsystem=subsystem).inc()
            if over:
                raise RetraceBudgetExceeded(
                    f"subsystem {subsystem!r} built after seal() beyond "
                    f"its retrace budget ({budget}) — a warm boot built "
                    "something cold")

    # -- the retrace-budget gate --------------------------------------
    def seal(self, budget: Optional[int] = None,
             per_subsystem: Optional[Dict[str, int]] = None) -> None:
        """Close the warmup window: later builds are counted and, past
        the budget, fatal.  ``budget`` is the allowance per subsystem
        (``None`` reads ``config.recovery_retrace_budget``; a negative
        value there counts and never raises)."""
        if budget is None:
            from ..config import get_config

            cfg_budget = int(get_config().recovery_retrace_budget)
            budget = None if cfg_budget < 0 else cfg_budget
        with self._lock:
            self._sealed = True
            self._default_budget = budget
            self._budgets = dict(per_subsystem or {})
            for st in self._stats.values():
                st["post_seal_builds"] = 0
        telemetry.gauge("registry_sealed_state").set(1.0)

    def unseal(self) -> None:
        with self._lock:
            self._sealed = False
        telemetry.gauge("registry_sealed_state").set(0.0)

    @property
    def sealed(self) -> bool:
        with self._lock:
            return self._sealed

    # -- introspection / metrics --------------------------------------
    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            out = {k: dict(v) for k, v in self._stats.items()}
            live = [(sub, ref()) for sub, ref in self._caches]
        for sub, c in live:
            if c is not None:
                out.setdefault(sub, _zero_stats())
                out[sub]["size"] = out[sub].get("size", 0) + len(c)
        for st in out.values():
            st.setdefault("size", 0)
        return out

    def export_metrics(self) -> Dict[str, Dict[str, int]]:
        """Publish per-subsystem sizes as gauges; returns the stats."""
        stats = self.stats()
        for sub, st in stats.items():
            telemetry.gauge("registry_programs_total", subsystem=sub).set(
                float(st["size"]))
        return stats

    # -- the build directory as the persistent cache ------------------
    def enable_persistent_cache(self, cache_dir: str) -> bool:
        """Build the kernel and native libraries into ``cache_dir``
        (created if missing), and count the ones found there already
        built.  Returns False, with the reason logged, when the directory
        cannot be made, so a boot goes on merely cold."""
        import logging

        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            logging.getLogger("quiver_tpu_torch.recovery").warning(
                "persistent build cache unavailable: %s", e)
            return False
        with self._lock:
            self._pcache_dir = str(cache_dir)
        return True

    def disable_persistent_cache(self) -> None:
        """Build into the package's build directory again."""
        with self._lock:
            self._pcache_dir = None

    def _pcache_hit(self) -> None:
        """A library was found already built in the persistent cache."""
        with self._lock:
            self._pcache_hits += 1
        telemetry.counter("registry_persistent_cache_hits_total").inc()

    @property
    def persistent_cache_hits(self) -> int:
        with self._lock:
            return self._pcache_hits

    @property
    def persistent_cache_dir(self) -> Optional[str]:
        with self._lock:
            return self._pcache_dir


_REGISTRY: Optional[ProgramRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_program_registry() -> ProgramRegistry:
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = ProgramRegistry()
        return _REGISTRY


def program_cache(subsystem: str, owner=None) -> ProgramCache:
    """The constructor the owners call in place of ``{}``, e.g.
    ``self._programs = program_cache("sampler", owner=self)``."""
    return get_program_registry().cache(subsystem, owner=owner)


def library_dir(default):
    """Where a kernel or native library is built and found: the
    persistent cache when one is enabled, else ``default``."""
    from pathlib import Path

    d = get_program_registry().persistent_cache_dir
    return Path(d) if d else Path(default)


def library_found(path) -> bool:
    """Whether the library at ``path`` is already built; counts a
    persistent-cache hit when it is, and the cache is enabled."""
    found = os.path.exists(path)
    if found and get_program_registry().persistent_cache_dir:
        get_program_registry()._pcache_hit()
    return found
