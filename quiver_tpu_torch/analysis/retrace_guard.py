"""retrace_guard — the build guard: makes the port's build cache testable.

The port compiles no executables at run time.  What it builds, once each,
is kept in the program registry (:mod:`..recovery.registry`): the CUDA
kernel libraries and the native host libraries, each sampler's pipeline
entries under JAX's keys (the batch size ``B``, or the streaming key),
and the mesh tier's gather and combine keys.  This module counts the
registry's new entries while a test runs, and the compiler runs
(``nvcc`` for a kernel library, ``g++`` for a native one) beside them,
and fails the test when either exceeds a declared budget::

    @pytest.mark.torch_retrace_budget(3)     # at most 3 builds
    def test_interleaved_batches(sampler):
        for b in [8, 16, 8, 32, 16, 8]:      # 3 distinct shapes
            sampler.sample(np.arange(b))

    @pytest.mark.torch_retrace_budget(1, backend_compiles=0)
    def test_steady_state(...): ...

What counts as a "build": a new key in any :class:`ProgramCache`, named
after JAX's build site where there is one — ``sampler._build_jit`` (a
new batch size), ``sampler._build_stream_jit`` (a new streaming key),
``mesh._gather_fn``, ``mesh._combine_fn`` — and ``kernel.<library>`` /
``native.<library>`` for a library loaded.  JAX's ``Feature._merge_cache``,
``InferenceServer._fused_fns`` and ``HeteroGraphSageSampler._jitted``
sites have no counterpart: the port's budgeted gather, fused forward and
hetero sampler run the same kernels at every shape.  ``backend_compiles``
counts compiler processes started.

Wiring: load the plugin with ``-p quiver_tpu_torch.analysis.retrace_guard``
(the marker ``torch_retrace_budget`` keeps it apart from the JAX
package's ``retrace_budget``).  The module imports only pytest and the
standard library at top level; the port (and torch) load lazily inside
the counting context.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import pytest

__all__ = [
    "JitBuildCounter", "count_jit_builds", "enforce_budget",
    "pytest_configure", "pytest_runtest_call",
]

_MARKER = "torch_retrace_budget"

# registry subsystem -> JAX's build site
_SITES = {"mesh_feature": "mesh._gather_fn",
          "mesh_sampler": "mesh._combine_fn"}


class JitBuildCounter:
    """Tally of builds observed inside a counting context."""

    def __init__(self) -> None:
        self.builds = 0
        self.backend_compiles = 0
        # compiler runs are observed directly, so always available (JAX's
        # listener rides a private API and may be missing)
        self.backend_available = True
        self.sites: List[Tuple[str, object]] = []  # (site, key)
        self._lock = threading.Lock()

    def record(self, site: str, key: object = None) -> None:
        with self._lock:
            self.builds += 1
            self.sites.append((site, key))

    def record_backend(self) -> None:
        with self._lock:
            self.backend_compiles += 1

    def describe(self) -> str:
        if not self.sites:
            return "<no builds recorded>"
        return ", ".join(
            f"{site}({key})" if key is not None else site
            for site, key in self.sites)


def _site(subsystem: str, key: object) -> Tuple[str, object]:
    if subsystem == "sampler":
        if isinstance(key, tuple) and key and key[0] == "stream":
            return "sampler._build_stream_jit", key
        return "sampler._build_jit", key
    if subsystem in ("kernel", "native"):
        return f"{subsystem}.{key}", None
    return _SITES.get(subsystem, subsystem), key


def _count_entries(counter: JitBuildCounter):
    """A ``ProgramCache`` insertion of a new key is one build."""
    def factory(orig):
        @functools.wraps(orig)
        def wrapped(self, key, value):
            if not dict.__contains__(self, key):
                counter.record(*_site(self.subsystem, key))
            return orig(self, key, value)
        return wrapped
    return factory


def _count_kernel_compiles(counter: JitBuildCounter):
    """``build._start`` returns a job exactly when it started ``nvcc``."""
    def factory(orig):
        @functools.wraps(orig)
        def wrapped(name):
            job = orig(name)
            if job is not None:
                counter.record_backend()
            return job
        return wrapped
    return factory


def _count_native_compiles(counter: JitBuildCounter, path_of):
    """``native.build`` runs ``g++`` when the library is not there yet."""
    def factory(orig):
        @functools.wraps(orig)
        def wrapped(src: Path):
            fresh = not Path(path_of(src)).exists()
            out = orig(src)
            if fresh:
                counter.record_backend()
            return out
        return wrapped
    return factory


@contextlib.contextmanager
def count_jit_builds():
    """Context manager: patch the port's build sites and yield a live
    :class:`JitBuildCounter`.  Usable directly in tests for exact
    assertions (``assert c.builds == 2``) — the marker is sugar over
    this."""
    from ..cpp import native
    from ..ops.cuda import build
    from ..recovery.registry import ProgramCache

    counter = JitBuildCounter()
    patched: List[Tuple[object, str, object]] = []

    def patch(owner, name, factory):
        orig = getattr(owner, name)
        setattr(owner, name, factory(orig))
        patched.append((owner, name, orig))

    patch(ProgramCache, "__setitem__", _count_entries(counter))
    patch(build, "_start", _count_kernel_compiles(counter))
    patch(native, "build",
          _count_native_compiles(counter, native._library_path))
    try:
        yield counter
    finally:
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)


def enforce_budget(counter: JitBuildCounter, builds: Optional[int],
                   backend_compiles: Optional[int] = None,
                   nodeid: str = "", fail=None) -> None:
    """Fail (via ``pytest.fail`` by default) if ``counter`` exceeded the
    budget.  Split out from the hook so the failure path is unit-testable
    without running a nested pytest."""
    fail = fail or pytest.fail
    where = nodeid or "<test>"
    if builds is not None and counter.builds > builds:
        fail(f"retrace budget exceeded: {counter.builds} build(s) > "
             f"budget {builds} for {where} — every extra build is a "
             f"latency cliff at serving time. Build sites: "
             f"{counter.describe()}", pytrace=False)
    if backend_compiles is not None and counter.backend_available \
            and counter.backend_compiles > backend_compiles:
        fail(f"retrace budget exceeded: {counter.backend_compiles} "
             f"compiler run(s) > budget {backend_compiles} for "
             f"{where}", pytrace=False)


def _parse_marker(marker) -> Tuple[Optional[int], Optional[int]]:
    builds = marker.args[0] if marker.args else marker.kwargs.get("builds")
    backend = marker.kwargs.get("backend_compiles")
    if builds is None and backend is None:
        raise pytest.UsageError(
            f"{_MARKER} marker needs a budget: "
            f"@pytest.mark.{_MARKER}(N) or "
            f"{_MARKER}(backend_compiles=N)")
    return builds, backend


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        f"{_MARKER}(builds, backend_compiles=None): fail the test if "
        "the port builds more than `builds` programs (or runs the "
        "compiler more than `backend_compiles` times) while it runs")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker(_MARKER)
    if marker is None:
        return (yield)
    builds, backend = _parse_marker(marker)
    with count_jit_builds() as counter:
        result = yield          # test exceptions propagate past the patch
    enforce_budget(counter, builds, backend, nodeid=item.nodeid)
    return result
