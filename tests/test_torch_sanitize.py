"""The port's runtime witnesses and build guard against the JAX package's
contracts (``tests/test_witness.py``, ``test_transfer_witness.py`` and
``test_retrace_guard.py``, case by case).

The lock witness is a copy.  The transfer witness watches torch tensors
of one device type (``cuda`` by default; these tests watch ``cpu``), the
card's waits, and torch's sync-debug warnings.  The build guard counts
the port's program-registry entries under JAX's keys.  Fixtures install
and uninstall the witnesses around each test; the import-gate and
zero-overhead cases run in fresh interpreters that import only the port.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import timeline as jtimeline

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry
from quiver_tpu_torch.analysis import staging, transfer_witness, witness
from quiver_tpu_torch.analysis.retrace_guard import (
    JitBuildCounter, count_jit_builds, enforce_budget)
from quiver_tpu_torch.analysis.staging import regions
from quiver_tpu_torch.telemetry import flightrec, timeline

pytestmark = pytest.mark.sanitize

REPO = Path(__file__).resolve().parents[1]
_JAX_TELEMETRY_DEFAULT = jtel.enabled()
_PORT_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' registries, flight recorders and timelines start
    and end clean, each telemetry switch back at its default after."""
    for tel, rec, tl in ((telemetry, flightrec, timeline),
                         (jtel, jflightrec, jtimeline)):
        tel.reset()
        rec.reset()
        tl.disable()
        tl.reset()
    yield
    for tel, rec, tl in ((telemetry, flightrec, timeline),
                         (jtel, jflightrec, jtimeline)):
        rec.reset()
        tl.disable()
        tl.reset()
        tel.reset()
    telemetry.set_enabled(_PORT_TELEMETRY_DEFAULT)
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _fresh(code: str, sanitize: bool):
    env = {k: v for k, v in os.environ.items() if k != "QUIVER_SANITIZE"}
    if sanitize:
        env["QUIVER_SANITIZE"] = "1"
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=180,
                          cwd=str(REPO), env=env)


# ------------------------------------------------------- lock witness
@pytest.fixture
def w():
    was_installed = witness.installed()
    witness.install()
    witness.drain()
    yield witness
    witness.drain()
    if not was_installed:
        witness.uninstall()


def kinds(vs):
    return sorted(v.kind for v in vs)


def test_wraps_lock_construction(w):
    assert isinstance(threading.Lock(), witness._WitnessLock)
    assert isinstance(threading.RLock(), witness._WitnessLock)


def test_deterministic_two_thread_inversion(w):
    class Box:
        def __init__(self):
            self.alock = threading.Lock()
            self.block = threading.Lock()

    b = Box()

    def fwd():
        with b.alock:
            with b.block:
                pass

    def bwd():
        with b.block:
            with b.alock:
                pass

    t1 = threading.Thread(target=fwd)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=bwd)
    t2.start()
    t2.join()
    vs = w.drain()
    assert "lock-order" in kinds(vs), vs
    msg = next(v for v in vs if v.kind == "lock-order").message
    assert "Box.alock" in msg and "Box.block" in msg


def test_consistent_order_stays_quiet(w):
    class Box:
        def __init__(self):
            self.alock = threading.Lock()
            self.block = threading.Lock()

    b = Box()
    for _ in range(3):
        with b.alock:
            with b.block:
                pass
    assert w.drain() == []


def test_seeded_static_order_flags_single_reversal(w):
    w.seed_order([("SeedA._first", "SeedB._second")])

    class SeedA:
        def __init__(self):
            self._first = threading.Lock()

    class SeedB:
        def __init__(self):
            self._second = threading.Lock()

    a, b = SeedA(), SeedB()
    with b._second:
        with a._first:
            pass
    vs = w.drain()
    assert kinds(vs) == ["lock-order"]
    assert "canonical order" in vs[0].message


def test_plain_lock_reentry_recorded_not_hung(w):
    lock = threading.Lock()
    lock.acquire()
    assert lock.acquire(timeout=0.01) is False
    lock.release()
    assert "self-deadlock" in kinds(w.drain())


def test_rlock_reentry_is_fine(w):
    lock = threading.RLock()
    with lock:
        with lock:
            pass
    assert w.drain() == []


def test_guarded_write_enforcement(w):
    class G:
        _guarded_by = {"val": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self.val = 0

    g = G()
    with g._lock:
        g.val = 1
    assert w.drain() == []
    g.val = 2
    vs = w.drain()
    assert kinds(vs) == ["unguarded-write"]
    assert "G.val" in vs[0].message


def test_condition_over_witnessed_lock(w):
    cv = threading.Condition(threading.Lock())
    got = []

    def waiter():
        with cv:
            got.append(cv.wait(timeout=2.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join()
    assert got == [True]
    assert w.drain() == []


def test_feature_publication_is_witness_clean(w):
    """Building a feature and publishing a second table take the port's
    locks in the canonical order, with every guarded write under its
    lock (the locks are made after install, so the checks are live)."""
    feat = qt.Feature(device="cpu")
    feat.from_cpu_tensor(np.arange(20, dtype=np.float32).reshape(5, 4))
    feat.from_cpu_tensor(np.ones((6, 3), dtype=np.float32))
    feat[np.array([0, 5])]
    assert w.drain() == []


def test_port_lock_order_seeds_from_the_static_model(w):
    """The canonical order the chip run seeds comes from the port's own
    program model, and the port's serving path honours it."""
    from quiver_tpu_torch.analysis.concurrency import canonical_lock_edges
    from quiver_tpu_torch.analysis.core import load_contexts

    edges = canonical_lock_edges(load_contexts(["quiver_tpu_torch"],
                                               root=REPO))
    assert edges and all(a != b for a, b in edges)
    w.seed_order(edges)
    src = np.arange(64)
    topo = qt.CSRTopo(edge_index=np.stack([src, (src * 7 + 1) % 64]))
    sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu", seed=0)
    feature = qt.Feature(device_cache_size="1G", csr_topo=topo,
                         device="cpu").from_cpu_tensor(
        np.random.default_rng(0).standard_normal((64, 8), dtype=np.float32))
    model = qt.GraphSAGE(8, 8, 3, num_layers=2, device="cpu").eval()
    server = qt.InferenceServer(sampler, feature, model, None, seed=0)
    out = server._run_bucketed(np.arange(10))
    assert out.shape == (10, 3)
    assert w.drain() == []


# --------------------------------------------------- transfer witness
@pytest.fixture
def tw():
    was_installed = transfer_witness.installed()
    if was_installed:
        transfer_witness.uninstall()
    transfer_witness.install("cpu")
    transfer_witness.drain()
    yield transfer_witness
    transfer_witness.drain()
    transfer_witness.uninstall()
    if was_installed:
        transfer_witness.install()


@pytest.fixture
def live_telemetry():
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    telemetry.reset()
    yield telemetry
    telemetry.reset()
    telemetry.set_enabled(was)


def test_transfers_observed_and_attributed(tw):
    x = torch.arange(4)
    _ = float(x.sum())
    _ = np.asarray(x)
    _ = x.tolist()
    sites = [t.site for t in tw.transfers()]
    assert "float()" in sites and "__array__" in sites and ".tolist()" \
        in sites
    me = Path(__file__).name
    assert any(t.where.startswith(me) for t in tw.transfers())
    assert tw.violations() == []  # outside any region: observed, legal


def test_transfer_names_its_frame_by_package_path(tw):
    """A transfer whose frame lies in the package carries the path the
    linter reports (basenames repeat across the package); one made
    elsewhere carries None."""
    import inspect

    from quiver_tpu_torch import feature

    feature._host_ids(torch.arange(3))
    _ = torch.arange(2).tolist()
    seen = tw.transfers()
    first, second = seen[0], seen[-1]
    assert [t.path for t in seen[:-1]] == ["quiver_tpu_torch/feature.py"] * (
        len(seen) - 1)
    assert first.site == ".cpu()"
    src, start = inspect.getsourcelines(feature._host_ids)
    line = int(first.where.rsplit(":", 1)[1])
    assert first.where.startswith("feature.py:")
    assert ".cpu()" in src[line - start]
    assert second.path is None and second.where.startswith(
        Path(__file__).name)


def test_nested_coercion_records_exactly_one_transfer(tw):
    # __array__ reads through numpy(): ONE attributed transfer, not two
    _ = np.asarray(torch.arange(3))
    assert [t.site for t in tw.transfers()] == ["__array__"]


@pytest.mark.parametrize("site, coerce", [
    (".item()", lambda x: x.sum().item()),
    (".tolist()", lambda x: x.tolist()),
    (".cpu()", lambda x: x.cpu()),
    (".numpy()", lambda x: x.numpy()),
    ("__array__", lambda x: np.asarray(x)),
    ("bool()", lambda x: bool(x[1])),
    ("int()", lambda x: int(x[1])),
    ("float()", lambda x: float(x[1])),
    ("__index__", lambda x: [0, 1, 2][x[1]]),
    (".to(cpu)", lambda x: x.to("cpu")),
    (".to(cpu)", lambda x: x.to(device=torch.device("cpu"))),
    (".to(cpu)", lambda x: x.to(torch.empty(0))),
])
def test_in_region_sync_is_deterministic_violation(tw, site, coerce):
    x = torch.arange(3)
    with staging.no_sync("unit region"):
        coerce(x)
    vs = tw.drain()
    assert [v.kind for v in vs] == ["in-region-sync"]
    assert "unit region" in vs[0].message
    assert f"`{site}`" in vs[0].message


def test_unwatched_device_and_dtype_casts_stay_quiet(tw):
    x = torch.arange(3)
    with staging.no_sync("unit region"):
        x.to(torch.float32)
        x.to("meta")
        _ = np.asarray([1, 2, 3])
        _ = float(3.5)
    assert tw.drain() == []
    transfer_witness.uninstall()
    transfer_witness.install()   # the card's tensors: a CPU one is not
    with staging.no_sync("unit region"):
        x.tolist(), x.cpu(), int(x[0]), x.to("cpu")
    assert tw.drain() == [] and tw.transfers() == []


def test_waits_for_the_card_are_recorded(tw, monkeypatch):
    calls = []
    transfer_witness.uninstall()
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    transfer_witness.install("cpu")
    with staging.no_sync("unit region"):
        torch.cuda.synchronize()
    vs = tw.drain()
    assert calls == ["sync"]
    assert [v.kind for v in vs] == ["in-region-sync"]
    assert "torch.cuda.synchronize" in vs[0].message
    for cls in (torch.cuda.Event, torch.cuda.Stream):
        assert cls.synchronize.__qualname__.endswith(
            f"{cls.__name__}.synchronize")


def test_sync_debug_warning_is_a_transfer_of_its_thread(tw):
    """torch's sync-debug warning (raised by the card's own waits: a
    pageable copy, nonzero, a boolean mask) goes through every time and
    lands on the region open on the thread that raised it."""
    msg = "called a synchronizing CUDA operation"
    got = []

    def other_thread():
        warnings.warn(msg)
        got.append(staging.active())

    with staging.no_sync("unit region"):
        warnings.warn(msg)
        warnings.warn(msg)  # a repeat is not dropped
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    vs = tw.drain()
    assert got == [None]
    assert len(vs) == 2 and all("`cuda sync`" in v.message for v in vs)
    assert [t.region for t in tw.transfers()] == []  # drained with them
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warnings.warn("an unrelated warning")
    assert [str(c.message) for c in caught] == ["an unrelated warning"]


def test_install_arms_region_gate(tw):
    assert regions.on()
    with staging.no_sync("lbl"):
        assert staging.active() == "lbl"
        with staging.no_sync("inner"):
            assert staging.active() == "inner"
        assert staging.active() == "lbl"
    assert staging.active() is None


def test_region_gate_is_single_global_read():
    assert regions.on.__code__.co_names == ("_ON",)


def test_attribution_lands_on_live_trace(tw, live_telemetry):
    tr = flightrec.new_trace()
    assert tr is not None
    with flightrec.activate(tr):
        _ = np.asarray(torch.arange(3))
    evs = [e for e in tr.events if e[1] == "host_transfer"]
    assert evs, tr.events
    assert evs[0][3]["site"] == "__array__"
    assert evs[0][3]["where"].startswith(Path(__file__).name)


def test_counter_ticks_per_site(tw, live_telemetry):
    _ = float(torch.arange(2).sum())
    snap = live_telemetry.snapshot()
    keys = [k for k in snap.get("counters", {})
            if "sanitize_host_transfers_total" in k and "float()" in k]
    assert keys, snap.get("counters", {}).keys()


def test_uninstall_restores_coercion_points():
    if transfer_witness.installed():
        pytest.skip("sanitize session: witness stays installed")
    names = ("item", "tolist", "cpu", "numpy", "__array__", "__bool__",
             "__int__", "__float__", "__index__", "to")
    before = {n: torch.Tensor.__dict__.get(n) for n in names}
    sync, show = torch.cuda.synchronize, warnings.showwarning
    n_filters = len(warnings.filters)
    transfer_witness.install("cpu")
    try:
        assert torch.Tensor.__dict__["item"] is not before["item"]
        assert torch.cuda.synchronize is not sync
        assert warnings.showwarning is not show
    finally:
        transfer_witness.uninstall()
    assert {n: torch.Tensor.__dict__.get(n) for n in names} == before
    assert torch.cuda.synchronize is sync and warnings.showwarning is show
    assert len(warnings.filters) == n_filters
    assert not regions.on()
    assert transfer_witness.transfers() == []


def test_region_gate_off_is_shared_noop():
    if transfer_witness.installed():
        pytest.skip("sanitize session: gate armed")
    assert regions.no_sync("a") is regions.no_sync("b")
    assert staging.active() is None


def test_regions_open_where_jax_opens_them(monkeypatch):
    """With the gate armed, the port's three spans run inside their
    regions: the fused serving forward, the paged gather from the plan's
    copy to B5, the mesh sampler's combine; the answer's read-back and
    the mesh gauge's stay outside."""
    from quiver_tpu_torch import serving
    from quiver_tpu_torch.mesh import MeshSampler
    from quiver_tpu_torch.mesh import sampler as msampler
    from quiver_tpu_torch.ops import paged

    seen = {}

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            seen.setdefault(key, []).append(staging.active())
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(paged, "page_gather", "paged")
    spy(msampler, "pmax", "mesh")
    spy(serving, "_host_logits", "readback")
    was = transfer_witness.installed()
    if not was:
        transfer_witness.install()   # watches cuda: nothing here is seen
    try:
        src = np.arange(256)
        topo = qt.CSRTopo(edge_index=np.stack([src, (src * 5 + 3) % 256]))
        table = np.random.default_rng(1).standard_normal(
            (256, 8), dtype=np.float32)
        sampler = qt.GraphSageSampler(topo, [3, 2], device="cpu", seed=0)
        full = qt.Feature(device_cache_size="1G", csr_topo=topo,
                          device="cpu").from_cpu_tensor(table)
        model = qt.GraphSAGE(8, 8, 3, num_layers=2, device="cpu").eval()
        server = qt.InferenceServer(sampler, full, model, None, seed=0)
        fused = server.fused_forward

        def spied_forward(*a, **k):
            seen.setdefault("fused", []).append(staging.active())
            return fused(*a, **k)

        server.fused_forward = spied_forward
        server._run_bucketed(np.arange(10))
        budget = 2 * 8 * 4 * 16  # 32 rows of 8 fp32 on the device
        paged_feat = qt.Feature(device_cache_size=budget, csr_topo=topo,
                                device="cpu").from_cpu_tensor(table)
        paged_feat.enable_paging()
        rows = paged_feat[np.arange(0, 256, 3)]
        assert torch.equal(rows, torch.from_numpy(table[0:256:3]))
        mesh = qt.make_mesh(("shard",), devices=[torch.device("cpu")] * 4)
        ms = MeshSampler(topo.indptr, topo.indices, n_shards=4, mesh=mesh)
        ms.sample(np.arange(16), 3, np.array([1, 2], np.uint32))
        ms.sample(torch.arange(16), 3, np.array([1, 2], np.uint32))
    finally:
        if not was:
            transfer_witness.uninstall()
    assert seen["fused"] == ["serving device loop"]
    assert seen["readback"] == [None]
    assert seen["paged"] and set(seen["paged"]) == {"paged gather"}
    assert set(seen["mesh"]) == {"mesh combine"} and len(seen["mesh"]) == 6


def test_witnesses_off_are_zero_overhead():
    """Without QUIVER_SANITIZE, importing the port loads neither witness
    and touches neither the Lock factories nor torch's coercion points;
    the region gate stays the shared no-op."""
    proc = _fresh("""
        import sys, threading, _thread, warnings
        import torch
        orig_l, orig_r = threading.Lock, threading.RLock
        item, to = torch.Tensor.__dict__.get("item"), torch.Tensor.to
        sync, show = torch.cuda.synchronize, warnings.showwarning
        import quiver_tpu_torch
        from quiver_tpu_torch.analysis.staging import regions
        mods = [m for m in sys.modules if m.startswith(
            "quiver_tpu_torch.analysis.") and m.endswith("witness")]
        assert mods == [], mods
        assert threading.Lock is orig_l is _thread.allocate_lock
        assert threading.RLock is orig_r
        assert torch.Tensor.__dict__.get("item") is item
        assert torch.Tensor.to is to
        assert torch.cuda.synchronize is sync
        assert warnings.showwarning is show
        assert regions.on() is False
        assert regions.no_sync("a") is regions.no_sync("b")
        assert not any(m.split(".")[0] in ("jax", "quiver_tpu")
                       for m in sys.modules)
    """, sanitize=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_env_gate_installs_both_witnesses():
    """QUIVER_SANITIZE=1: the lock witness wraps every lock the package
    builds, the transfer witness watches the card's tensors and arms the
    regions, and a concurrent.futures first import under the witness
    still works."""
    proc = _fresh("""
        import threading, sys
        import quiver_tpu_torch
        from quiver_tpu_torch.analysis import witness
        from quiver_tpu_torch.analysis import transfer_witness as tw
        from quiver_tpu_torch.analysis import staging
        assert witness.installed() and tw.installed()
        assert tw._state.device_type == "cuda"
        assert isinstance(threading.Lock(), witness._WitnessLock)
        from quiver_tpu_torch.recovery.registry import get_program_registry
        assert isinstance(get_program_registry()._lock,
                          witness._WitnessLock)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(1) as p:
            assert p.submit(lambda: 41 + 1).result(10) == 42
        import torch
        with staging.no_sync("gate region"):
            torch.arange(3).sum().item()  # a CPU tensor: not watched
        assert tw.drain() == []
        tw.uninstall()
        tw.install("cpu")
        with staging.no_sync("gate region"):
            torch.arange(3).sum().item()
        vs = tw.drain()
        assert [v.kind for v in vs] == ["in-region-sync"], vs
        assert "gate region" in vs[0].message
        assert witness.drain() == []
        assert not any(m.split(".")[0] in ("jax", "quiver_tpu")
                       for m in sys.modules)
    """, sanitize=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----------------------------------------------------- build guard
def _graph():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 200, 1600), rng.integers(0, 200, 1600)
    return np.stack([src, dst])


def test_counts_one_build_per_distinct_batch_size():
    """JAX's batch sequence builds 3 programs in each package, under the
    same keys and the same site."""
    import jax

    from quiver_tpu import CSRTopo as JaxTopo
    from quiver_tpu import GraphSageSampler as JaxSampler
    from quiver_tpu.analysis.retrace_guard import \
        count_jit_builds as jax_count

    sizes = [8, 16, 8, 32, 16, 8]
    s = qt.GraphSageSampler(qt.CSRTopo(edge_index=_graph()), [4, 3],
                            device="cpu", seed=0)
    with count_jit_builds() as c:
        for B in sizes:
            s.sample(np.arange(B, dtype=np.int64))
    js = JaxSampler(JaxTopo(edge_index=_graph()), [4, 3],
                    gather_mode="xla", sample_rng="hash")
    with jax_count() as jc:
        for B in sizes:
            js.sample(np.arange(B, dtype=np.int64), key=jax.random.PRNGKey(B))
    assert c.builds == jc.builds == 3
    assert sorted(k for _, k in c.sites) == sorted(
        k for _, k in jc.sites) == [8, 16, 32]
    assert {site for site, _ in c.sites} == {site for site, _ in jc.sites} \
        == {"sampler._build_jit"}
    assert c.backend_compiles == 0
    with count_jit_builds() as c2:
        for B in [8, 16, 32]:
            s.sample(np.arange(B, dtype=np.int64))
    assert c2.builds == 0


def test_counts_streaming_and_mesh_keys():
    from quiver_tpu_torch.mesh import MeshSampler
    from quiver_tpu_torch.stream import StreamingGraph

    topo = qt.CSRTopo(edge_index=_graph())
    g = StreamingGraph(topo, device="cpu")
    try:
        s = qt.GraphSageSampler(g, [4, 3], device="cpu", seed=0)
        mesh = qt.make_mesh(("shard",), devices=[torch.device("cpu")] * 2)
        ms = MeshSampler(topo.indptr, topo.indices, n_shards=2, mesh=mesh)
        with count_jit_builds() as c:
            for B in (8, 8, 16):
                s.sample(np.arange(B))
                ms.sample(np.arange(B), 3, np.array([1, 2], np.uint32))
    finally:
        g.close()
    assert sorted(c.sites, key=str) == sorted([
        ("mesh._combine_fn", ("combine", 8, 3, 2)),
        ("mesh._combine_fn", ("combine", 16, 3, 2)),
        *[("sampler._build_stream_jit", k) for k in s._programs]], key=str)
    assert c.builds == 4


def test_counts_library_builds_and_compiler_runs(tmp_path):
    """A native library built into an empty cache is one build and one
    compiler run; loading it again is neither."""
    from quiver_tpu_torch.cpp import native
    from quiver_tpu_torch.recovery.registry import get_program_registry

    reg = get_program_registry()
    reg.enable_persistent_cache(str(tmp_path))
    saved = dict(native._libs)
    dict.clear(native._libs)
    try:
        with count_jit_builds() as c:
            native.load(native.SRC, native._declare_sampler)
            native.load(native.SRC, native._declare_sampler)
        assert c.builds == 1 and c.backend_compiles == 1
        assert c.sites == [("native.quiver_cpu", None)]
        dict.clear(native._libs)
        with count_jit_builds() as c2:
            native.load(native.SRC, native._declare_sampler)
        assert c2.builds == 1 and c2.backend_compiles == 0
    finally:
        reg.disable_persistent_cache()
        dict.clear(native._libs)
        dict.update(native._libs, saved)


def test_patches_are_restored_on_exit():
    from quiver_tpu_torch.cpp import native
    from quiver_tpu_torch.ops.cuda import build
    from quiver_tpu_torch.recovery.registry import ProgramCache

    before = (ProgramCache.__setitem__, build._start, native.build)
    with count_jit_builds():
        assert ProgramCache.__setitem__ is not before[0]
        assert build._start is not before[1]
        assert native.build is not before[2]
    assert (ProgramCache.__setitem__, build._start, native.build) == before


def test_enforce_budget_failure_message():
    c = JitBuildCounter()
    for B in (8, 16, 32, 64):
        c.record("sampler._build_jit", B)
    with pytest.raises(pytest.fail.Exception,
                       match=r"retrace budget exceeded: 4 build"):
        enforce_budget(c, builds=3, nodeid="test_x")
    enforce_budget(c, builds=4)
    c.backend_compiles = 9
    with pytest.raises(pytest.fail.Exception, match="compiler run"):
        enforce_budget(c, builds=None, backend_compiles=2)
    c.backend_available = False
    enforce_budget(c, builds=None, backend_compiles=0)


def test_cache_busting_test_fails_in_subprocess(tmp_path):
    """A test that builds more than its budget must FAIL, in a real pytest
    subprocess that loads the plugin with ``-p``; one within its budget
    passes."""
    (tmp_path / "test_bust.py").write_text(textwrap.dedent("""
        import numpy as np
        import pytest

        from quiver_tpu_torch import CSRTopo, GraphSageSampler


        def _sampler():
            rng = np.random.default_rng(0)
            src = rng.integers(0, 60, 400)
            dst = rng.integers(0, 60, 400)
            topo = CSRTopo(edge_index=np.stack([src, dst]))
            return GraphSageSampler(topo, [3, 2], device="cpu")


        @pytest.mark.torch_retrace_budget(1)
        def test_cache_buster():
            s = _sampler()
            for B in (4, 8, 16):     # 3 distinct shapes, budget is 1
                s.sample(np.arange(B, dtype=np.int32))


        @pytest.mark.torch_retrace_budget(3, backend_compiles=0)
        def test_within_budget():
            s = _sampler()
            for B in (4, 8, 4, 16, 8):
                s.sample(np.arange(B, dtype=np.int32))
    """))
    env = {k: v for k, v in os.environ.items() if k != "QUIVER_SANITIZE"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "test_bust.py", "-q", "-p",
         "no:cacheprovider", "-p", "quiver_tpu_torch.analysis.retrace_guard"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "retrace budget exceeded" in proc.stdout
    assert "3 build(s) > budget 1" in proc.stdout
    assert "1 failed, 1 passed" in proc.stdout


# --------------------------------------- the repairs the lint asked for
def test_topology_pickles_without_its_lock():
    topo = qt.CSRTopo(edge_index=_graph())
    ip, ix = topo.to_device("cpu")
    back = pickle.loads(pickle.dumps(topo))
    assert back._device_arrays == {}
    ip2, ix2 = back.to_device("cpu")
    assert torch.equal(ip, ip2) and torch.equal(ix, ix2)
    assert back.to_device("cpu")[0] is ip2


def test_racing_first_uploads_place_one_copy():
    topo = qt.CSRTopo(edge_index=_graph())
    got, barrier = [], threading.Barrier(4)

    def first_use():
        barrier.wait()
        got.append(topo.to_device("cpu"))

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(p[0]) for p in got}) == 1


def test_upload_wraps_host_arrays_on_the_cpu():
    from quiver_tpu_torch.utils.staging import upload

    a = np.arange(6, dtype=np.int32).reshape(2, 3)[:, ::2]
    t = upload(a, "cpu")
    assert t.dtype == torch.int32 and torch.equal(t, torch.from_numpy(
        np.ascontiguousarray(a)))
    b = np.arange(4, dtype=np.int64)
    assert upload(b, torch.device("cpu")).data_ptr() == b.ctypes.data


def test_a_wait_inside_an_unobserved_call_gets_through(tw):
    """A wrapped method that is not a transfer (``.to`` of a dtype, or to
    the card) holds no re-entry guard, so the card's own wait inside it
    (its sync-debug warning) is still recorded."""
    transfer_witness.uninstall()
    assert "to" not in torch.Tensor.__dict__  # inherited from the base
    base_to = torch.Tensor.to

    def to_with_a_wait(self, *a, **k):
        warnings.warn("called a synchronizing CUDA operation")
        return base_to(self, *a, **k)

    torch.Tensor.to = to_with_a_wait
    try:
        transfer_witness.install("cpu")
        with staging.no_sync("unit region"):
            torch.arange(3).to(torch.float32)
        vs = transfer_witness.drain()
    finally:
        transfer_witness.uninstall()
        del torch.Tensor.to
        transfer_witness.install("cpu")
    assert len(vs) == 1 and "`cuda sync`" in vs[0].message
