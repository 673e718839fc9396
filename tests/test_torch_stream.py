"""Port parity: ``quiver_tpu_torch.stream`` (delta segment, streaming
graph, compactor, ingest lane) against the JAX package's
``tests/test_stream.py`` and the JAX objects on the same inputs.

* **Equivalence** — zero pending deltas sample bit-identical to the frozen
  path (and to JAX's streaming sampler); a folded graph samples
  bit-identical to a fresh frozen sampler on the new base, whose arrays
  equal JAX's fold of the same mutations.
* **Deletion** — a tombstoned edge is never drawn, before or after a fold.
* **Time windows** — ``lo <= ts < hi`` on base and delta edges; a new
  window reuses the sampler's entry.
* **Steady-state ingestion** builds no pipeline entry within one delta
  bucket (``recovery.registry``'s ``sampler`` subsystem).
* **Ingest** — acks, backpressure folds and chaos answers equal JAX's for
  the same submissions, and the counters tick alike.
* **Serving** — the fused lane samples the current snapshot, as the
  unfused lane does; JAX's fused lane closes over the frozen base and
  ignores a delta edge (ROADMAP §C, "found in the reference").

JAX references run ``gather_mode="xla", sample_rng="hash"``.
"""

import queue
import threading
import time

import jax
import numpy as np
import pytest

from quiver_tpu import telemetry as jtel
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.serving import InferenceServer as JaxServer
from quiver_tpu.stream import (DeltaStore as JaxDeltaStore,
                               IngestLane as JaxLane,
                               StreamingGraph as JaxGraph,
                               compact as jax_compact)
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import metric_key
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.recovery.registry import get_program_registry
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.stream import (Compactor, DeltaStore, IngestLane,
                                     StreamingGraph, compact)
from quiver_tpu_torch.telemetry import flightrec as pflightrec

TOL = dict(rtol=1e-5, atol=1e-5)
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, chaos plans, QoS and flight recorders
    start and end empty; JAX's telemetry is on for the test and back at
    its process default after."""
    for tel, chaos, rec, qos in ((ptel, pchaos, pflightrec, pqos),
                                 (jtel, jchaos, jflightrec, jqos)):
        tel.set_enabled(True)
        tel.reset()
        chaos.uninstall()
        rec.reset()
        qos.reset()
    yield
    for tel, chaos, rec, qos in ((ptel, pchaos, pflightrec, pqos),
                                 (jtel, jchaos, jflightrec, jqos)):
        chaos.uninstall()
        rec.set_version_provider(None)
        rec.reset()
        qos.reset()
        tel.reset()
    get_program_registry().unseal()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def counter(tel, name, **labels):
    return tel.snapshot()["counters"].get(metric_key(name, labels), 0)


def _random_edges(rng, n=500, e=2000):
    ei = np.stack([rng.integers(0, n, size=e), rng.integers(0, n, size=e)])
    ei[:, -1] = n - 1
    return ei


def _star(n_nodes=200, fanout=9, jax_side=False):
    """node 0 -> 1..fanout, plus a self-loop pinning node_count."""
    src = np.append(np.zeros(fanout, np.int64), n_nodes - 1)
    dst = np.append(np.arange(1, fanout + 1), n_nodes - 1)
    ei = np.stack([src, dst])
    return JaxTopo(edge_index=ei) if jax_side else qt.CSRTopo(edge_index=ei)


def _words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def _sampler(g, sizes, **kw):
    return qt.GraphSageSampler(g, sizes, device="cpu", gather_mode="xla",
                               **kw)


def _neighbours(batch):
    """The neighbour ids drawn for a single-seed batch's first hop."""
    mask = batch.layers[-1].mask.numpy()[0]
    return set(int(x) for x in batch.n_id.numpy()[1:1 + len(mask)][mask])


def _assert_same(a, b):
    for x, y in zip((a.n_id, a.n_id_mask), (b.n_id, b.n_id_mask)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        np.testing.assert_array_equal(np.asarray(la.nbr_local),
                                      np.asarray(lb.nbr_local))
        np.testing.assert_array_equal(np.asarray(la.mask),
                                      np.asarray(lb.mask))


# -- DeltaStore -------------------------------------------------------------
class TestDeltaStore:
    def _both(self, **kw):
        return DeltaStore(**kw), JaxDeltaStore(**kw)

    def _same_state(self, p, j):
        for a, b in zip(p.live_edges(), j.live_edges()):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        assert (p.n, p.live) == (j.n, j.live)

    def test_append_order_and_live_edges(self):
        p, j = self._both(capacity=8)
        for d in (p, j):
            d.add([1, 2], [3, 4])
            d.add(5, 6)
        src, dst, ts = p.live_edges()
        np.testing.assert_array_equal(src, [1, 2, 5])
        np.testing.assert_array_equal(dst, [3, 4, 6])
        assert ts is None and p.live == 3
        self._same_state(p, j)

    def test_kill_marks_last_live_match(self):
        p, j = self._both(capacity=8)
        for d in (p, j):
            d.add([1, 1, 1], [2, 2, 3])
            assert d.kill(1, 2)
            assert not d.kill(9, 9)
        np.testing.assert_array_equal(p.dead[:3], j.dead[:3])
        np.testing.assert_array_equal(p.dead[:3], [False, True, False])
        self._same_state(p, j)

    def test_capacity_backpressure(self):
        p = DeltaStore(capacity=2)
        p.add([1, 2], [3, 4])
        with pytest.raises(BufferError):
            p.add(5, 6)
        p.clear()
        p.add(5, 6)
        assert p.live == 1

    def test_timestamps_required_when_declared(self):
        p, j = self._both(capacity=4, has_ts=True)
        with pytest.raises(ValueError):
            p.add(1, 2)
        for d in (p, j):
            d.add([1, 3], [2, 4], ts=[7, 9])
        self._same_state(p, j)


# -- equivalence ------------------------------------------------------------
def test_zero_delta_bitwise_equivalence():
    rng = np.random.default_rng(0)
    ei = _random_edges(rng)
    g = StreamingGraph(qt.CSRTopo(edge_index=ei))
    jg = JaxGraph(JaxTopo(edge_index=ei))
    stream = _sampler(g, [5, 3])
    frozen = _sampler(qt.CSRTopo(edge_index=ei), [5, 3], dedup="none")
    jstream = JaxSampler(jg, sizes=[5, 3], gather_mode="xla",
                         sample_rng="hash")
    seeds = rng.integers(0, g.node_count, size=16)
    for s in range(3):
        kw = _words(make_key(s), 2)
        bs = stream.sample(seeds, key_words=kw)
        _assert_same(bs, frozen.sample(seeds, key_words=kw))
        _assert_same(bs, jstream.sample(seeds, key=make_key(s)))
        assert bs.version == 0


def _mutate(g, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    n = g.node_count
    g.add_edges(rng.integers(0, n, 40), rng.integers(0, n, 40))
    u = int(np.argmax(g.base.degree))
    v = int(g.base.indices[g.base.indptr[u]])
    g.remove_edges([u], [v])


def test_post_compaction_bitwise_equivalence():
    rng = np.random.default_rng(1)
    ei = _random_edges(rng)
    g = StreamingGraph(qt.CSRTopo(edge_index=ei))
    jg = JaxGraph(JaxTopo(edge_index=ei))
    sampler = _sampler(g, [5, 3])
    for graph in (g, jg):
        _mutate(graph)
    stats, jstats = compact(g), jax_compact(jg)
    assert stats["dropped"] == 1 and stats["folded"] == 40
    for k in ("folded", "dropped", "version", "edges"):
        assert stats[k] == jstats[k], k
    np.testing.assert_array_equal(g.base.indptr, jg.base.indptr)
    np.testing.assert_array_equal(g.base.indices, jg.base.indices)
    assert g.pending_deltas == 0 and g.tombstone_count == 0
    fresh = _sampler(g.base, [5, 3], dedup="none")
    seeds = rng.integers(0, g.node_count, size=16)
    for s in range(3):
        kw = _words(make_key(s), 2)
        _assert_same(sampler.sample(seeds, key_words=kw),
                     fresh.sample(seeds, key_words=kw))


def test_compaction_folds_timestamps_like_jax():
    rng = np.random.default_rng(2)
    ei = _random_edges(rng, n=100, e=600)
    topo = qt.CSRTopo(edge_index=ei)
    ts = rng.integers(0, 1000, topo.edge_count)
    g = StreamingGraph(topo, edge_ts=ts)
    jg = JaxGraph(JaxTopo(edge_index=ei), edge_ts=ts)
    for graph in (g, jg):
        graph.add_edges([3, 3, 9], [4, 5, 6], ts=[11, 12, 13])
        graph.remove_edges(ei[0][:20:4], ei[1][:20:4])
        compact(graph) if graph is g else jax_compact(graph)
    np.testing.assert_array_equal(g._base_ts, jg._base_ts)
    np.testing.assert_array_equal(g.base.indices, jg.base.indices)
    assert g.version == jg.version
    # the old base's device placement was dropped and its version bumped
    assert topo.version == 1 and topo._device_arrays == {}


def test_tombstoned_edge_never_sampled():
    g = StreamingGraph(_star())
    s = _sampler(g, [4])
    g.remove_edges([0], [5])
    seen = set()
    for i in range(50):
        seen |= _neighbours(s.sample([0], key_words=_words(make_key(i), 1)))
    assert 5 not in seen and seen <= set(range(1, 10))
    compact(g)
    for i in range(50):
        seen |= _neighbours(s.sample([0], key_words=_words(make_key(i), 1)))
    assert 5 not in seen


def test_delta_edges_join_the_frontier():
    g = StreamingGraph(_star())
    s = _sampler(g, [4])
    g.add_edges([0, 0], [100, 101])
    seen = set()
    for i in range(80):
        seen |= _neighbours(s.sample([0], key_words=_words(make_key(i), 1)))
    assert {100, 101} <= seen


def test_rejects_node_additions_and_frozen_windows():
    g = StreamingGraph(_star(n_nodes=10))
    with pytest.raises(ValueError):
        g.add_edges([0], [10])
    with pytest.raises(ValueError):
        g.add_edges([-1], [0])
    frozen = _sampler(_star(), [4], dedup="none")
    with pytest.raises(ValueError, match="StreamingGraph"):
        frozen.sample([0], time_window=(0, 5))


def test_stream_sampler_refuses_host_modes_dedup_and_weights():
    """As in JAX: the device mode, the positional pipeline, uniform."""
    g = StreamingGraph(_star())
    jg = JaxGraph(_star(jax_side=True))
    for mode in ("CPU", "UVA"):
        with pytest.raises(ValueError, match="device mode"):
            qt.GraphSageSampler(g, [4], device="cpu", mode=mode,
                                uva_budget=64)
        with pytest.raises(ValueError):
            JaxSampler(jg, sizes=[4], mode=mode, uva_budget=64)
    with pytest.raises(ValueError, match="positional"):
        _sampler(g, [4], dedup="hop")
    with pytest.raises(AssertionError):
        JaxSampler(jg, sizes=[4], dedup="hop")
    with pytest.raises(ValueError, match="uniform"):
        _sampler(g, [4], edge_weights=np.ones(10))
    s = _sampler(g, [4])
    assert s.dedup == "none" and s.csr_topo is g.base


# -- time windows -----------------------------------------------------------
def test_time_window_filters_edges():
    topo = _star()
    ts = np.zeros(topo.edge_count, np.int64)
    ts[topo.indptr[0]:topo.indptr[1]] = topo.indices[
        topo.indptr[0]:topo.indptr[1]]
    g = StreamingGraph(topo, edge_ts=ts)
    s = _sampler(g, [9])
    b = s.sample([0], key_words=_words(make_key(1), 1), time_window=(3, 7))
    assert _neighbours(b) <= {3, 4, 5, 6}
    seen = set()
    for i in range(40):
        seen |= _neighbours(s.sample([0], key_words=_words(make_key(i), 1),
                                     time_window=(1, 10)))
    assert seen == set(range(1, 10))
    assert len(s._programs) == 1  # a new window is an argument, not a key


def test_time_window_applies_to_delta_edges():
    topo = _star()
    g = StreamingGraph(topo, edge_ts=np.full(topo.edge_count, 5, np.int64))
    s = _sampler(g, [9])
    g.add_edges([0, 0], [50, 60], ts=[2, 8])
    seen = set()
    for i in range(60):
        seen |= _neighbours(s.sample([0], key_words=_words(make_key(i), 1),
                                     time_window=(4, 9)))
    assert 60 in seen and 50 not in seen and seen >= {1, 2, 3}


def test_windowed_requires_timestamps():
    s = _sampler(StreamingGraph(_star()), [4])
    with pytest.raises(ValueError, match="edge_ts"):
        s.sample([0], time_window=(0, 5))


# -- invalidation, versions -------------------------------------------------
def test_mutations_invalidate_attached_feature_rows():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((64, 8)).astype(np.float32)
    f = qt.Feature(device_cache_size=16, cache_unit="rows",
                   device="cpu").from_cpu_tensor(feats)
    f.enable_cold_cache(rows=16, admit_threshold=2)
    g = StreamingGraph(_star(n_nodes=64))
    g.attach_feature(f)
    cold = 40  # past the 16-row hot prefix
    for _ in range(2):  # the second touch admits
        f[np.array([cold])]
    assert f.cold_cache.probe(np.array([cold - 16]))[0].all()
    g.add_edges([cold], [1])
    assert not f.cold_cache.probe(np.array([cold - 16]))[0].any()
    for _ in range(2):
        f[np.array([cold])]
    assert f.cold_cache.probe(np.array([cold - 16]))[0].all()
    assert counter(ptel, "coldcache_invalidated_rows_total") >= 1


def test_graph_version_stamped_on_traces():
    g = StreamingGraph(_star())
    assert pflightrec.graph_version() == 0
    g.add_edges([0], [11])
    t = pflightrec.new_trace()
    assert t.graph_version == 1
    assert t.to_record()["graph_version"] == 1
    g.close()
    assert pflightrec.graph_version() is None


def test_steady_state_ingestion_builds_no_entry():
    """Mutations within one delta bucket reuse the sampler's one entry:
    the registry counts one build and no more (JAX's
    ``test_steady_state_ingestion_holds_retrace_budget``)."""
    reg = get_program_registry()
    g = StreamingGraph(_star(), delta_capacity=256)
    s = _sampler(g, [4])
    seeds = np.zeros(8, np.int64)
    before = reg.stats()["sampler"]["builds"]
    s.sample(seeds, key_words=_words(make_key(0), 1))
    reg.seal(budget=0)
    for i in range(20):
        g.add_edges([0], [20 + i])
        s.sample(seeds, key_words=_words(make_key(i), 1))
    assert reg.stats()["sampler"]["builds"] == before + 1
    assert list(s._programs) == [("stream", 8, 128, 128, False, False)]


# -- ingest lane ------------------------------------------------------------
def _drain(lane, n, timeout=10):
    return [lane.results.get(timeout=timeout) for _ in range(n)]


def _outcomes(acks):
    return [o if isinstance(o, tuple) else type(o).__name__
            for _, o in acks]


def test_ingest_lane_applies_and_acks_like_jax():
    outs = []
    for Graph, Lane, topo, tel in (
            (StreamingGraph, IngestLane, _star(), ptel),
            (JaxGraph, JaxLane, _star(jax_side=True), jtel)):
        g = Graph(topo, delta_capacity=64)
        lane = Lane(g, depth=32).start()
        try:
            ups = [lane.submit(0, 10 + i) for i in range(8)]
            outs.append(_outcomes(_drain(lane, 8)))
            assert g.pending_deltas == 8
            assert all(u.admitted_version >= 0 for u in ups)
            assert counter(tel, "stream_edges_applied_total", op="add") == 8
        finally:
            lane.stop()
            g.close()
    assert outs[0] == outs[1]
    assert all(o[0] == "ok" for o in outs[0])


def test_ingest_backpressure_compacts_inline():
    g = StreamingGraph(_star(), delta_capacity=8)
    lane = IngestLane(g, depth=64).start()
    try:
        for i in range(20):
            lane.submit(0, 10 + i)
        acks = _drain(lane, 20)
        assert all(isinstance(o, tuple) and o[0] == "ok" for _, o in acks)
        assert counter(ptel, "stream_compactions_total") >= 1
        assert set(g.base.indices[:g.base.indptr[1]]) | set(
            g._delta.live_edges()[1]) >= set(range(10, 30))
    finally:
        lane.stop()


def test_ingest_chaos_fault_is_answered_not_dropped():
    outs = []
    for Graph, Lane, chaos, topo, tel in (
            (StreamingGraph, IngestLane, pchaos, _star(), ptel),
            (JaxGraph, JaxLane, jchaos, _star(jax_side=True), jtel)):
        g = Graph(topo, delta_capacity=64)
        lane = Lane(g, depth=32).start()
        try:
            with chaos.active(chaos.ChaosPlan(seed=7).fail("stream.ingest",
                                                           times=1)):
                for i in range(4):
                    lane.submit(0, 10 + i)
                outs.append(_outcomes(_drain(lane, 4)))
            assert counter(tel, "stream_ingest_errors_total") == 1
            assert g.pending_deltas == 3
        finally:
            lane.stop()
            g.close()
    assert outs[0] == outs[1]
    assert outs[0].count("ChaosFault") == 1


def test_compactor_retries_after_chaos_fault():
    g = StreamingGraph(_star(), delta_capacity=64)
    g.add_edges([0, 0], [30, 31])
    comp = Compactor(g, interval_s=0.05, watermark=1.0, poll_s=0.01)
    try:
        with pchaos.active(pchaos.ChaosPlan(seed=7).fail("stream.compact",
                                                         times=1)):
            comp.start()
            deadline = time.time() + 10
            while g.pending_deltas and time.time() < deadline:
                time.sleep(0.02)
        assert g.pending_deltas == 0
        assert counter(ptel, "stream_compact_errors_total") == 1
        assert counter(ptel, "stream_compactions_total") == 1
    finally:
        comp.stop()


def test_e2e_concurrent_ingest_sample_compact_under_chaos():
    """Ingest, sampling and a compaction whose first attempt faults, all
    at once: every update answered ok, sampled versions monotone and
    caught up with the acks, a deleted edge never drawn, one entry
    built a delta bucket."""
    rng = np.random.default_rng(42)
    g = StreamingGraph(qt.CSRTopo(edge_index=_random_edges(rng, 300, 1800)),
                       delta_capacity=128)
    dead_u = int(np.argmax(g.base.degree))
    dead_v = int(g.base.indices[g.base.indptr[dead_u]])
    g.remove_edges([dead_u], [dead_v])
    sampler = _sampler(g, [6])
    lane = IngestLane(g, depth=64).start()
    comp = Compactor(g, interval_s=0.15, watermark=0.5, poll_s=0.01)
    plan = pchaos.ChaosPlan(seed=11).fail("stream.compact", times=1)
    versions, dead_seen, errors = [], [], []
    stop = threading.Event()

    def sample_loop():
        i = 0
        try:
            while not stop.is_set():
                b = sampler.sample(np.full(8, dead_u),
                                   key_words=_words(make_key(i), 1))
                versions.append(b.version)
                m = b.layers[0].mask.numpy()
                nb = b.n_id.numpy()[b.layers[0].nbr_local.numpy()]
                if dead_v in set(nb[m].tolist()):
                    dead_seen.append(i)
                i += 1
        except BaseException as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=sample_loop, daemon=True)
    with pchaos.active(plan):
        comp.start()
        t.start()
        subs = []
        for _ in range(60):
            subs.append(lane.submit(int(rng.integers(0, 300)),
                                    int(rng.integers(0, 300))))
            time.sleep(0.002)
        acks = _drain(lane, 60)
        acked = max(o[2] for _, o in acks if isinstance(o, tuple))
        deadline = time.time() + 30
        while time.time() < deadline and (
                counter(ptel, "stream_compactions_total") < 1
                or not versions or versions[-1] < acked):
            time.sleep(0.02)
    stop.set()
    t.join(timeout=10)
    lane.stop()
    comp.stop()
    assert not errors, errors
    assert all(isinstance(o, tuple) and o[0] == "ok" for _, o in acks)
    assert versions == sorted(versions)
    assert max(versions) >= acked >= max(u.admitted_version for u in subs)
    assert dead_seen == []
    assert counter(ptel, "stream_compact_errors_total") == 1
    assert counter(ptel, "stream_compactions_total") >= 1
    assert plan.hits("stream.compact") >= 2


def test_stream_metrics_ledger_matches_jax():
    snaps = []
    for Graph, topo, tel, fold in ((StreamingGraph, _star(), ptel, compact),
                                   (JaxGraph, _star(jax_side=True), jtel,
                                    jax_compact)):
        g = Graph(topo, delta_capacity=64)
        g.add_edges([0, 0], [20, 21])
        g.remove_edges([0], [1])
        mid = tel.snapshot()
        fold(g)
        end = tel.snapshot()
        hkey = metric_key("stream_compact_pause_seconds", {})
        assert sum(end["histograms"][hkey]["counts"]) == 1
        snaps.append((mid["counters"], mid["gauges"], end["counters"],
                      end["gauges"]))
        g.close()
    assert snaps[0] == snaps[1]
    assert snaps[0][1][metric_key("stream_overlay_bytes", {})] == 16.0


def test_reentrant_listener_registration_does_not_deadlock():
    g = StreamingGraph(_star(), delta_capacity=64)
    late = []
    g.register_invalidation(lambda rows: g.register_invalidation(late.append))
    t = threading.Thread(target=lambda: g.add_edges([0], [50]), daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    g.add_edges([0], [51])
    assert late and 51 in np.asarray(late[-1])


def test_ingest_and_compactor_threads_are_reaped():
    g = StreamingGraph(_star(), delta_capacity=64)
    lane = IngestLane(g, depth=8).start()
    comp = Compactor(g, interval_s=30.0)
    comp.start()
    lane.submit(0, 42)
    lane.results.get(timeout=5)
    lane.stop()
    comp.stop()
    assert not comp.is_alive() and not lane.is_running()
    for component in ("stream.ingest", "stream.compactor"):
        assert counter(ptel, "serving_thread_leak_total",
                       component=component) == 0


# -- serving ----------------------------------------------------------------
HIDDEN, OUT = 8, 3


def _serving_world():
    """A 12-node graph where seed 0 has three neighbours (every one drawn
    at fanout 4), features that tell nodes apart, one GraphSAGE in both
    packages."""
    src = np.array([0, 0, 0, 11])
    dst = np.array([1, 2, 3, 11])
    feat = np.random.default_rng(5).standard_normal(
        (12, 6)).astype(np.float32)
    jg = JaxGraph(JaxTopo(edge_index=np.stack([src, dst])))
    pg = StreamingGraph(qt.CSRTopo(edge_index=np.stack([src, dst])))
    jfeat = JaxFeature(device_cache_size=feat.nbytes).from_cpu_tensor(feat)
    pfeat = qt.Feature(device_cache_size=feat.nbytes,
                       device="cpu").from_cpu_tensor(feat)
    js = JaxSampler(jg, sizes=[4], gather_mode="xla", sample_rng="hash")
    ps = _sampler(pg, [4])
    jb = js.sample(np.arange(8), key=make_key(0))
    model = JaxSAGE(hidden=HIDDEN, out_dim=OUT, num_layers=1, dropout=0.0)
    params = model.init(make_key(1), jfeat.lookup_device(jb.n_id), jb.layers)
    port = qt.GraphSAGE(6, HIDDEN, OUT, num_layers=1, device="cpu")
    port.load_state_dict(
        qt.sage_params_from_flax(jax.tree.map(np.asarray, params)))
    return jg, pg, jfeat, pfeat, js, ps, model, params, port.eval()


def test_fused_lane_samples_the_current_snapshot():
    """After a delta edge, the port's fused lane answers what its unfused
    lane answers, and what JAX's overlay sampler and model answer."""
    jg, pg, jfeat, pfeat, js, ps, model, params, port = _serving_world()
    for g in (jg, pg):
        g.add_edges([0], [7])
    server = qt.InferenceServer_Debug(ps, pfeat, port, queue.Queue())
    assert server._fused
    padded = server._pad_ids(np.array([0]))
    kw = _words(make_key(3), 1)
    fused = server.fused_forward(padded, kw).numpy()
    unfused = server.unfused_forward(padded, kw).numpy()
    np.testing.assert_array_equal(fused, unfused)
    jb = js.sample(padded, key=make_key(3))
    first = np.asarray(jb.n_id)[8:12][np.asarray(jb.layers[0].mask)[0]]
    assert set(first.tolist()) == {1, 2, 3, 7}
    want = np.asarray(model.apply(params, jfeat.lookup_device(jb.n_id),
                                  jb.layers))
    np.testing.assert_allclose(fused, want, **TOL)


def test_jax_fused_lane_ignores_a_delta_edge():
    """Found in the reference, not fixed: JAX's fused lane builds its
    program over ``csr_topo.to_device`` — for a streaming sampler the
    frozen base — so it answers as if the delta edge 0 -> 7 did not
    exist.  The first element that differs from JAX's own overlay
    answer is ``logits[0, 0]``, seed 0's (the one row the edge touches);
    the port's fused lane gives the overlay answer."""
    jg, pg, jfeat, pfeat, js, ps, model, params, port = _serving_world()
    for g in (jg, pg):
        g.add_edges([0], [7])
    jserver = JaxServer(js, jfeat, model.apply, params, queue.Queue())
    padded = np.zeros(8, np.int64)  # seed 0, the bucket of 8
    jax_fused = np.asarray(jserver._fused_forward(padded))
    jb = js.sample(padded, key=make_key(0))
    overlay = np.asarray(model.apply(params, jfeat.lookup_device(jb.n_id),
                                     jb.layers))
    frozen_s = JaxSampler(jg.base, sizes=[4], gather_mode="xla",
                          sample_rng="hash", dedup="none")
    fb = frozen_s.sample(padded, key=make_key(0))
    frozen = np.asarray(model.apply(params, jfeat.lookup_device(fb.n_id),
                                    fb.layers))
    np.testing.assert_allclose(jax_fused, frozen, **TOL)
    differs = ~np.isclose(jax_fused, overlay, **TOL)
    assert tuple(np.argwhere(differs)[0]) == (0, 0)
    server = qt.InferenceServer_Debug(ps, pfeat, port, queue.Queue())
    got = server.fused_forward(padded, _words(make_key(0), 1)).numpy()
    np.testing.assert_allclose(got, overlay, **TOL)
    assert not np.allclose(got, jax_fused, **TOL)
