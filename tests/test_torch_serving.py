"""Port parity: GraphSAGE, the fused forward (seeds -> logits) and the
serving lane.

Logits are compared with ``rtol=atol=1e-5`` in fp32: the two backends sum
the neighbour means and the matrix products in different orders, so the
last bits differ; every integer and feature row upstream is bitwise equal
(test_torch_sampler.py).
"""

import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel

N_NODES, DIM, HIDDEN, OUT = 1500, 10, 16, 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _jax_registry_left_empty():
    """The JAX code this file runs sets gauges and counters in the JAX
    package's registry: empty it when the file ends and set JAX's
    telemetry switch back, so nothing reaches a later file on this
    worker."""
    from quiver_tpu import telemetry as jax_telemetry

    on = jax_telemetry.enabled()
    yield
    jax_telemetry.reset()
    jax_telemetry.set_enabled(on)


def _port_counters_added(before: dict) -> dict:
    """The counters the port's registry, their one source, gained since
    ``before`` (a snapshot's ``counters``)."""
    now = ptel.snapshot()["counters"]
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if v != before.get(k, 0.0)}


@pytest.fixture
def port_telemetry_on():
    """The port's registry switched on for a test that reads its
    counters, and the switch set back after."""
    on = ptel.enabled()
    ptel.set_enabled(True)
    yield
    ptel.set_enabled(on)


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


@pytest.fixture(scope="module")
def world():
    """The same graph, features and model weights in both packages."""
    indptr, indices = qt.synthetic_csr(N_NODES, 15_000, seed=9)
    feat = np.random.default_rng(4).standard_normal(
        (N_NODES, DIM)).astype(np.float32)
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    ptopo = qt.CSRTopo(indptr=indptr, indices=indices)
    jfeat = JaxFeature(device_cache_size=feat.nbytes,
                       csr_topo=jtopo).from_cpu_tensor(feat)
    pfeat = qt.Feature(device_cache_size=feat.nbytes, csr_topo=ptopo,
                       device="cpu").from_cpu_tensor(feat)
    jsampler = JaxSampler(jtopo, [6, 4], gather_mode="xla",
                          sample_rng="hash", dedup="none", return_eid=True)
    psampler = qt.GraphSageSampler(ptopo, [6, 4], device="cpu",
                                   return_eid=True)
    return dict(jtopo=jtopo, jfeat=jfeat, pfeat=pfeat, jsampler=jsampler,
                psampler=psampler, n_edges=int(indptr[-1]), feat=feat)


def _jax_model(world, edge_dim=0):
    jb = world["jsampler"].sample(np.arange(8), key=make_key(0))
    x = world["jfeat"].lookup_device(jb.n_id)
    model = JaxSAGE(hidden=HIDDEN, out_dim=OUT, num_layers=2, dropout=0.5)
    etab = None
    if edge_dim:
        etab = jnp.asarray(np.random.default_rng(8).standard_normal(
            (world["n_edges"], edge_dim)).astype(np.float32))
    params = model.init(make_key(1), x, jb.layers, edge_feat_table=etab)
    port = qt.GraphSAGE(DIM, HIDDEN, OUT, num_layers=2, edge_dim=edge_dim,
                        device="cpu")
    port.load_state_dict(
        qt.sage_params_from_flax(jax.tree.map(np.asarray, params)))
    return model, params, port.eval(), etab


@pytest.mark.parametrize("edge_dim", [0, 3])
def test_logits_match_flax(world, edge_dim):
    """Same blocks, converted weights; with ``edge_dim`` the edge-feature
    branch of every layer."""
    model, params, port, etab = _jax_model(world, edge_dim)
    seeds = np.random.default_rng(edge_dim).integers(0, N_NODES, 32)
    key = make_key(12)
    jb = world["jsampler"].sample(seeds, key=key)
    pb = world["psampler"].sample(seeds, key_words=hop_words(key, 2))
    want = np.asarray(model.apply(params, world["jfeat"].lookup_device(
        jb.n_id), jb.layers, edge_feat_table=etab))
    with torch.inference_mode():
        got = port(world["pfeat"].lookup_device(pb.n_id), pb.layers,
                   None if etab is None else torch.tensor(
                       np.asarray(etab))).numpy()
    assert got.shape == (32, OUT)
    np.testing.assert_allclose(got, want, **TOL)


def _server(world, port, **kw):
    return qt.InferenceServer_Debug(world["psampler"], world["pfeat"], port,
                                    queue.Queue(), **kw)


def test_fused_forward_matches_jax(world):
    """Seeds -> sample -> lookup -> model, one padded pass."""
    model, params, port, _ = _jax_model(world)
    server = _server(world, port)
    padded = server._pad_ids(np.arange(3, 40, 3))
    assert len(padded) == 16
    key = make_key(77)
    jb = world["jsampler"].sample(padded, key=key)
    want = np.asarray(model.apply(
        params, world["jfeat"].lookup_device(jb.n_id), jb.layers))
    got = server.fused_forward(padded, hop_words(key, 2)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()


def _submit(streams, sizes, rng):
    reqs = []
    for seq, n in enumerate(sizes):
        c = seq % len(streams)
        req = qt.ServingRequest(ids=rng.integers(0, N_NODES, n), client=c,
                                seq=seq)
        reqs.append(req)
        streams[c].put(req)
    return reqs


def test_server_answers_equal_direct_forward(world):
    """Every answer equals a direct fused forward of its pass's recorded
    padded ids and key words; coalesced and chunked passes split back to
    the right requests."""
    _, _, port, _ = _jax_model(world)
    streams = [queue.Queue() for _ in range(3)]
    results = queue.Queue()
    rb = qt.RequestBatcher(streams, mode="Device", result_queue=results)
    server = qt.InferenceServer_Debug(world["psampler"], world["pfeat"],
                                      port, rb.device_batched_queue,
                                      result_queue=results, max_coalesce=4,
                                      seed=5)
    server.BUCKETS = (8, 16, 32)
    sizes = [1, 5, 3, 40, 7, 12, 2, 70, 9, 4, 16, 1]
    reqs = _submit(streams, sizes, np.random.default_rng(0))
    rb.start()
    deadline = threading.Event()
    for _ in range(200):  # queue everything first so passes coalesce
        if rb.device_batched_queue.qsize() == len(reqs):
            break
        deadline.wait(0.01)
    server.start()
    answers = {}
    for _ in reqs:
        req, out = results.get(timeout=60)
        assert not isinstance(out, Exception), out
        answers[(req.client, req.seq)] = out
    assert rb.stop() == [] and server.stop() == []

    by_key = {(r.client, r.seq): r for r in reqs}
    coalesced = chunked = False
    for members, chunks in server.pass_log:
        coalesced |= len(members) > 1
        chunked |= len(chunks) > 1
        total = sum(len(by_key[m].ids) for m in members)
        direct = np.concatenate([
            server.fused_forward(p, kw).numpy()[:min(32, total - 32 * i)]
            for i, (p, kw) in enumerate(chunks)])
        off = 0
        for m in members:
            n = len(by_key[m].ids)
            assert answers[m].shape == (n, OUT)
            np.testing.assert_array_equal(answers[m], direct[off: off + n])
            off += n
    assert coalesced and chunked
    assert len(answers) == len(reqs)
    st = server.stats()
    assert st["count"] == len(reqs)
    assert set(st) == {"count", "avg_latency_ms", "p50_latency_ms",
                       "p99_latency_ms", "throughput_rps",
                       "stage_breakdown_ms"}
    assert set(st["stage_breakdown_ms"]) == {"infer", "queue_wait"}


def test_server_pass_depends_on_padding(world):
    """Hop-2 counters follow the padded batch, so the same ids in another
    bucket sample another neighbourhood: padding must be kept."""
    _, _, port, _ = _jax_model(world)
    server = _server(world, port)
    ids = np.arange(5)
    kw = hop_words(make_key(2), 2)
    a = server.fused_forward(server._pad_ids(ids), kw)[:5]
    b = server.fused_forward(np.concatenate([ids, np.zeros(11, ids.dtype)]),
                             kw)[:5]
    assert not torch.equal(a, b)


def test_histogram_matches_jax_registry():
    """The port's copy of the latency histogram reads the same mean and
    percentiles as the JAX package's for the same observations."""
    from quiver_tpu.telemetry.registry import Histogram as JaxHistogram
    from quiver_tpu_torch.telemetry import Histogram

    obs = np.random.default_rng(3).lognormal(-4.0, 1.5, 500)
    jh, ph = JaxHistogram("h"), Histogram("h")
    for v in obs:
        jh.observe(v)
        ph.observe(v)
    assert ph.count == jh.count == 500
    assert ph.mean == jh.mean
    for q in (0, 1, 50, 90, 99, 100):
        assert ph.percentile(q) == jh.percentile(q), q


def test_batcher_modes():
    """The JAX package's four modes, ``"Auto"`` by default (every request
    to the device lane without ``neighbour_num``); any other name raises.
    ``qos=`` is taken: with a result queue the lanes become weighted-fair
    lanes over its classes, and admission stamps each request's class."""
    rb = qt.RequestBatcher([queue.Queue()])
    assert rb.mode == "Auto"
    rb._route(qt.ServingRequest(ids=np.arange(3), client=0, seq=0))
    assert rb.device_batched_queue.qsize() == 1
    assert rb.cpu_batched_queue.qsize() == 0
    for mode in ("Auto", "CPU", "Device", "Preparation"):
        assert qt.RequestBatcher([queue.Queue()], mode=mode).mode == mode
    with pytest.raises(ValueError, match="mode"):
        qt.RequestBatcher([queue.Queue()], mode="GPU")
    from quiver_tpu_torch.resilience import (QoSController, TenantClass,
                                             WeightedFairLane)

    ctl = QoSController({"gold": TenantClass("gold", weight=8, priority=3),
                         "bronze": TenantClass("bronze", priority=0)},
                        default="bronze", ingest="none")
    results = queue.Queue()
    rb = qt.RequestBatcher([queue.Queue()], mode="Device",
                           result_queue=results, qos=ctl)
    assert isinstance(rb.device_batched_queue, WeightedFairLane)
    req = qt.ServingRequest(ids=np.arange(3), client=0, seq=0, tenant="gold")
    rb._route(req)
    assert req.tenant_class == "gold" and req.priority == 3
    assert rb.device_batched_queue.class_depths() == {"gold": 1}
    assert results.empty()


# -- the unfused lane over a budgeted feature ----------------------------------

HOT_ROWS = 600  # of 1500: the cold tail stays on the host


def _budgeted(world, paged_pool=None):
    """A budgeted port feature in degree order (its own topology object:
    ``from_cpu_tensor`` writes ``csr_topo.feature_order``)."""
    jtopo = world["jtopo"]
    f = qt.Feature(device_cache_size=HOT_ROWS, cache_unit="rows",
                   csr_topo=qt.CSRTopo(indptr=jtopo.indptr,
                                       indices=jtopo.indices),
                   device="cpu").from_cpu_tensor(world["feat"])
    if paged_pool is not None:
        f.enable_paging(page_rows=8, pool_pages=paged_pool)
    return f


@pytest.mark.parametrize("pool", [None, 10_000, 4],
                         ids=["overlay", "paged", "paged-overflow"])
def test_unfused_lane_matches_jax(world, pool, port_telemetry_on):
    """A budgeted feature takes the unfused lane; for the same key words
    its frontier and gathered rows equal JAX's sampler and
    ``Feature.__getitem__`` bitwise, and its logits JAX's ``apply``."""
    model, params, port, _ = _jax_model(world)
    jtopo = world["jtopo"]
    jfeat = JaxFeature(device_cache_size=HOT_ROWS, cache_unit="rows",
                       csr_topo=JaxTopo(indptr=jtopo.indptr,
                                        indices=jtopo.indices)
                       ).from_cpu_tensor(world["feat"])
    before = ptel.snapshot()["counters"]
    pfeat = _budgeted(world, pool)
    server = qt.InferenceServer(world["psampler"], pfeat, port, None)
    assert not server._fused and pfeat.cold_cache is not None
    for i, n in enumerate((13, 40, 13)):
        padded = server._pad_ids(np.arange(2, 2 + 7 * n, 7) % N_NODES)
        key = make_key(50 + i)
        jb = world["jsampler"].sample(padded, key=key)
        jx = np.asarray(jfeat[np.asarray(jb.n_id)])
        want = np.asarray(model.apply(params, jfeat[np.asarray(jb.n_id)],
                                      jb.layers))
        kw = hop_words(key, 2)
        pb = world["psampler"].sample(padded, key_words=kw)
        np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
        np.testing.assert_array_equal(pfeat[pb.n_id].numpy(), jx)
        np.testing.assert_array_equal(jx, world["feat"][np.asarray(jb.n_id)])
        got = server.unfused_forward(padded, kw).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    c = _port_counters_added(before)
    if pool == 10_000:
        assert c["feature_page_faults_total"] > 0
        assert "feature_page_fallback_total" not in c
    elif pool == 4:
        assert c["feature_page_fallback_total"] > 0
    assert c["feature_rows_total{tier=cold}"] > 0


def test_unfused_server_answers_equal_direct_forward(world,
                                                      port_telemetry_on):
    """The lane end to end over a paged budgeted feature: every answer
    equals the unfused forward of its pass's recorded padded ids and key
    words, and the stage split has the JAX keys."""
    _, _, port, _ = _jax_model(world)
    streams = [queue.Queue() for _ in range(2)]
    results = queue.Queue()
    rb = qt.RequestBatcher(streams, mode="Device", result_queue=results)
    before = ptel.snapshot()["counters"]
    feat = _budgeted(world, 10_000)
    server = qt.InferenceServer_Debug(world["psampler"], feat, port,
                                      rb.device_batched_queue,
                                      result_queue=results, max_coalesce=4,
                                      seed=3)
    server.BUCKETS = (8, 16, 32)
    reqs = _submit(streams, [3, 9, 40, 1, 6, 17], np.random.default_rng(2))
    rb.start()
    server.start()
    answers = {}
    for _ in reqs:
        req, out = results.get(timeout=60)
        assert not isinstance(out, Exception), out
        answers[(req.client, req.seq)] = out
    assert rb.stop() == [] and server.stop() == []
    by_key = {(r.client, r.seq): r for r in reqs}
    for members, chunks in server.pass_log:
        total = sum(len(by_key[m].ids) for m in members)
        direct = np.concatenate([
            server.unfused_forward(p, kw).numpy()[:min(32, total - 32 * i)]
            for i, (p, kw) in enumerate(chunks)])
        off = 0
        for m in members:
            n = len(by_key[m].ids)
            np.testing.assert_array_equal(answers[m], direct[off: off + n])
            off += n
    assert len(answers) == len(reqs)
    st = server.stats()
    assert set(st["stage_breakdown_ms"]) == {"sample", "gather", "infer",
                                             "queue_wait"}
    assert _port_counters_added(before)["feature_page_faults_total"] > 0


def test_lane_choice_and_overlay_veto(world):
    """``fused=False`` on a full feature gives the fused lane's logits;
    ``cold_cache_size="off"`` keeps the server from attaching the
    overlay."""
    from quiver_tpu_torch import config

    _, _, port, _ = _jax_model(world)
    fused = _server(world, port)
    unfused = _server(world, port, fused=False)
    assert fused._fused and not unfused._fused
    padded = fused._pad_ids(np.arange(0, 60, 5))
    kw = hop_words(make_key(8), 2)
    assert torch.equal(unfused.unfused_forward(padded, kw),
                       fused.fused_forward(padded, kw))
    with config.override(cold_cache_size="off"):
        feat = _budgeted(world)
        qt.InferenceServer(world["psampler"], feat, port, None)
    assert feat.cold_cache is None
    with pytest.raises(RuntimeError, match="whole table"):
        qt.InferenceServer(world["psampler"], feat, port, None,
                           fused=True).fused_forward(padded, kw)
