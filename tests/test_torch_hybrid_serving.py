"""Port parity: serving's CPU lane and the sampler's CPU mode.

- ``GraphSageSampler(mode="CPU")`` gives JAX's ``SampledBatch`` bitwise over
  a sequence of calls (the native sampler's counter advances alike), after
  ``set_fanout_frac(0.5)`` and with edge weights; the batch lies on the
  sampler's device with the device mode's dtypes.
- ``RequestBatcher`` routes a fixed plan to the same lane(s) as JAX's in
  all four modes; ``HybridSampler._pad`` equals JAX's.
- A CPU-lane answer equals ``model(feature[batch.n_id], batch.layers)``
  sliced to the request, and the model's logits on a CPU batch agree with
  Flax's (``sage_params_from_flax``) within ``rtol=atol=1e-5``.
- ``_fit_crossover`` equals JAX's on fixed points, the noisy ones of
  ``tests/test_serving.py`` included; ``calibrate_threshold`` returns the
  fit of its own points.
"""

import queue

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.serving import HybridSampler as JaxHybrid
from quiver_tpu.serving import RequestBatcher as JaxBatcher
from quiver_tpu.serving import ServingRequest as JaxRequest
from quiver_tpu.serving import _fit_crossover as jax_fit
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
import quiver_tpu_torch.serving as port_serving
from quiver_tpu_torch.serving import _fit_crossover

N, DIM, HIDDEN, OUT = 900, 10, 16, 5
SIZES = [5, 3]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_registry_emptied():
    """The JAX calls here record metrics in the JAX package's registry when
    its telemetry is on; each test empties the registry after it, so no
    metric recorded here (or left by an earlier file) reaches a later file
    on the same worker (ROADMAP "Open items")."""
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def world():
    indptr, indices = qt.synthetic_csr(N, 10_000, seed=19)
    feat = np.random.default_rng(4).standard_normal((N, DIM)).astype(
        np.float32)
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    jfeat = JaxFeature(device_cache_size=feat.nbytes,
                       csr_topo=jt).from_cpu_tensor(feat)
    pfeat = qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                       device="cpu").from_cpu_tensor(feat)
    return dict(indptr=indptr, indices=indices, feat=feat, jt=jt, pt=pt,
                jfeat=jfeat, pfeat=pfeat)


def _same_batch(pb, jb):
    assert pb.n_id.dtype == torch.int32 and pb.n_id_mask.dtype == torch.bool
    assert pb.num_nodes.dtype == torch.int32 and pb.num_nodes.dim() == 0
    np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
    np.testing.assert_array_equal(pb.n_id_mask.numpy(),
                                  np.asarray(jb.n_id_mask))
    assert int(pb.num_nodes) == int(jb.num_nodes)
    assert pb.batch_size == jb.batch_size
    assert len(pb.layers) == len(jb.layers)
    for p, j in zip(pb.layers, jb.layers):
        assert p.nbr_local.dtype == torch.int32 and p.eid is None
        np.testing.assert_array_equal(p.nbr_local.numpy(),
                                      np.asarray(j.nbr_local))
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
        assert int(p.num_targets) == int(j.num_targets)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "weighted"])
def test_cpu_mode_matches_jax(world, weighted):
    w = (np.random.default_rng(5).random(int(world["indptr"][-1])) + 0.1
         if weighted else None)
    js = JaxSampler(world["jt"], SIZES, mode="CPU", edge_weights=w)
    ps = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu",
                             edge_weights=w)
    assert ps.mode == "CPU"
    rng = np.random.default_rng(2)
    for i in range(4):
        if i == 3:
            js.set_fanout_frac(0.5)
            ps.set_fanout_frac(0.5)
            assert ps._effective_sizes() == js._effective_sizes() == [2, 1]
        seeds = np.concatenate([rng.integers(0, N, 25), [3, 3]])
        _same_batch(ps.sample(seeds), js.sample(seeds))
    ps.set_fanout_frac(1.0)
    assert ps._effective_sizes() == SIZES


def test_mode_names(world):
    pt = world["pt"]
    assert qt.GraphSageSampler(pt, [2], mode="TPU", device="cpu").mode == (
        "GPU")
    assert qt.GraphSageSampler(pt, [2], mode="UVA", device="cpu").mode == (
        "GPU")
    with pytest.raises(ValueError, match="mode"):
        qt.GraphSageSampler(pt, [2], mode="IPU", device="cpu")


def _plan(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N, int(k)) for k in rng.integers(1, 30, n)]


@pytest.mark.parametrize("mode", ["Auto", "CPU", "Device", "Preparation"])
@pytest.mark.parametrize("with_nn", [True, False])
def test_routing_matches_jax(mode, with_nn):
    nn = (np.random.default_rng(1).integers(0, 60, N).astype(np.int64)
          if with_nn else None)
    threshold = 300.0
    jb = JaxBatcher([], neighbour_num=nn, threshold=threshold, mode=mode)
    pb = qt.RequestBatcher([], neighbour_num=nn, threshold=threshold,
                           mode=mode)
    for seq, ids in enumerate(_plan()):
        jb._route(JaxRequest(ids=ids, client=0, seq=seq))
        pb._route(qt.ServingRequest(ids=ids, client=0, seq=seq))

    def drain(q):
        out = []
        while not q.empty():
            out.append(q.get_nowait().seq)
        return out

    got = (drain(pb.cpu_batched_queue), drain(pb.device_batched_queue))
    want = (drain(jb.cpu_batched_queue), drain(jb.device_batched_queue))
    assert got == want
    if mode == "Auto" and with_nn:
        assert got[0] and got[1]  # the plan exercises both lanes
    if mode == "Auto" and not with_nn:
        assert not got[0]


def test_pad_matches_jax(world):
    cs = qt.GraphSageSampler(world["pt"], [3], mode="CPU", device="cpu")
    for buckets in ((4, 8), (8, 16, 32, 64)):
        jh = JaxHybrid(None, queue.Queue(), buckets=buckets)
        ph = qt.HybridSampler(cs, queue.Queue(), buckets=buckets)
        for n in (0, 1, 3, 4, 5, 8, 11, 64, 65):
            ids = np.arange(7, 7 + n, dtype=np.int64)
            np.testing.assert_array_equal(ph._pad(ids), jh._pad(ids))


def _models(world):
    jsamp = JaxSampler(world["jt"], SIZES, gather_mode="xla",
                       sample_rng="hash", dedup="none")
    jb = jsamp.sample(np.arange(8), key=make_key(0))
    model = JaxSAGE(hidden=HIDDEN, out_dim=OUT, num_layers=2, dropout=0.5)
    params = model.init(make_key(1), world["jfeat"].lookup_device(jb.n_id),
                        jb.layers)
    port = qt.GraphSAGE(DIM, HIDDEN, OUT, num_layers=2, device="cpu")
    port.load_state_dict(
        qt.sage_params_from_flax(jax.tree.map(np.asarray, params)))
    return model, params, port.eval()


def test_cpu_lane_logits_match_flax(world):
    """A CPU batch (JAX's and the port's are equal) through each model."""
    model, params, port = _models(world)
    js = JaxSampler(world["jt"], SIZES, mode="CPU")
    ps = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    server = qt.InferenceServer(ps, world["pfeat"], port, None)
    assert not server._fused
    ids = np.random.default_rng(3).integers(0, N, 13)
    padded = server._pad_ids(ids)
    jb, pb = js.sample(padded), ps.sample(padded)
    _same_batch(pb, jb)
    want = np.asarray(model.apply(params, world["jfeat"][np.asarray(
        jb.n_id)], jb.layers))[:13]
    got = server._infer_presampled(qt.ServingRequest(ids=ids, client=0,
                                                     seq=0), pb)
    assert got.shape == (13, OUT)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["Auto", "CPU", "Preparation"])
def test_cpu_lane_answers_equal_direct_forward(world, mode):
    """The lane end to end: batcher -> HybridSampler (2 workers) ->
    InferenceServer_Debug.  Every request is answered (twice under
    ``"Preparation"``); each CPU-lane answer equals the model on its
    logged batch; under ``"Auto"`` both lanes answer."""
    _, _, port = _models(world)
    streams = [queue.Queue() for _ in range(2)]
    results = queue.Queue()
    nn = qt.generate_neighbour_num(world["pt"], SIZES, device="cpu")
    plan = _plan(7, 24)
    loads = sorted(float(nn[ids].sum()) for ids in plan)
    rb = qt.RequestBatcher(streams, neighbour_num=nn,
                           threshold=loads[len(loads) // 2], mode=mode,
                           result_queue=results)
    cpu = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    dev = qt.GraphSageSampler(world["pt"], SIZES, device="cpu")
    hs = qt.HybridSampler(cpu, rb.cpu_batched_queue, num_workers=2,
                          buckets=(8, 16, 32), feature=world["pfeat"],
                          result_queue=results)
    server = qt.InferenceServer_Debug(dev, world["pfeat"], port,
                                      rb.device_batched_queue,
                                      cpu_sampled_queue=hs.sampled_queue,
                                      result_queue=results, seed=2)
    server.BUCKETS = (8, 16, 32)
    reqs = {}
    for seq, ids in enumerate(plan):
        reqs[seq] = qt.ServingRequest(ids=ids, client=seq % 2, seq=seq)
        streams[seq % 2].put(reqs[seq])
    rb.start()
    hs.start()
    server.start()
    want = len(plan) * (2 if mode == "Preparation" else 1)
    answers = []
    for _ in range(want):
        req, out = results.get(timeout=60)
        assert not isinstance(out, Exception), out
        assert out.shape == (len(req.ids), OUT) and np.isfinite(out).all()
        answers.append((req.seq, out))
    assert rb.stop() == [] and hs.stop() == [] and server.stop() == []
    cpu_seqs = {seq for _, seq, _ in server.cpu_log}
    if mode == "Auto":
        assert 0 < len(cpu_seqs) < len(plan)
        assert (server.lane_latency["cpu"].count
                + server.lane_latency["device"].count) == len(plan)
    else:
        assert cpu_seqs == set(reqs)
    with torch.inference_mode():
        for _, seq, b in server.cpu_log:
            direct = port(world["pfeat"][b.n_id],
                          b.layers)[: len(reqs[seq].ids)].numpy()
            assert any(np.array_equal(out, direct)
                       for s, out in answers if s == seq), seq
    st = server.stats()
    assert st["count"] == want
    assert {"sample", "gather", "infer", "queue_wait"} <= set(
        st["stage_breakdown_ms"])


def test_fit_crossover_matches_jax():
    pts = ([(l, 1.0, 2.0) for l in (10, 20, 40, 80)]
           + [(l, 3.0, 1.0) for l in (120, 200, 400, 800, 1600)])
    noisy = pts + [(1600.0001, 0.5, 1.0)]
    rng = np.random.default_rng(0)
    rand = [(float(l), float(c), float(d)) for l, c, d in zip(
        rng.integers(0, 1000, 60), rng.random(60), rng.random(60))]
    cases = [pts, noisy, rand, [], [(5, 2.0, 1.0)],
             [(5, 1.0, 2.0), (9, 1.0, 2.0)],
             [(10, 1, 2), (20, 1, 2), (120, 3, 1), (200, 3, 1), (400, 3, 1)],
             [(10, 1, 2), (120, 3, 1)]]
    for c in cases:
        assert _fit_crossover(list(c)) == jax_fit(list(c))
    assert 80 <= _fit_crossover(pts) <= 120
    assert _fit_crossover(noisy) <= 200


def test_calibrate_threshold_fits_its_points(world, monkeypatch):
    _, _, port = _models(world)
    cpu = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    dev = qt.GraphSageSampler(world["pt"], SIZES, device="cpu")
    nn = qt.generate_neighbour_num(world["pt"], SIZES, device="cpu")
    fitted = []

    def spy(points):
        fitted.append(list(points))
        return _fit_crossover(points)

    monkeypatch.setattr(port_serving, "_fit_crossover", spy)
    thr = qt.calibrate_threshold(dev, cpu, world["pfeat"], port, nn, N,
                                 trials=2, sizes=(1, 8))
    assert len(fitted) == 1
    points = fitted[0]
    assert len(points) == 4
    for load, cpu_s, dev_s in points:
        assert cpu_s > 0 and dev_s > 0 and load >= 0
    assert thr == _fit_crossover(points) == jax_fit(points)


def test_unported_arguments_cite_a11(world):
    """``qos=`` and ``cpu_sampler=`` once raised, citing ROADMAP A11; now
    both are taken and act.  QoS: the batcher admits by tenant class and
    answers an over-quota tenant with ``QuotaExceeded``; the server takes
    its admit window.  ``cpu_sampler``: a device pass that fails is served
    through the host sampler instead (``lane="failover"``), its answer the
    CPU lane's forward of the sampled batch."""
    from quiver_tpu_torch import telemetry as ptel
    from quiver_tpu_torch.resilience import (ChaosPlan, QoSController,
                                             QuotaExceeded, TenantClass,
                                             chaos)

    ptel.reset()
    ctl = QoSController({"t": TenantClass("t", rate=1e-3, burst=1)},
                        default="t", ingest="none")
    results = queue.Queue()
    rb = qt.RequestBatcher([], mode="Device", result_queue=results, qos=ctl)
    for seq in range(2):
        rb._route(qt.ServingRequest(ids=np.arange(3), client=0, seq=seq))
    req, exc = results.get_nowait()
    assert req.seq == 1 and isinstance(exc, QuotaExceeded)
    assert rb.device_batched_queue.qsize() == 1

    ps = qt.GraphSageSampler(world["pt"], SIZES, device="cpu")
    cpu = qt.GraphSageSampler(world["pt"], SIZES, mode="CPU", device="cpu")
    port = qt.GraphSAGE(DIM, HIDDEN, OUT, num_layers=2, device="cpu")
    server = qt.InferenceServer_Debug(ps, world["pfeat"], port, queue.Queue(),
                                      cpu_sampler=cpu, qos=ctl,
                                      max_coalesce=1)
    assert server._admit_window_s > 0
    ids = np.random.default_rng(5).integers(0, N, 6)
    server.device_q.put(qt.ServingRequest(ids=ids, client=0, seq=0))
    try:
        with chaos.active(ChaosPlan(seed=1).fail("serving.device_lane")):
            server.start()
            req, out = server.result_queue.get(timeout=60)
    finally:
        assert server.stop() == []
    assert not isinstance(out, Exception), out
    (client, seq, batch), = server.failover_log
    with torch.inference_mode():
        want = port(world["pfeat"][batch.n_id], batch.layers)[:6].numpy()
    np.testing.assert_array_equal(out, want)
    snap = ptel.snapshot()["counters"]
    assert snap["serving_failover_total{direction=device_to_cpu}"] == 1
    assert snap["serving_requests_total{lane=failover,status=ok}"] == 1
    ptel.reset()
