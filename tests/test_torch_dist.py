"""Port parity: ``quiver_tpu_torch.dist`` (collectives, ``TpuComm``,
``PartitionInfo``, ``DistFeature`` with its overlay and degraded lookup,
``RingFeature``), the data-parallel ``make_train_step(mesh=)`` and
``run_dist_training``, against the JAX package's ``tests/test_dist.py``
and ``tests/test_dist_e2e_scale.py`` cases and the JAX objects on the same
inputs (JAX on ``conftest.py``'s 8 virtual CPU devices, the port on
``[torch.device("cpu")] * n``).

Rows and overflow counts must be bitwise equal to JAX's; data-parallel
losses agree within ``rtol=1e-5``.  One test starts two processes that
join a gloo group through ``dist.initialize`` and exchange through
``TpuComm``'s process-group primitives.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.dist import DistFeature as JaxDistFeature
from quiver_tpu.dist import PartitionInfo as JaxPartitionInfo
from quiver_tpu.dist import RingFeature as JaxRingFeature
from quiver_tpu.dist import TpuComm as JaxComm
from quiver_tpu.dist.sampler import DistGraphSampler as JaxDistSampler
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.parallel.train import make_train_step as jax_train_step
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience.errors import PeerTimeout as JaxPeerTimeout
from quiver_tpu.telemetry import metric_key
from quiver_tpu.utils.mesh import make_mesh as jax_make_mesh
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.dist import all_to_all, pmax, ppermute, psum
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.resilience.errors import PeerTimeout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries and chaos plans start and end empty;
    JAX's telemetry is on for the test and back at its default after."""
    for tel, chaos in ((ptel, pchaos), (jtel, jchaos)):
        tel.set_enabled(True)
        tel.reset()
        chaos.uninstall()
    yield
    for tel, chaos in ((ptel, pchaos), (jtel, jchaos)):
        chaos.uninstall()
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def counter(tel, name, **labels):
    return tel.snapshot()["counters"].get(metric_key(name, labels), 0)


def meshes(n):
    return (qt.make_mesh(("data",), devices=[CPU] * n),
            jax_make_mesh(("data",), devices=jax.devices()[:n]))


def both_features(full, n, g2h, replicate=None, request_cap=None, host=0):
    pm, jm = meshes(n)
    pinfo = qt.PartitionInfo(host=host, hosts=n, global2host=g2h,
                             replicate=replicate)
    jinfo = JaxPartitionInfo(host=host, hosts=n, global2host=g2h,
                             replicate=replicate)
    return (qt.DistFeature.from_global_feature(full, pm, pinfo,
                                               request_cap=request_cap),
            JaxDistFeature.from_global_feature(full, jm, jinfo,
                                               request_cap=request_cap))


# -- collectives ----------------------------------------------------------
def test_allreduce_and_all_to_all_match_jax():
    pm, jm = meshes(8)
    pc, jc = qt.TpuComm(pm, "data"), JaxComm(jm, "data")
    assert pc.n == jc.n == 8 and qt.dist.getNcclId()
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(pc.allreduce(x).numpy(),
                                  np.asarray(jc.allreduce(x)))
    y = np.arange(64, dtype=np.int32).reshape(8, 8, 1)
    got = pc.all_to_all(y).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.all_to_all(y)))
    np.testing.assert_array_equal(got[:, :, 0], y[:, :, 0].T)
    with pytest.raises(NotImplementedError):
        pc.exchange()


def test_collective_helpers():
    parts = [torch.tensor([float(i), -float(i), 0.0]) for i in range(4)]
    assert torch.equal(psum(parts), torch.tensor([6.0, -6.0, 0.0]))
    assert torch.equal(pmax(parts), torch.stack(parts).amax(0))
    neg0 = [torch.tensor([-0.0]), torch.tensor([float("-inf")])]
    assert torch.signbit(pmax(neg0)).item()  # the owner's -0.0 survives
    rot = ppermute(parts, [(0, 1), (1, 2)])
    assert torch.equal(rot[1], parts[0]) and torch.equal(rot[2], parts[1])
    assert torch.equal(rot[0], torch.zeros(3))  # received nothing
    blocks = [torch.arange(3) + 10 * i for i in range(3)]
    out = all_to_all(blocks)
    assert [o.tolist() for o in out] == [[0, 10, 20], [1, 11, 21],
                                         [2, 12, 22]]
    with pytest.raises(ValueError, match="leading axis"):
        all_to_all([torch.zeros(2), torch.zeros(3), torch.zeros(3)])


def test_tpucomm_over_a_process_group(tmp_path):
    """Two processes join a gloo group through ``initialize`` and run
    ``TpuComm``'s two primitives on it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(f"""
        import json, sys, torch
        import quiver_tpu_torch as qt
        rank = int(sys.argv[1])
        assert qt.distributed_initialize() == (1, 0)
        world = qt.distributed_initialize("127.0.0.1:{port}", 2, rank,
                                          backend="gloo")
        comm = qt.TpuComm()
        s = comm.allreduce(torch.tensor([1.0 + rank, 10.0]))
        x = torch.tensor([[rank * 10 + 0], [rank * 10 + 1]])
        m = qt.make_hybrid_mesh(devices=[torch.device("cpu")])
        print(json.dumps(dict(world=list(world), n=comm.n, rank=comm.rank,
                              sum=s.tolist(),
                              a2a=comm.all_to_all(x).tolist(),
                              mesh=dict(m.shape))))
        torch.distributed.destroy_process_group()
    """))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, o in enumerate(outs):
        assert o["world"] == [2, r] and o["n"] == 2 and o["rank"] == r
        assert o["sum"] == [3.0, 20.0]
        assert o["a2a"] == [[r], [10 + r]]
        assert o["mesh"] == {"dcn": 2, "ici": 1}


# -- PartitionInfo / DistFeature -------------------------------------------
def test_partition_info_matches_jax():
    n = 100
    g2h = np.arange(n) % 4
    rep = np.array([3, 50, 97])
    p = qt.PartitionInfo(host=1, hosts=4, global2host=g2h, replicate=rep)
    j = JaxPartitionInfo(host=1, hosts=4, global2host=g2h, replicate=rep)
    for name in ("global2local", "owned_counts", "replicate_mask",
                 "rep_ids"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    assert p.max_local == j.max_local
    ids = np.array([0, 1, 2, 3, 4, 5, 6, 7, 50, 97])
    for a, b in zip(p.dispatch(ids), j.dispatch(ids)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    book = np.random.default_rng(0).integers(0, 5, 40)
    assert qt.PartitionInfo.from_partition_book(book).hosts == \
        JaxPartitionInfo.from_partition_book(book).hosts


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dist_feature_exchange(n):
    rng = np.random.default_rng(n)
    full = rng.normal(size=(256, 8)).astype(np.float32)
    g2h = rng.integers(0, n, 256).astype(np.int32)
    pf, jf = both_features(full, n, g2h)
    ids = rng.integers(0, 256, (n, 32)).astype(np.int32)
    got = pf.lookup(ids).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.lookup(ids)))
    np.testing.assert_array_equal(got, full[ids])
    np.testing.assert_array_equal(pf.overflow_stats(), jf.overflow_stats())


def test_dist_feature_with_replication():
    rng = np.random.default_rng(1)
    full = rng.normal(size=(128, 4)).astype(np.float32)
    g2h = rng.integers(0, 8, 128).astype(np.int32)
    rep = np.array([0, 5, 17, 99])
    pf, jf = both_features(full, 8, g2h, replicate=rep)
    ids = np.tile(rep[None], (8, 8)).astype(np.int32)
    got = pf.lookup(ids).numpy()
    np.testing.assert_array_equal(got, full[ids])
    np.testing.assert_array_equal(got, np.asarray(jf.lookup(ids)))


def test_dist_feature_skewed_and_capped():
    """Every request to one owner: exact at the default cap; under a
    cap of 4 the overflowed queries get zero rows, counted as JAX counts
    them."""
    rng = np.random.default_rng(2)
    full = rng.normal(size=(64, 4)).astype(np.float32)
    g2h = np.zeros(64, dtype=np.int32)
    ids = rng.integers(0, 64, (8, 16)).astype(np.int32)
    pf, jf = both_features(full, 8, g2h)
    np.testing.assert_array_equal(pf.lookup(ids).numpy(), full[ids])
    pf, jf = both_features(full, 8, g2h, request_cap=4)
    got = pf.lookup(ids).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.lookup(ids)))
    ov = pf.overflow_stats()
    np.testing.assert_array_equal(ov, jf.overflow_stats())
    assert ov.tolist() == [12] * 8
    assert counter(ptel, "dist_feature_overflow_total") == \
        counter(jtel, "dist_feature_overflow_total") == 96
    assert (got[:, 4:] == 0).all()


def test_dist_feature_parity_getitem():
    rng = np.random.default_rng(3)
    full = rng.normal(size=(64, 4)).astype(np.float32)
    g2h = rng.integers(0, 8, 64).astype(np.int32)
    pf, jf = both_features(full, 8, g2h, host=2)
    ids = rng.integers(0, 64, 16)
    with pytest.warns(UserWarning, match="broadcasts"):
        got = pf[ids].numpy()
    np.testing.assert_array_equal(got, full[ids])
    np.testing.assert_array_equal(got, np.asarray(jf[ids]))


def test_partition_to_distfeature_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    feature = rng.normal(size=(160, 4)).astype(np.float32)
    probs = [rng.uniform(0, 1, 160) for _ in range(8)]
    _, _, book = qt.quiver_partition_feature(feature, probs, str(tmp_path))
    info = qt.PartitionInfo.from_partition_book(book)
    assert info.hosts == 8
    df = qt.DistFeature.from_global_feature(feature, meshes(8)[0], info)
    ids = rng.integers(0, 160, (8, 16)).astype(np.int32)
    np.testing.assert_array_equal(df.lookup(ids).numpy(), feature[ids])


def test_cold_cache_overlay_matches_jax():
    """This host's recurring remote rows move into the overlay: rows stay
    exact, hits, misses and evictions tick as JAX's, and an invalidated
    row drops from both overlays."""
    rng = np.random.default_rng(5)
    full = rng.normal(size=(300, 6)).astype(np.float32)
    g2h = rng.integers(0, 4, 300).astype(np.int32)
    pf, jf = both_features(full, 4, g2h)
    pf.enable_cold_cache(rows=40, admit_threshold=2)
    jf.enable_cold_cache(rows=40, admit_threshold=2)
    hot = rng.integers(0, 300, 24)
    for step in range(5):
        ids = np.concatenate([np.tile(hot, (4, 1)),
                              rng.integers(0, 300, (4, 8))], 1)
        got = pf.lookup(ids).numpy()
        np.testing.assert_array_equal(got, full[ids])
        np.testing.assert_array_equal(got, np.asarray(jf.lookup(ids)))
    for result in ("hit", "miss"):
        assert counter(ptel, "dist_feature_coldcache_rows_total",
                       result=result) == counter(
            jtel, "dist_feature_coldcache_rows_total", result=result)
    assert counter(ptel, "dist_feature_coldcache_rows_total",
                   result="hit") > 0
    assert counter(ptel, "dist_feature_coldcache_evictions_total") == \
        counter(jtel, "dist_feature_coldcache_evictions_total")
    assert pf.invalidate_rows(hot) == jf.invalidate_rows(hot) > 0
    assert counter(ptel, "coldcache_invalidated_rows_total") == \
        counter(jtel, "coldcache_invalidated_rows_total")


def test_degraded_lookup_on_peer_timeout():
    """A peer timeout in the exchange degrades to the rows each host can
    answer alone (owned, replicated, overlay hits), zeros elsewhere:
    the rows, the mask and the counter equal JAX's."""
    rng = np.random.default_rng(6)
    full = rng.normal(size=(200, 5)).astype(np.float32)
    g2h = rng.integers(0, 4, 200).astype(np.int32)
    rep = np.array([1, 2, 3])
    pf, jf = both_features(full, 4, g2h, replicate=rep)
    pf.enable_cold_cache(rows=32, admit_threshold=1)
    jf.enable_cold_cache(rows=32, admit_threshold=1)
    warm = rng.integers(0, 200, (4, 20))
    pf.lookup(warm)
    jf.lookup(warm)
    ids = np.concatenate([warm[:, :10], rng.integers(0, 200, (4, 10))], 1)
    with pchaos.active(pchaos.ChaosPlan(0).fail(
            "dist.feature.exchange", exc=PeerTimeout("test"))):
        got = pf.lookup(ids).numpy()
    with jchaos.active(jchaos.ChaosPlan(0).fail(
            "dist.feature.exchange", exc=JaxPeerTimeout("test"))):
        want = np.asarray(jf.lookup(ids))
    assert pf.last_degraded and jf.last_degraded
    np.testing.assert_array_equal(pf.last_degraded_mask,
                                  jf.last_degraded_mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[pf.last_degraded_mask],
                                  full[ids][pf.last_degraded_mask])
    assert (got[~pf.last_degraded_mask] == 0).all()
    assert counter(ptel, "dist_feature_degraded_total") == \
        counter(jtel, "dist_feature_degraded_total") == 1
    assert pf.overflow_stats().tolist() == [0] * 4
    got = pf.lookup(ids).numpy()  # the peer is back
    assert not pf.last_degraded
    np.testing.assert_array_equal(got, full[ids])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_feature_lookup(n):
    rng = np.random.default_rng(7 + n)
    full = rng.normal(size=(100, 8)).astype(np.float32)  # padded rows
    pm, jm = meshes(n)
    rf, jr = qt.RingFeature(full, pm), JaxRingFeature(full, jm)
    assert (rf.rows_per, rf.node_count) == (jr.rows_per, jr.node_count)
    ids = rng.integers(0, 100, (n, 24)).astype(np.int32)
    got = rf.lookup(ids).numpy()
    np.testing.assert_array_equal(got, full[ids])
    np.testing.assert_array_equal(got, np.asarray(jr.lookup(ids)))


# -- the data-parallel step -------------------------------------------------
def _dist_batch(n, B=8, sizes=(4, 3), seed=0):
    rng = np.random.default_rng(seed)
    n_nodes, d, classes = 400, 6, 5
    deg = rng.poisson(6, n_nodes)
    src = np.repeat(np.arange(n_nodes), deg)
    dst = rng.integers(0, n_nodes, len(src))
    ei = np.stack([src, dst])
    feat = rng.normal(size=(n_nodes, d)).astype(np.float32)
    labels = rng.integers(0, classes, n_nodes).astype(np.int32)
    jmesh = meshes(n)[1]
    js = JaxDistSampler(JaxTopo(edge_index=ei), jmesh, list(sizes),
                        gather_mode="xla", sample_rng="hash")
    seeds = rng.integers(0, n_nodes, (n, B))
    n_id, _, _, blocks = js.sample(seeds, key=3)
    x = feat[np.asarray(n_id)]
    pblocks = tuple(qt.LayerBlock(
        nbr_local=torch.from_numpy(np.array(b.nbr_local)),
        mask=torch.from_numpy(np.array(b.mask)),
        num_targets=torch.from_numpy(np.array(b.num_targets)))
        for b in blocks)
    return x, blocks, pblocks, labels[seeds], d, classes


@pytest.mark.parametrize("n", [2])
def test_dp_train_step_matches_jax(n):
    """``make_train_step(mesh=)`` against JAX's ``dp_step``: the mean of
    the replicas' mean losses, the summed gradient, one Adam step; three
    steps' losses within LOSS_TOL, a padded label tail included."""
    x, jblocks, pblocks, lab, d, classes = _dist_batch(n)
    B = lab.shape[1]
    mask = np.tile(np.arange(B) < B - 3, (n, 1))
    fm = FlaxSAGE(hidden=8, out_dim=classes, num_layers=2, dropout=0.0)
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]),
                     jax.tree_util.tree_map(lambda l: l[0], jblocks))
    tx = optax.adam(3e-3)
    jstep = jax_train_step(
        lambda p, x, blocks, train=False, rngs=None: fm.apply(
            p, x, blocks, train=train, rngs=rngs), tx, mesh=meshes(n)[1])
    state = JaxState.create(params, tx)
    m = qt.GraphSAGE(d, 8, classes, num_layers=2, dropout=0.0,
                     device="cpu")
    m.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    pstep = qt.make_train_step(m, torch.optim.Adam(m.parameters(), lr=3e-3),
                               mesh=meshes(n)[0])
    for i in range(3):
        state, jloss = jstep(state, jnp.asarray(x), jblocks,
                             jnp.asarray(lab), jnp.asarray(mask),
                             jax.random.PRNGKey(i))
        ploss = pstep(torch.from_numpy(x), pblocks, torch.from_numpy(lab),
                      torch.from_numpy(mask))
        np.testing.assert_allclose(float(ploss), float(jloss), **LOSS_TOL)


def test_shard_batch_and_replicate():
    pm = meshes(2)[0]
    tree = (torch.arange(6).reshape(2, 3), None,
            {"a": np.ones((2, 1), np.float32)})
    parts = qt.parallel.shard_batch(pm, tree)
    assert len(parts) == 2 and parts[1][0].tolist() == [3, 4, 5]
    assert parts[0][1] is None and parts[1][2]["a"].tolist() == [1.0]
    reps = qt.parallel.replicate(pm, torch.ones(3))
    assert len(reps) == 2 and all(torch.equal(r, torch.ones(3))
                                  for r in reps)


def test_dist_training_quick_smoke():
    """``test_dist_e2e_scale.py::test_dist_training_quick_smoke`` on the
    port: finite losses, nothing dropped at exact caps."""
    from quiver_tpu_torch.dist.e2e import run_dist_training

    out = run_dist_training(n_devices=8, n_nodes=2_000, avg_deg=8,
                            feat_dim=8, batch_per_dev=8, sizes=[5, 4],
                            steps=3, seed=1, devices=[CPU] * 8)
    assert len(out["losses"]) == 3
    assert all(np.isfinite(l) for l in out["losses"])
    assert out["sampler_overflow"].sum() == 0
    assert out["feature_overflow"] == 0


def test_dist_training_with_hier_feature():
    """The two-tier store inside the training loop: the loss falls and
    the degree-ordered hot tier keeps most queries off ``dcn``."""
    from quiver_tpu_torch.dist.e2e import run_dist_training

    out = run_dist_training(n_devices=8, n_nodes=3_000, avg_deg=10,
                            feat_dim=8, batch_per_dev=8, sizes=[5, 4],
                            steps=6, seed=3, hier=(2, 0.4),
                            devices=[CPU] * 8)
    losses = out["losses"]
    assert all(np.isfinite(l) for l in losses)
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert out["feature_overflow"] == 0
    total_queries = 8 * 8 * (1 + 5 + 5 * 4) * 6
    assert out["dcn_crossings"] < 0.45 * total_queries
