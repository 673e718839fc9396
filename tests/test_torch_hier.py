"""Port parity: ``quiver_tpu_torch.dist.hier.HierFeature`` (two-tier
``dcn`` x ``ici`` exchange) against the JAX package's
``tests/test_hier.py`` cases and JAX's ``HierFeature`` on the same inputs:
a ``[2, 4]`` mesh exercises both axes (JAX on ``conftest.py``'s 8 virtual
CPU devices, the port on ``[torch.device("cpu")] * 8``).  Rows, crossing
counts and drops must be bitwise JAX's."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from quiver_tpu.dist.hier import HierFeature as JaxHier

from quiver_tpu_torch.dist.hier import HierFeature
from quiver_tpu_torch.utils.mesh import Mesh

N, D = 600, 12
HOT = 200  # rows [0, 200) are the hot tier


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


def meshes(shape=(2, 4)):
    n = shape[0] * shape[1]
    pm = Mesh(np.array([torch.device("cpu")] * n, dtype=object).reshape(
        shape), ("dcn", "ici"))
    jm = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), ("dcn", "ici"))
    return pm, jm


def make_features(rng, shape=(2, 4), hot=HOT, **kw):
    feat = rng.normal(size=(N, D)).astype(np.float32)
    # the cold tail split between the hosts, interleaved
    g2h = (np.arange(N) % shape[0]).astype(np.int32)
    pm, jm = meshes(shape)
    return (feat, g2h,
            HierFeature.from_global_feature(feat, pm, hot_count=hot,
                                            global2host=g2h, **kw),
            JaxHier.from_global_feature(feat, jm, hot_count=hot,
                                        global2host=g2h, **kw))


def assert_same(pf, jf, ids):
    got = pf.lookup(ids).numpy()
    want = np.asarray(jf.lookup(ids))
    np.testing.assert_array_equal(got, want)
    ps, js = pf.traffic_stats(), jf.traffic_stats()
    for k in ("dcn_crossings", "drops"):
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    assert ps["dcn_bytes_est"] == js["dcn_bytes_est"]
    return got, ps


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8), (2, 2), (2, 1)])
def test_lookup_matches_jax_and_ground_truth(shape):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    feat, g2h, pf, jf = make_features(rng, shape)
    assert (pf.hot_count, pf.hot_shard, pf.m_c) == (
        jf.hot_count, jf.hot_shard, jf.m_c)
    ids = rng.integers(0, N, shape + (32,)).astype(np.int32)
    got, st = assert_same(pf, jf, ids)
    assert got.shape == shape + (32, D)
    np.testing.assert_array_equal(got, feat[ids])
    assert st["drops"].sum() == 0  # default caps are exact


def test_default_partition_and_no_hot_tier():
    """Without ``global2host`` the cold tail is range-partitioned; with
    ``hot_count=0`` every row is cold."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(N, D)).astype(np.float32)
    pm, jm = meshes()
    for hot in (0, 130):
        pf = HierFeature.from_global_feature(feat, pm, hot_count=hot)
        jf = JaxHier.from_global_feature(feat, jm, hot_count=hot)
        assert pf.hot_count == jf.hot_count
        ids = rng.integers(0, N, (2, 4, 24)).astype(np.int32)
        got, _ = assert_same(pf, jf, ids)
        np.testing.assert_array_equal(got, feat[ids])


def test_all_hot_never_crosses_dcn():
    rng = np.random.default_rng(4)
    feat, g2h, pf, jf = make_features(rng)
    ids = rng.integers(0, pf.hot_count, (2, 4, 16)).astype(np.int32)
    got, st = assert_same(pf, jf, ids)
    np.testing.assert_array_equal(got, feat[ids])
    assert st["dcn_crossings"].sum() == 0


def test_skewed_workload_beats_flat_mesh():
    """Hot-heavy traffic rides ``ici``; a flat 8-way partition would ship
    most queries across hosts."""
    rng = np.random.default_rng(5)
    feat, g2h, pf, jf = make_features(rng)
    B = 64
    hot_ids = rng.integers(0, pf.hot_count, (2, 4, B))
    cold_ids = rng.integers(pf.hot_count, N, (2, 4, B))
    ids = np.where(rng.random((2, 4, B)) < 0.8, hot_ids,
                   cold_ids).astype(np.int32)
    got, st = assert_same(pf, jf, ids)
    np.testing.assert_array_equal(got, feat[ids])
    hier_cross = int(st["dcn_crossings"].sum())
    flat_owner = (np.arange(N) * 8 // N).astype(np.int32)
    me = np.arange(8).reshape(2, 4)[..., None] * np.ones((1, 1, B), int)
    assert hier_cross < int((flat_owner[ids] != me).sum())
    assert hier_cross <= 0.25 * ids.size
    assert st["dcn_bytes_est"] == hier_cross * D * 4


@pytest.mark.parametrize("caps", [dict(dcn_cap=4), dict(ici_cap=6)])
def test_overflow_counted_not_silent(caps):
    """Capped exchanges drop queries as JAX's do, count them, and answer
    them with zero rows."""
    rng = np.random.default_rng(6)
    feat, g2h, pf, jf = make_features(rng, **caps)
    cold = np.arange(pf.hot_count, N)
    owned1 = cold[g2h[cold] == 1][:32]
    ids = np.tile(owned1[None, None], (2, 4, 1)).astype(np.int32)
    got, st = assert_same(pf, jf, ids)
    assert st["drops"].sum() > 0
    assert (got == 0).all(axis=-1).sum() >= st["drops"].sum()


def test_traffic_stats_before_lookup_and_valid_mask():
    rng = np.random.default_rng(7)
    feat, g2h, pf, jf = make_features(rng)
    assert pf.traffic_stats() is None
    ids = rng.integers(0, N, (2, 4, 8)).astype(np.int32)
    valid = rng.random((2, 4, 8)) < 0.5
    got = pf.lookup(ids, valid).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.lookup(ids, valid)))
    assert (got[~valid] == 0).all()
    np.testing.assert_array_equal(got[valid], feat[ids][valid])
    with pytest.raises(ValueError):
        pf.lookup(ids[:1])
