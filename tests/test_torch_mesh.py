"""Port parity: ``quiver_tpu_torch.mesh`` (topology, ``MeshFeature``,
``MeshSampler``, ``/debug/mesh``) and ``utils/mesh`` against the JAX
package's ``tests/test_mesh.py`` cases and the JAX objects on the same
inputs.

The JAX side runs on ``conftest.py``'s 8 virtual CPU devices; the port's
meshes repeat ``torch.device("cpu")``.  Gathered rows and sampled
``nbrs``/``mask``/``counts``/``eid`` must be bitwise equal to JAX's and to
the single-device path, at 1, 2, 4 and 8 shards.  JAX's samplers run
``gather_mode="xla", sample_rng="hash"``; the port's words are
``_fold_key_words`` of JAX's key.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.mesh import MeshFeature as JaxMeshFeature
from quiver_tpu.mesh import MeshSampler as JaxMeshSampler
from quiver_tpu.mesh import build_mesh as jax_build_mesh
from quiver_tpu.mesh import shard_ranges as jax_shard_ranges
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.resilience import qos as jqos
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.telemetry import metric_key

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.mesh import (DATA_AXIS, SHARD_AXIS, MeshFeature,
                                   MeshSampler, build_mesh,
                                   match_partition_rules, mesh_status,
                                   replicated, require_devices, row_shard,
                                   shard_ranges)
from quiver_tpu_torch.ops.sample import sample_neighbors_overlay
from quiver_tpu_torch.recovery.registry import get_program_registry
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.telemetry import flightrec as pflightrec
from quiver_tpu_torch.utils.mesh import Mesh, MeshTopo, init_p2p

N, D = 1000, 16
CPU = torch.device("cpu")
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
        rec.reset()
        qos.reset()
        tel.reset()
    get_program_registry().unseal()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def counter(tel, name, **labels):
    return tel.snapshot()["counters"].get(metric_key(name, labels), 0)


def gauge(tel, name, **labels):
    return tel.snapshot()["gauges"].get(metric_key(name, labels))


def pmesh(n):
    return build_mesh(n, devices=[CPU] * n)


def words(key):
    return [int(np.asarray(w)) for w in _fold_key_words(key)]


@pytest.fixture
def table():
    return np.random.default_rng(0).standard_normal((N, D)).astype(
        np.float32)


def _csr(rng, n=N, avg_deg=8):
    deg = rng.integers(1, avg_deg * 2, n)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int32)
    return indptr, indices


# ------------------------------------------------------------ topology
class TestTopology:
    def test_shard_ranges_cover_exactly(self):
        rps, ranges = shard_ranges(10, 4)
        assert (rps, ranges) == jax_shard_ranges(10, 4)
        assert ranges == [(0, 3), (3, 6), (6, 9), (9, 10)]
        for n_rows, n in ((1000, 8), (7, 3), (1, 1)):
            assert shard_ranges(n_rows, n) == jax_shard_ranges(n_rows, n)
        with pytest.raises(ValueError):
            shard_ranges(0, 2)

    def test_require_devices_names_the_way_out(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match=r"torch.device\('cpu'\)"):
            require_devices(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_mesh(2)  # the default devices are the cards

    def test_build_mesh_axes(self):
        mesh = pmesh(4)
        assert mesh.axis_names == (DATA_AXIS, SHARD_AXIS)
        assert mesh.shape[SHARD_AXIS] == 4
        assert mesh.shape[DATA_AXIS] == 1
        jmesh = jax_build_mesh(4)
        assert dict(mesh.shape) == dict(jmesh.shape)
        assert row_shard(mesh) == [CPU] * 4
        assert replicated(mesh) == [CPU] * 4
        two = build_mesh(2, data=2, devices=[CPU] * 4)
        assert dict(two.shape) == {DATA_AXIS: 2, SHARD_AXIS: 2}
        with pytest.raises(ValueError):
            build_mesh(0, devices=[CPU])

    def test_match_partition_rules(self):
        tree = {"layers_0": {"kernel": np.zeros((2, 2)),
                             "bias": np.zeros(2)}}
        specs = match_partition_rules(
            [("kernel", SHARD_AXIS), ("bias", None)], tree)
        assert specs == {"layers_0": {"kernel": SHARD_AXIS, "bias": None}}
        with pytest.raises(ValueError, match="no partition rule"):
            match_partition_rules([("kernel", None)], tree)

    def test_mesh_off_by_default(self):
        from quiver_tpu_torch.config import get_config

        assert get_config().mesh_shards == 0
        with pytest.raises(ValueError, match="mesh_shards"):
            MeshFeature(np.zeros((4, 2), np.float32))
        with pytest.raises(ValueError, match="mesh_shards"):
            MeshSampler(np.array([0, 1]), np.array([0]))

    def test_mesh_knobs_have_jax_names(self, monkeypatch):
        from quiver_tpu.config import Config as JaxConfig
        from quiver_tpu_torch.config import Config

        for name, env, val in (("mesh_shards", "MESH_SHARDS", "4"),
                               ("mesh_group", "MESH_GROUP", "g7"),
                               ("mesh_shard_index", "MESH_SHARD_INDEX", "2"),
                               ("mesh_pool_pages", "MESH_POOL_PAGES", "9")):
            assert getattr(Config(), name) == getattr(JaxConfig(), name)
            monkeypatch.setenv("QUIVER_TPU_" + env, val)
            assert getattr(Config(), name) == getattr(JaxConfig(), name)

    def test_mesh_and_make_mesh(self):
        from quiver_tpu.utils.mesh import make_mesh as jax_make_mesh

        m = qt.make_mesh(("a", "b"), shape=(2, 4), devices=[CPU] * 8)
        jm = jax_make_mesh(("a", "b"), shape=(2, 4))
        assert dict(m.shape) == dict(jm.shape)
        assert m.devices.shape == jm.devices.shape == (2, 4)
        assert m.axis_devices("b") == [CPU] * 4 and m.size == 8
        assert dict(qt.make_mesh(devices=[CPU] * 3).shape) == {"data": 3}
        with pytest.raises(ValueError, match="axis 'c'"):
            m.axis_devices("c")

    def test_mesh_topo_cliques(self, monkeypatch):
        t = MeshTopo([CPU] * 4)
        assert t.p2p_clique() == {0: [CPU]}
        assert t.get_clique_id("cpu") == 0
        assert "Clique 0" in t.info
        assert init_p2p([CPU]).p2p_clique_device_list == [[CPU]]
        # cards: cliques from the peer-access matrix (0-1 and 2-3 pairs)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                            lambda a, b: a // 2 == b // 2)
        cards = [torch.device("cuda", i) for i in range(4)]
        t = MeshTopo(cards + cards[:1])
        assert t.p2p_clique_device_list == [cards[:2], cards[2:]]
        assert t.get_clique_id(cards[3]) == 1
        with pytest.raises(KeyError):
            MeshTopo(cards[:1]).get_clique_id(cards[2])

    def test_hybrid_mesh_degenerate(self):
        from quiver_tpu.dist import make_hybrid_mesh as jax_hybrid

        m = qt.make_hybrid_mesh(devices=[CPU] * 8)
        jm = jax_hybrid()
        assert m.axis_names == jm.axis_names == ("dcn", "ici")
        assert dict(m.shape) == dict(jm.shape) == {"dcn": 1, "ici": 8}


# ------------------------------------------------- sharded feature store
class TestMeshFeature:
    @pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
    def test_gather_bit_identical_to_jax_and_staged(self, table, n_shards):
        """The acceptance pin: the sharded gather equals the JAX mesh
        gather, the single-device feature and the table, bitwise."""
        rng = np.random.default_rng(n_shards)
        staged = qt.Feature(device_cache_size=N, cache_unit="rows",
                            device="cpu").from_cpu_tensor(table)
        mf = MeshFeature(table, n_shards=n_shards, mesh=pmesh(n_shards))
        jf = JaxMeshFeature(table, n_shards=n_shards)
        for B in (1, 7, 64, 200):
            ids = rng.integers(0, N, B)
            got = mf[ids].numpy()
            assert got.dtype == table.dtype
            np.testing.assert_array_equal(got, np.asarray(jf[ids]))
            np.testing.assert_array_equal(got, staged[ids].numpy())
            np.testing.assert_array_equal(got, table[ids])
        assert mf.stats()["restacks"] == jf.stats()["restacks"]
        assert [s["resident_pages"] for s in mf.stats()["shards"]] == \
            [s["resident_pages"] for s in jf.stats()["shards"]]

    def test_gather_int_and_bf16_sentinels(self):
        """Integer tables combine under iinfo.min, bf16 under its own
        -inf: exact; -0.0 survives the max."""
        rng = np.random.default_rng(3)
        t = rng.integers(-2**30, 2**30, (N, 4)).astype(np.int32)
        mf = MeshFeature(t, n_shards=4, mesh=pmesh(4))
        ids = rng.integers(0, N, 50)
        np.testing.assert_array_equal(mf[ids].numpy(), t[ids])
        np.testing.assert_array_equal(mf[ids].numpy(),
                                      np.asarray(JaxMeshFeature(t, 4)[ids]))
        b = torch.from_numpy(rng.standard_normal((N, 8)).astype(
            np.float32)).to(torch.bfloat16)
        b[5] = -0.0
        bf = MeshFeature(b, n_shards=3, mesh=pmesh(3))
        got = bf[np.r_[ids, 5]]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16),
                           b[torch.from_numpy(np.r_[ids, 5])].view(
                               torch.int16))

    def test_steady_state_zero_restacks_zero_builds(self, table):
        rng = np.random.default_rng(4)
        mf = MeshFeature(table, n_shards=4, mesh=pmesh(4))
        streams = [rng.integers(0, N, 64) for _ in range(4)]
        for ids in streams:          # warm epoch: faults and keys happen
            mf[ids]
        restacks = mf.restacks
        execs = mf.stats()["executables"]
        for ids in streams * 2:      # steady state: the same ladder again
            np.testing.assert_array_equal(mf[ids].numpy(), table[ids])
        assert mf.restacks == restacks
        assert mf.stats()["executables"] == execs

    def test_overflow_falls_back_exact(self, table):
        """A pool too small for the batch answers from the host table and
        ticks the fallback counter, as JAX's does for the same batch."""
        rng = np.random.default_rng(5)
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2), page_rows=8,
                         pool_pages=1)
        jf = JaxMeshFeature(table, n_shards=2, page_rows=8, pool_pages=1)
        ids = rng.integers(0, N, 128)
        np.testing.assert_array_equal(mf[ids].numpy(), table[ids])
        np.testing.assert_array_equal(np.asarray(jf[ids]), table[ids])
        assert counter(ptel, "feature_page_fallback_total") == \
            counter(jtel, "feature_page_fallback_total") >= 1
        assert mf.fallbacks == jf.fallbacks >= 1
        assert [s["fallbacks"] for s in mf.stats()["shards"]] == \
            [s["fallbacks"] for s in jf.stats()["shards"]]

    def test_small_pool_faults_and_evicts_as_jax(self, table):
        """A pool of a few pages a shard: batches that fit fault, evict
        and hit; the page counters and residency equal JAX's."""
        rng = np.random.default_rng(6)
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2), page_rows=16,
                         pool_pages=6)
        jf = JaxMeshFeature(table, n_shards=2, page_rows=16, pool_pages=6)
        for _ in range(6):
            base = rng.integers(0, N - 40)
            ids = base + rng.integers(0, 40, 24)
            np.testing.assert_array_equal(mf[ids].numpy(), table[ids])
            np.asarray(jf[ids])
        for name in ("feature_page_faults_total", "feature_page_hits_total",
                     "feature_page_evictions_total",
                     "feature_page_fallback_total"):
            assert counter(ptel, name) == counter(jtel, name), name
        assert mf.restacks == jf.restacks

    def test_warm_executables_idempotent(self, table):
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2))
        jf = JaxMeshFeature(table, n_shards=2)
        built = mf.warm_executables()
        assert built == jf.warm_executables() > 0
        assert mf.warm_executables() == 0
        mf[np.arange(64)]  # a warmed bucket records nothing new
        assert mf.stats()["executables"] == built

    def test_halo_counters_move(self, table):
        rng = np.random.default_rng(7)
        mf = MeshFeature(table, n_shards=4, mesh=pmesh(4))
        ids = rng.integers(0, N, 32)
        mf[ids]
        JaxMeshFeature(table, n_shards=4)[ids]
        for d in ("send", "recv"):
            assert counter(ptel, "mesh_halo_bytes_total", direction=d) == \
                counter(jtel, "mesh_halo_bytes_total", direction=d) == \
                32 * D * 4 * 3


# ------------------------------------------------- frontier exchange
class TestMeshSampler:
    @pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
    def test_sample_bit_identical(self, n_shards):
        """The sharded hop equals JAX's mesh hop and the single-device
        overlay hop under the same key, field by field."""
        rng = np.random.default_rng(10 + n_shards)
        indptr, indices = _csr(rng)
        ms = MeshSampler(indptr, indices, n_shards=n_shards,
                         mesh=pmesh(n_shards))
        js = JaxMeshSampler(indptr, indices, n_shards=n_shards,
                            sample_rng="hash")
        for trial in range(2):
            seeds = rng.integers(0, N, 32)
            key = jax.random.PRNGKey(trial)
            got = ms.sample(seeds, 8, words(key))
            want = js.sample(seeds, 8, key)
            ref = sample_neighbors_overlay(
                torch.from_numpy(indptr), torch.from_numpy(indices),
                torch.zeros(len(indices), dtype=torch.int32),
                torch.zeros(N + 1, dtype=torch.int32),
                torch.zeros(8, dtype=torch.int32),
                torch.from_numpy(seeds), 8, *words(key))
            for f in ("nbrs", "mask", "counts", "eid"):
                g = getattr(got, f).numpy()
                np.testing.assert_array_equal(
                    g, np.asarray(getattr(want, f)), err_msg=f)
                np.testing.assert_array_equal(
                    g, getattr(ref, f).numpy(), err_msg=f)

    def test_pallas_mode_and_device_seeds(self):
        """``gather_mode="pallas"`` (B3's plain version here) draws what
        ``"xla"`` draws, from host or tensor seeds."""
        rng = np.random.default_rng(20)
        indptr, indices = _csr(rng)
        xla = MeshSampler(indptr, indices, n_shards=4, mesh=pmesh(4))
        b3 = MeshSampler(indptr, indices, n_shards=4, mesh=pmesh(4),
                         gather_mode="pallas")
        seeds = rng.integers(0, N, 48)
        a = xla.sample(seeds, 6, (11, 22))
        b = b3.sample(torch.from_numpy(seeds), 6, (11, 22))
        for f in ("nbrs", "mask", "counts", "eid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f

    def test_frontier_gauge_tracks_ownership(self):
        rng = np.random.default_rng(21)
        indptr, indices = _csr(rng)
        ms = MeshSampler(indptr, indices, n_shards=4, mesh=pmesh(4))
        js = JaxMeshSampler(indptr, indices, n_shards=4, sample_rng="hash")
        seeds = np.arange(ms.rows_per_shard // 2)  # all owned by shard 0
        ms.sample(seeds, 4, words(jax.random.PRNGKey(0)))
        js.sample(seeds, 4, jax.random.PRNGKey(0))
        for s in range(4):
            assert gauge(ptel, "mesh_shard_frontier_rows", shard=str(s)) \
                == gauge(jtel, "mesh_shard_frontier_rows", shard=str(s))
        assert gauge(ptel, "mesh_shard_frontier_rows", shard="0") == \
            len(seeds)
        ms.sample(torch.from_numpy(seeds), 4, (1, 2))
        assert gauge(ptel, "mesh_shard_frontier_rows", shard="1") == 0

    def test_sample_then_gather_pipeline_bit_identical(self, table):
        """The full sharded hop: frontier sample, then the neighbours'
        rows, bitwise the unsharded pipeline's and JAX's."""
        rng = np.random.default_rng(22)
        indptr, indices = _csr(rng)
        ms = MeshSampler(indptr, indices, n_shards=4, mesh=pmesh(4))
        mf = MeshFeature(table, n_shards=4, mesh=pmesh(4))
        seeds = rng.integers(0, N, 16)
        key = jax.random.PRNGKey(11)
        out = ms.sample(seeds, 8, words(key))
        flat = torch.where(out.mask, out.nbrs,
                           torch.zeros_like(out.nbrs)).reshape(-1)
        got = mf[flat]
        jout = JaxMeshSampler(indptr, indices, n_shards=4,
                              sample_rng="hash").sample(seeds, 8, key)
        jflat = np.where(np.asarray(jout.mask), np.asarray(jout.nbrs),
                         0).reshape(-1)
        np.testing.assert_array_equal(flat.numpy(), jflat)
        np.testing.assert_array_equal(got.numpy(), table[jflat])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JaxMeshFeature(table, 4)[jflat]))

    def test_steady_state_sampler_builds_nothing(self):
        rng = np.random.default_rng(23)
        indptr, indices = _csr(rng)
        ms = MeshSampler(indptr, indices, n_shards=4, mesh=pmesh(4))
        ms.sample(rng.integers(0, N, 32), 8, (0, 1))  # warm (B=32, k=8)
        execs = ms.stats()["executables"]
        for trial in range(4):
            ms.sample(rng.integers(0, N, 32), 8, (trial, 7))
        assert ms.stats()["executables"] == execs == 1


# --------------------------------------------------------- observability
class TestMeshObservability:
    def test_mesh_status_active_document(self, table):
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2))
        doc = mesh_status()
        assert doc["active"] is True
        assert doc["n_shards"] == 2
        assert doc["feature"]["rows_per_shard"] == mf.rows_per_shard
        assert set(doc["feature"]) == set(
            JaxMeshFeature(table, 2).stats())

    def test_debug_mesh_endpoint(self, table):
        from quiver_tpu_torch.telemetry.export import MetricsServer

        # a strong reference: the /debug/mesh registry is a weakref
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2))
        srv = MetricsServer()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/debug/mesh",
                    timeout=10) as resp:
                doc = json.loads(resp.read())
            assert doc["active"] is True
            assert doc["n_shards"] == 2
            assert doc["feature"]["rows_per_shard"] == mf.rows_per_shard
        finally:
            srv.close()

    def test_gather_seconds_histogram_observes(self, table):
        mf = MeshFeature(table, n_shards=2, mesh=pmesh(2))
        mf[np.random.default_rng(8).integers(0, N, 16)]
        hists = ptel.snapshot()["histograms"]
        key = metric_key("mesh_shard_gather_seconds", {})
        assert sum(hists[key]["counts"]) >= 1

    def test_mesh_on_the_card_needs_one(self, monkeypatch):
        """A mesh over cards raises where there is none: no fallback."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            Mesh([torch.device("cuda", 0)] * 2, ("shard",))
        with pytest.raises(RuntimeError, match="CUDA"):
            qt.make_mesh(("shard",))
