"""Port parity, the budgeted feature store: config knobs, the cold-row
overlay's slot bookkeeping (``ColdRowCache``) and ``Feature`` under a
budget smaller than the table (staged merge and overlay), against the JAX
package on the same numpy inputs.

Gathered rows must be bitwise equal to the source and to JAX's
``Feature.__getitem__``; cache states and counters must be equal after
every batch.  The one counter that differs by design is
``feature_h2d_bytes_total``: the port ships only real rows, where JAX pads
each copy to a shape bucket.  The paged store is in test_torch_paged.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu.config as jax_config
from quiver_tpu import telemetry
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.ops.coldcache import ColdRowCache as JaxCache
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config
from quiver_tpu_torch.ops.coldcache import ColdRowCache
from quiver_tpu_torch.utils.staging import HostStaging

N, D, HOT = 512, 16, 128
KNOBS = ("cold_cache_size", "cold_cache_policy", "cold_cache_admit",
         "feature_paged", "feature_page_rows", "feature_page_pool")
COUNTED = ("feature_rows_total", "feature_coldcache_", "feature_page_",
           "feature_gather_batches_total", "coldcache_invalidated")


# the JAX package's telemetry switch as the process starts (collection
# runs before any test can change it)
_JAX_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _jax_telemetry_on():
    """The JAX counters compared here need the JAX package's telemetry on;
    a test file run earlier in the same worker may have left it off.
    After each test the JAX registry is emptied and the switch set back to
    its default, so nothing these tests record or switch reaches a later
    file."""
    telemetry.set_enabled(True)
    yield
    telemetry.reset()
    telemetry.set_enabled(_JAX_TELEMETRY_DEFAULT)


def jax_counts() -> dict:
    """The JAX registry's feature counters, without zeros and bytes."""
    snap = telemetry.snapshot()["counters"]
    return {k: float(v) for k, v in snap.items()
            if k.startswith(COUNTED) and v}


def port_counts(f) -> dict:
    return {k: float(v) for k, v in f.stats()["counters"].items()
            if k.startswith(COUNTED) and v}


def cache_state(c) -> dict:
    return dict(slot_of=np.asarray(c.slot_of), node_of=np.asarray(c.node_of),
                freq=np.asarray(c.freq), ref=np.asarray(c.ref),
                touches=np.asarray(c.touches), hand=c.hand,
                next_free=c.next_free, hits=c.hits, misses=c.misses,
                evictions=c.evictions)


def assert_same_cache(j, p):
    js, ps = cache_state(j), cache_state(p)
    for k in js:
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


def as_f32(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.float().numpy()
    return np.asarray(rows).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, 6000, seed=2)
    feats = np.random.default_rng(1).standard_normal((N, D)).astype(
        np.float32)
    return indptr, indices, feats


def _pair(data, hot, order="degree", dtype=None, **kw):
    """The JAX and the port feature over the same table, budget and
    order (each with a topology object of its own)."""
    indptr, indices, feats = data
    prob = np.random.default_rng(3).random(N) if order == "prob" else None
    jt = JaxTopo(indptr=indptr, indices=indices) if order == "degree" \
        else None
    pt = qt.CSRTopo(indptr=indptr, indices=indices) if order == "degree" \
        else None
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    jf = JaxFeature(device_cache_size=hot, cache_unit="rows", csr_topo=jt,
                    dtype=jdt, **kw).from_cpu_tensor(feats, prob=prob)
    pf = qt.Feature(device_cache_size=hot, cache_unit="rows", csr_topo=pt,
                    dtype=dtype, device="cpu", **kw).from_cpu_tensor(
                        feats, prob=prob)
    return jf, pf


def _stream(seed, n_batches=12, hi=N):
    """Batches of 1..150 ids with duplicates and a recurring subset."""
    rng = np.random.default_rng(seed)
    recurring = rng.integers(0, hi, 40)
    out = []
    for i in range(n_batches):
        ids = rng.integers(0, hi, int(rng.integers(1, 150)))
        if i % 3 == 0:
            ids[: len(ids) // 2 + 1] = ids[0]
        if i % 2:
            ids = np.concatenate([ids, recurring[: int(rng.integers(5, 40))]])
        out.append(ids.astype(np.int64))
    return out


# -- config ----------------------------------------------------------------

def test_config_defaults_and_env_names_match(monkeypatch):
    want = jax_config.Config()
    got = config.Config()
    for k in KNOBS:
        assert getattr(got, k) == getattr(want, k), k
    env = dict(COLD_CACHE_SIZE="64M", COLD_CACHE_POLICY="minfreq",
               COLD_CACHE_ADMIT="3", FEATURE_PAGED="on",
               FEATURE_PAGE_ROWS="16", FEATURE_PAGE_POOL="40")
    for k, v in env.items():
        monkeypatch.setenv(f"QUIVER_TPU_{k}", v)
    want, got = jax_config.Config(), config.Config()
    for k in KNOBS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.feature_page_pool == 40 and got.cold_cache_admit == 3


def test_config_override_does_not_leak():
    before = config.get_config()
    with config.override(feature_paged="on", feature_page_pool=9) as cfg:
        assert config.get_config() is cfg
        assert cfg.feature_paged == "on" and cfg.feature_page_pool == 9
    assert config.get_config() is before
    with pytest.raises(KeyError):
        with config.override(cold_cache_size="1K"):
            raise KeyError("inside")
    assert config.get_config() is before
    assert before.feature_paged == "off"


# -- ColdRowCache ----------------------------------------------------------

@pytest.mark.parametrize("policy", ["clock", "minfreq"])
@pytest.mark.parametrize("protect", [False, True])
def test_cold_row_cache_matches_jax(policy, protect):
    """The same probe/admit/invalidate stream through both copies leaves
    equal slot maps, frequencies, ref bits, touches and counts after every
    batch."""
    rng = np.random.default_rng(7)
    j, p = JaxCache(32, 300, policy=policy), ColdRowCache(32, 300, policy)
    for step in range(40):
        ids = (rng.zipf(1.4, int(rng.integers(1, 60))) - 1) % 300
        jh, js = j.probe(ids)
        ph, ps = p.probe(ids)
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_array_equal(ps, js)
        prot = js[jh][:6] if protect and step % 2 else None
        ja, jn = j.admit(ids[~jh], protect_slots=prot)
        pa, pn = p.admit(ids[~ph], protect_slots=prot)
        np.testing.assert_array_equal(pa, ja)
        assert pn == jn
        if step % 10 == 9:
            bad = rng.integers(-5, 310, 9)
            assert p.invalidate_rows(bad) == j.invalidate_rows(bad)
        assert_same_cache(j, p)
    assert p.stats() == j.stats()
    assert p.evictions > 0 and p.hits > 0


def test_cold_row_cache_rejects_bad_geometry():
    for args, msg in (((0, 10), "capacity"), ((4, 10, "lru"), "policy")):
        with pytest.raises(ValueError, match=msg):
            ColdRowCache(*args)
    with pytest.raises(ValueError, match="admit_threshold"):
        ColdRowCache(4, 10, admit_threshold=0)


# -- budgeted Feature: staged merge ------------------------------------------

@pytest.mark.parametrize("hot", [HOT, 0, N], ids=["partial", "zero", "full"])
@pytest.mark.parametrize("order", ["degree", "prob"])
def test_budgeted_rows_match_jax(data, hot, order):
    telemetry.reset()
    jf, pf = _pair(data, hot, order)
    feats = data[2]
    assert pf.cache_count == jf.cache_count == hot
    np.testing.assert_array_equal(pf.feature_order, jf.feature_order)
    if hot < N:
        np.testing.assert_array_equal(pf.cold.numpy(), jf.cold)
    for ids in _stream(hot + len(order)):
        got = pf[ids]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf[ids]))
        np.testing.assert_array_equal(got.numpy(), feats[ids])
    assert port_counts(pf) == jax_counts()


def test_budgeted_bf16_rows_match_jax(data):
    telemetry.reset()
    jf, pf = _pair(data, HOT, dtype=torch.bfloat16)
    src = torch.from_numpy(data[2]).to(torch.bfloat16)
    for ids in _stream(5, n_batches=6):
        got = pf[ids]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(as_f32(got), as_f32(jf[ids]))
        assert torch.equal(got, src[ids])
    assert port_counts(pf) == jax_counts()


def test_budgeted_shapes_and_device_ids(data):
    """2-D host ids keep their shape; a tensor of ids is read back once and
    takes the same path; out-of-range ids raise."""
    _, pf = _pair(data, HOT)
    feats = data[2]
    ids = np.random.default_rng(0).integers(0, N, (7, 5))
    np.testing.assert_array_equal(pf[ids].numpy(), feats[ids])
    t = torch.from_numpy(ids.reshape(-1).astype(np.int32))
    np.testing.assert_array_equal(pf[t].numpy(), feats[ids.reshape(-1)])
    assert pf[np.zeros(0, np.int64)].shape == (0, D)
    with pytest.raises(ValueError, match="node ids"):
        pf[np.array([0, N])]
    with pytest.raises(RuntimeError, match="whole table"):
        pf.lookup_device(t)


# -- budgeted Feature: the overlay -------------------------------------------

@pytest.mark.parametrize("hot", [HOT, 0], ids=["partial", "zero"])
@pytest.mark.parametrize("policy", ["clock", "minfreq"])
def test_overlay_state_matches_jax_every_batch(data, hot, policy):
    telemetry.reset()
    jf, pf = _pair(data, hot, cold_cache_policy=policy)
    feats = data[2]
    for f in (jf, pf):
        f.enable_cold_cache(rows=48, admit_threshold=2)
    for i, ids in enumerate(_stream(11 + hot, n_batches=16)):
        got = pf[ids]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf[ids]))
        np.testing.assert_array_equal(got.numpy(), feats[ids])
        assert_same_cache(jf.cold_cache, pf.cold_cache)
        np.testing.assert_array_equal(pf._overlay.numpy()[
            pf.cold_cache.node_of >= 0], np.asarray(jf._overlay)[
                jf.cold_cache.node_of >= 0])
        if i == 8:
            mutated = ids[:10]
            assert pf.invalidate_rows(mutated) == jf.invalidate_rows(mutated)
            assert_same_cache(jf.cold_cache, pf.cold_cache)
    stats = pf.stats()["cold_cache"]
    assert stats["hits"] > 0 and stats["evictions"] > 0
    assert port_counts(pf) == jax_counts()


def test_overlay_default_size_matches_jax(data):
    for hot in (HOT, 500, 0):
        jf, pf = _pair(data, hot)
        jf.enable_cold_cache()
        pf.enable_cold_cache()
        assert pf.cold_cache.capacity == jf.cold_cache.capacity
        assert pf._overlay.shape == (pf.cold_cache.capacity, D)
    jf, pf = _pair(data, N)
    assert jf.enable_cold_cache().cold_cache is None
    assert pf.enable_cold_cache().cold_cache is None


def test_config_size_enables_overlay_at_build(data):
    saved = jax_config.get_config().cold_cache_size
    jax_config.update(cold_cache_size="40")
    try:
        with config.override(cold_cache_size="40"):
            jf, pf = _pair(data, HOT)
    finally:
        jax_config.update(cold_cache_size=saved)
    assert pf.cold_cache.capacity == jf.cold_cache.capacity == 40
    _, pf = _pair(data, HOT)
    assert pf.cold_cache is None


def test_staged_batch_keeps_its_rows_after_eviction(data):
    """Stage A with overlay hits, then stage B so that its admissions evict
    A's slots and rewrite the overlay table in place: A's staged rows are
    still A's."""
    feats = data[2]
    _, pf = _pair(data, HOT)
    pf.enable_cold_cache(rows=16, admit_threshold=1)
    cold = np.nonzero(pf.feature_order >= HOT)[0]
    a_ids, b_ids = cold[:16], cold[16:32]
    pf[a_ids]  # admit A
    assert pf.cold_cache.resident == 16
    with pf._plock:
        a = pf._stage(pf.feature_order[a_ids])
        b = pf._stage(pf.feature_order[b_ids])
    assert (pf.cold_cache.slot_of[pf.feature_order[a_ids] - HOT] < 0).all()
    np.testing.assert_array_equal(a.numpy(), feats[a_ids])
    np.testing.assert_array_equal(b.numpy(), feats[b_ids])


def test_host_staging_returns_detached_copies():
    """On the CPU a shipped buffer is cloned: refilling the staging buffer
    for the next batch leaves the earlier result unchanged."""
    st = HostStaging(torch.device("cpu"))
    buf = st.buffer("rows", (3, 2), torch.float32)
    buf.copy_(torch.ones(3, 2))
    first = st.send("rows", buf)
    again = st.buffer("rows", (2, 2), torch.float32)
    assert again.data_ptr() == buf.data_ptr()  # the buffer is reused
    again.fill_(7.0)
    assert torch.equal(first, torch.ones(3, 2))
    bigger = st.buffer("rows", (10, 2), torch.bfloat16)
    assert bigger.shape == (10, 2) and bigger.dtype == torch.bfloat16


# -- Feature.from_mmap, DeviceConfig, set_local_order, dim_ (A4) -----------
def _mmap_table(tmp_path, rng):
    table = rng.standard_normal((N, D)).astype(np.float32)
    path = str(tmp_path / "feat.npy")
    np.save(path, table)
    return table, path


@pytest.mark.parametrize("budget", [0, HOT * D * 4, N * D * 4])
def test_from_mmap_matches_jax(tmp_path, budget):
    """A ``.npy`` path opened as a memory map, at no, a partial and the
    whole budget: the split, the rows (bitwise the source and JAX's) and
    the cold tier read in place from the file."""
    rng = np.random.default_rng(21)
    table, path = _mmap_table(tmp_path, rng)
    jf = JaxFeature.from_mmap(path, device_cache_size=budget)
    pf = qt.Feature.from_mmap(path, device_cache_size=budget, device="cpu")
    assert (pf.cache_count, pf.node_count, pf.dim) == (
        jf.cache_count, jf.node_count, jf.dim)
    assert pf.dim_() == jf.dim_() == D
    for _ in range(3):
        ids = rng.integers(0, N, 97)
        got = as_f32(pf[ids])
        np.testing.assert_array_equal(got, table[ids])
        np.testing.assert_array_equal(got, as_f32(jf[ids]))
    if pf.cache_count < N:
        # the cold tier reads the file in place: a row written to the file
        # after the build is what both stores serve
        assert isinstance(jf.cold, np.memmap)
        w = np.load(path, mmap_mode="r+")
        w[N - 1] = 7.0
        w.flush()
        np.testing.assert_array_equal(as_f32(pf[[N - 1]]), 7.0)
        np.testing.assert_array_equal(as_f32(jf[[N - 1]]), 7.0)


def test_from_mmap_device_config_and_array(tmp_path):
    """``DeviceConfig``'s shards are the hot prefix and the mapped file the
    cold tail, as in JAX; an array (not a path) works the same way."""
    rng = np.random.default_rng(22)
    table = rng.standard_normal((N, D)).astype(np.float32)
    paths = []
    for i, (lo, hi) in enumerate([(0, 64), (64, HOT)]):
        paths.append(str(tmp_path / f"dev{i}.npy"))
        np.save(paths[-1], table[lo:hi])
    np.save(str(tmp_path / "cold.npy"), table[HOT:])
    cfg = qt.DeviceConfig(device_ids=[0, 1], device_paths=paths,
                          host_path=str(tmp_path / "cold.npy"))
    jcfg = __import__("quiver_tpu").DeviceConfig(
        device_ids=[0, 1], device_paths=paths, host_path=cfg.host_path)
    pf = qt.Feature.from_mmap(cfg.host_path, cfg, device="cpu")
    jf = JaxFeature.from_mmap(cfg.host_path, jcfg)
    assert (pf.cache_count, pf.node_count) == (jf.cache_count,
                                               jf.node_count) == (HOT, N)
    ids = rng.integers(0, N, 200)
    np.testing.assert_array_equal(as_f32(pf[ids]), table[ids])
    np.testing.assert_array_equal(as_f32(pf[ids]), as_f32(jf[ids]))
    af = qt.Feature.from_mmap(table, device_cache_size=HOT,
                              cache_unit="rows", device="cpu")
    assert af.cache_count == HOT
    np.testing.assert_array_equal(as_f32(af[ids]), table[ids])


def test_from_mmap_paged_and_overlay(tmp_path):
    """The budgeted paths over a mapped cold tier: pages fault from the
    file (B5's plain version), the overlay admits from it; rows equal the
    source and JAX's."""
    rng = np.random.default_rng(23)
    table, path = _mmap_table(tmp_path, rng)
    pf = qt.Feature.from_mmap(path, device_cache_size=HOT * D * 4,
                              device="cpu").enable_paging()
    jf = JaxFeature.from_mmap(path, device_cache_size=HOT * D * 4)
    jf.enable_paging()
    assert pf.paged is not None
    for _ in range(3):
        ids = rng.integers(0, N, 64)
        np.testing.assert_array_equal(as_f32(pf[ids]), table[ids])
        np.testing.assert_array_equal(as_f32(pf[ids]), as_f32(jf[ids]))
    of = qt.Feature.from_mmap(path, device_cache_size=HOT * D * 4,
                              device="cpu").enable_cold_cache(rows=64)
    for _ in range(3):
        ids = rng.integers(0, N, 64)
        np.testing.assert_array_equal(as_f32(of[ids]), table[ids])
    assert of.stats()["cold_cache"]["resident"] > 0


def test_set_local_order_matches_jax():
    """An external cache order: ``feature_order`` equals JAX's and rows
    follow it, on the host path and on the device-id path."""
    rng = np.random.default_rng(24)
    table = rng.standard_normal((N, D)).astype(np.float32)
    order = rng.permutation(N)
    pf = qt.Feature(device_cache_size=N, cache_unit="rows",
                    device="cpu").from_cpu_tensor(table[order])
    jf = JaxFeature(device_cache_size=N, cache_unit="rows").from_cpu_tensor(
        table[order])
    pf.set_local_order(order)
    jf.set_local_order(order)
    np.testing.assert_array_equal(pf.feature_order, jf.feature_order)
    ids = rng.integers(0, N, 100)
    np.testing.assert_array_equal(as_f32(pf[ids]), table[ids])
    np.testing.assert_array_equal(as_f32(pf[ids]), as_f32(jf[ids]))
    np.testing.assert_array_equal(
        pf.lookup_device(torch.from_numpy(ids)).numpy(), table[ids])
    assert pf.dim_() == jf.dim_() == D


# -- cache_policy="ici_shard" (A13a) ---------------------------------------
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("budget", ["all", "part"])
def test_ici_shard_matches_jax(n_shards, budget):
    """The hot prefix row-sharded over a mesh (B2 per shard, the max
    combine): the budget is per device, as in JAX, the rows bitwise JAX's
    and the source's on the host path, the device-id path and with a
    degree order."""
    import jax
    from quiver_tpu.utils.mesh import make_mesh as jax_make_mesh

    from quiver_tpu_torch.feature import ShardedRows

    rng = np.random.default_rng(25 + n_shards)
    table = rng.standard_normal((N, D)).astype(np.float32)
    per_dev = -(-N // n_shards) if budget == "all" else HOT // n_shards
    pmesh = qt.make_mesh(("data",), devices=[torch.device("cpu")] * n_shards)
    jmesh = jax_make_mesh(("data",), devices=jax.devices()[:n_shards])
    kw = dict(device_cache_size=per_dev, cache_unit="rows",
              cache_policy="ici_shard")
    pf = qt.Feature(mesh=pmesh, **kw).from_cpu_tensor(table)
    jf = JaxFeature(mesh=jmesh, **kw).from_cpu_tensor(table)
    assert pf.cache_count == jf.cache_count
    assert isinstance(pf.hot, ShardedRows)
    assert len(pf.hot.shards) == n_shards
    for _ in range(2):
        ids = rng.integers(0, N, 150)
        got = as_f32(pf[ids])
        np.testing.assert_array_equal(got, table[ids])
        np.testing.assert_array_equal(got, as_f32(jf[ids]))
    if budget == "all":
        ids = rng.integers(0, N, 70)
        np.testing.assert_array_equal(
            pf.lookup_device(torch.from_numpy(ids)).numpy(), table[ids])
        topo = qt.CSRTopo(indptr=np.arange(N + 1), indices=np.zeros(N))
        of = qt.Feature(mesh=pmesh, csr_topo=topo, **kw).from_cpu_tensor(
            table)
        np.testing.assert_array_equal(
            of.lookup_device(torch.from_numpy(ids)).numpy(), table[ids])
    # the alias, and no paging over a sharded prefix
    alias = qt.Feature(mesh=pmesh, device_cache_size=HOT // n_shards,
                       cache_unit="rows",
                       cache_policy="p2p_clique_replicate")
    assert alias.cache_policy == "ici_shard"
    alias.from_cpu_tensor(table)
    with pytest.raises(ValueError, match="sharded"):
        alias.enable_paging()
