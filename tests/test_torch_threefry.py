"""Port parity: JAX's threefry key chain and ``sample_rng="key"``.

The port's key chain (``quiver_tpu_torch/utils/rng.py``: ``key``,
``split``, ``fold_in``, ``threefry2x32``), its threefry uniforms
(``ops/threefry.py``, the kernel's plain version on the CPU) and
``fold_key_words`` against ``jax.random`` and JAX's ``_fold_key_words``,
bit for bit.  Then every sampling path from a seed alone, with no word
computed in JAX: the port's ``sample(..., key=rng.key(s))`` against JAX's
``sample(..., key=make_key(s))``, under ``"hash"`` and then under
``"key"`` on both sides.  JAX's side runs ``gather_mode="xla"`` (its
Pallas element gather takes minutes a block in interpret mode); the
port's ``"blocked"``/``"pallas"`` reads are held against its own
``"xla"``.  Integer outputs bitwise; the fused step's loss within
``rtol=1e-5`` (dropout 0).  Last, the resolution of ``sample_rng`` and
``gather_mode`` for ``"key"`` against JAX's ``config``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu import config as jax_config
from quiver_tpu import telemetry as jtel
from quiver_tpu.dist.sampler import DistGraphSampler as JaxDistSampler
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.hetero import HeteroCSRTopo as JaxHeteroTopo
from quiver_tpu.hetero import HeteroGraphSageSampler as JaxHeteroSampler
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.pipeline import make_fused_eval_fn as jax_fused_eval
from quiver_tpu.pipeline import make_fused_train_step as jax_fused_step
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.stream import StreamingGraph as JaxGraph
from quiver_tpu.utils.mesh import make_mesh as jax_make_mesh
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.dist.sampler import DistGraphSampler
from quiver_tpu_torch.ops import threefry
from quiver_tpu_torch.ops.cuda import threefry as tf_kernel
from quiver_tpu_torch.ops.sample import fold_key_words, hop_key_words
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.utils import rng

N = 1500
CPU = torch.device("cpu")
SEEDS = (0, 1, 42, 2**31 - 1)
RNGS = ("hash", "key")


@pytest.fixture(scope="module", autouse=True)
def _registries_left_empty():
    """Both packages' registries emptied and JAX's telemetry switch set
    back when the file ends, so nothing recorded here reaches a later
    file on this worker."""
    on = jtel.enabled()
    yield
    jtel.reset()
    jtel.set_enabled(on)
    ptel.reset()


@pytest.fixture(scope="module")
def csr():
    return qt.synthetic_csr(N, 18_000, seed=3)


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k))


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(
        np.uint32).tobytes()


# -- the key chain --------------------------------------------------------
def test_jax_threefry_is_partitionable():
    """The bits matched here are JAX's with ``jax_threefry_partitionable``
    on, its default: a change of that default fails here, not as drift."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [*SEEDS, -1, 2**32 + 5, 2**40, -2**63])
def test_key_matches_jax(seed):
    want = _jkey_data(jax.random.key(seed))
    np.testing.assert_array_equal(rng.key(seed), want)
    np.testing.assert_array_equal(rng.key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    assert rng.key(seed).dtype == np.uint32
    np.testing.assert_array_equal(rng.key_data(rng.key(seed)), want)


def test_key_refuses_what_jax_refuses(monkeypatch):
    for bad in (2**63, -2**63 - 1):
        with pytest.raises(OverflowError):
            jax.random.key(bad)
        with pytest.raises(OverflowError):
            rng.key(bad)
    for bad in (1.5, "3"):
        with pytest.raises(TypeError):
            rng.key(bad)
    with pytest.raises(ValueError, match="rbg"):
        rng.key(0, impl="rbg")
    with pytest.raises(ValueError, match="one of"):
        rng.key(0, impl="philox")
    with pytest.raises(OverflowError):
        rng.fold_in(rng.key(0), 2**32)
    with pytest.raises(ValueError):
        rng.key_data(np.zeros(3, np.uint32))
    monkeypatch.setenv("QUIVER_TPU_PRNG", "rbg")
    with pytest.raises(ValueError, match="rbg"):
        rng.key(0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_matches_jax(seed, n):
    k, jk = rng.key(seed), jax.random.key(seed)
    got, want = rng.split(k, n), _jkey_data(jax.random.split(jk, n))
    assert got.shape == (n, 2) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    # nested: each child split again, and the default of two
    for i in range(n):
        np.testing.assert_array_equal(
            rng.split(got[i], 3),
            _jkey_data(jax.random.split(jax.random.split(jk, n)[i], 3)))
        np.testing.assert_array_equal(
            rng.split(got[i]),
            _jkey_data(jax.random.split(jax.random.split(jk, n)[i])))
    assert rng.split(k, 0).shape == (0, 2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 3, 2**32 - 1])
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(
        rng.fold_in(rng.key(seed), data),
        _jkey_data(jax.random.fold_in(jax.random.key(seed), data)))


def test_threefry2x32_matches_jax_primitive():
    from jax._src import prng as jprng

    g = np.random.default_rng(0)
    k = g.integers(0, 2**32, 2, dtype=np.uint32)
    x0, x1 = (g.integers(0, 2**32, 33, dtype=np.uint32) for _ in range(2))
    want = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                     jnp.asarray(x0), jnp.asarray(x1))
    got = rng.threefry2x32(k, x0, x1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed", [*SEEDS, 7])
@pytest.mark.parametrize("shape", [(1,), (7,), (2048, 25), (1024, 15),
                                   (0, 4), (3, 5, 2)])
def test_uniform_matches_jax_bits(seed, shape):
    """Compared as bits, not values: the plain version (the kernel's
    reference) is JAX's ``jax.random.uniform`` exactly, through the
    wrapper on a CPU device (which launches nothing)."""
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         jnp.float32))
    before = tf_kernel.threefry_uniform.launches
    got = tf_kernel.threefry_uniform(rng.key(seed), shape, CPU)
    assert tf_kernel.threefry_uniform.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _bits(got.numpy()) == _bits(want)
    plain = threefry.threefry_uniform_plain(rng.key(seed), shape, CPU)
    assert _bits(plain.numpy()) == _bits(want)


def test_uniform_of_arbitrary_words_matches_jax():
    """Any two words are a key: the hop keys of a split, raw."""
    for k in rng.split(rng.key(5), 4):
        want = jax.random.uniform(jax.random.wrap_key_data(k), (64, 9))
        got = threefry.threefry_uniform_plain(k, (64, 9))
        assert _bits(got.numpy()) == _bits(want)


def test_fold_key_words_matches_jax():
    for k in [rng.key(s) for s in SEEDS] + list(rng.split(rng.key(9), 5)):
        want = tuple(int(np.asarray(w)) for w in
                     _fold_key_words(jax.random.wrap_key_data(k)))
        assert fold_key_words(k) == want
    keys = rng.split(rng.key(1), 3)
    np.testing.assert_array_equal(
        hop_key_words(keys, "hash"),
        np.array([fold_key_words(k) for k in keys], np.uint32))
    np.testing.assert_array_equal(hop_key_words(keys, "key"), keys)
    with pytest.raises(ValueError):
        hop_key_words(keys, "auto")


@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("i", [0, 1, 10_000])
def test_example_key_words_are_jax_folded_split(i, hops):
    """``examples.key_words(i, hops)``: what a JAX script's sampler draws
    from ``PRNGKey(i)`` on an accelerator (``"hash"``)."""
    from quiver_tpu_torch.examples import key_words

    keys = jax.random.split(jax.random.PRNGKey(i), hops)
    want = np.array([[int(np.asarray(w)) for w in
                      _fold_key_words(jax.random.wrap_key_data(k))]
                     for k in keys], np.uint32)
    np.testing.assert_array_equal(key_words(i, hops), want)
    wide = key_words(i, hops, 3)
    np.testing.assert_array_equal(wide[:, :2], want)
    np.testing.assert_array_equal(wide[:, 2], np.asarray(keys)[:, -1])


# -- every path from a seed alone -----------------------------------------
def _same_batch(jb, pb, eid=True):
    np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
    np.testing.assert_array_equal(pb.n_id_mask.numpy(),
                                  np.asarray(jb.n_id_mask))
    assert int(pb.num_nodes) == int(jb.num_nodes)
    assert len(pb.layers) == len(jb.layers)
    for jl, pl in zip(jb.layers, pb.layers):
        np.testing.assert_array_equal(pl.nbr_local.numpy(),
                                      np.asarray(jl.nbr_local))
        np.testing.assert_array_equal(pl.mask.numpy(), np.asarray(jl.mask))
        assert int(pl.num_targets) == int(jl.num_targets)
        if eid:
            np.testing.assert_array_equal(pl.eid.numpy(),
                                          np.asarray(jl.eid))


def _seeds(seed, b=48, n=N):
    return np.random.default_rng(seed).integers(0, n, b)


@pytest.mark.parametrize("srng", RNGS)
@pytest.mark.parametrize("dedup,caps", [("none", None), ("hop", None),
                                        ("hop", [None, 200, 700])])
@pytest.mark.parametrize("mode", ["xla", "auto", "pallas"])
def test_pipeline_from_a_seed_matches_jax(csr, srng, dedup, caps, mode):
    """The positional and the exact-dedup pipeline (capped too), from
    ``key=rng.key(s)`` alone.  Under ``"key"`` the port's ``"auto"`` is
    ``"blocked"`` (B3's plain version on the CPU)."""
    jt, pt = JaxTopo(indptr=csr[0], indices=csr[1]), qt.CSRTopo(
        indptr=csr[0], indices=csr[1])
    sizes = [5, 4, 3]
    js = JaxSampler(jt, sizes, gather_mode="xla", sample_rng=srng,
                    dedup=dedup, frontier_caps=caps, return_eid=True)
    ps = qt.GraphSageSampler(pt, sizes, device="cpu", gather_mode=mode,
                             sample_rng=srng, dedup=dedup,
                             frontier_caps=caps, return_eid=True)
    assert ps.sample_rng == srng
    if mode == "auto":
        assert ps.gather_mode == ("blocked" if srng == "key" else "pwindow")
    for s in (0, 42):
        seeds = _seeds(s)
        jb = js.sample(seeds, key=make_key(s))
        _same_batch(jb, ps.sample(seeds, key=rng.key(s)))
        np.testing.assert_array_equal(ps.overflow_stats(),
                                      js.overflow_stats())
        # the JAX key's raw data is a key for the port as well
        _same_batch(jb, ps.sample(seeds, key=_jkey_data(make_key(s))))


@pytest.mark.parametrize("srng", RNGS)
def test_pipeline_counts_one_threefry_call_a_hop(csr, srng, monkeypatch):
    """A keyed ``"pallas"`` pipeline calls the threefry kernel's wrapper
    once a hop (one kernel launch a hop on the card); a keyed pipeline
    under the auto gather mode (``"blocked"``) calls it never, since B1's
    keyed instance draws the uniforms (its plain version here, with
    ``threefry_uniform_plain``); a hashed one never calls threefry."""
    calls = []
    real = tf_kernel.threefry_uniform

    def spy(words, shape, device=None):
        calls.append(tuple(shape))
        return real(words, shape, device)

    monkeypatch.setattr(tf_kernel, "threefry_uniform", spy)
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    for mode in ("pallas", "auto"):
        calls.clear()
        ps = qt.GraphSageSampler(pt, [5, 4, 3], device="cpu",
                                 sample_rng=srng, gather_mode=mode)
        ps.sample(_seeds(1, b=16), key=rng.key(1))
        assert calls == ([(16, 5), (96, 4), (480, 3)]
                         if srng == "key" and mode == "pallas" else [])


@pytest.mark.parametrize("srng", RNGS)
@pytest.mark.parametrize("dedup", ["none", "hop"])
def test_weighted_from_a_seed_matches_jax(csr, srng, dedup):
    w = np.random.default_rng(4).random(csr[1].shape[0]).astype(np.float32)
    jt, pt = JaxTopo(indptr=csr[0], indices=csr[1]), qt.CSRTopo(
        indptr=csr[0], indices=csr[1])
    js = JaxSampler(jt, [4, 3], gather_mode="xla", sample_rng=srng,
                    dedup=dedup, edge_weights=w, return_eid=True)
    for mode in ("xla", "auto"):
        ps = qt.GraphSageSampler(pt, [4, 3], device="cpu", sample_rng=srng,
                                 dedup=dedup, edge_weights=w,
                                 return_eid=True, gather_mode=mode)
        for s in (2, 3):
            _same_batch(js.sample(_seeds(s), key=make_key(s)),
                        ps.sample(_seeds(s), key=rng.key(s)))


@pytest.mark.parametrize("srng", RNGS)
def test_sample_layer_from_a_key_matches_jax_hop(csr, srng):
    """``sample_layer(key=)``: one hop under the hop key itself."""
    from quiver_tpu.ops.sample import sample_neighbors as jax_hop

    jt, pt = JaxTopo(indptr=csr[0], indices=csr[1]), qt.CSRTopo(
        indptr=csr[0], indices=csr[1])
    ps = qt.GraphSageSampler(pt, [6], device="cpu", sample_rng=srng)
    seeds = _seeds(5, b=40)
    ip, ix = jt.to_device(None)
    want = jax_hop(ip, ix, jnp.asarray(seeds, jnp.int32), 6, make_key(5),
                   gather_mode="xla", sample_rng=srng)
    got = ps.sample_layer(seeds, 6, key=rng.key(5))
    np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(want.nbrs))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    with pytest.raises(ValueError, match="not both"):
        ps.sample_layer(seeds, 6, key_words=[1, 2], key=rng.key(5))


@pytest.mark.parametrize("srng", RNGS)
def test_zero_delta_overlay_from_a_seed_matches_jax(srng):
    """A streaming graph with no pending update: its overlay pipeline from
    a seed equals JAX's and the port's frozen pipeline on the base."""
    g = np.random.default_rng(8)
    ei = np.stack([g.integers(0, 400, 5000), g.integers(0, 400, 5000)])
    ei[:, -1] = 399
    jt, pt = JaxTopo(edge_index=ei), qt.CSRTopo(edge_index=ei)
    jg, pg = JaxGraph(jt), StreamingGraph(pt, device="cpu")
    js = JaxSampler(jg, [5, 3], gather_mode="xla", sample_rng=srng,
                    return_eid=True)
    ps = qt.GraphSageSampler(pg, [5, 3], device="cpu", sample_rng=srng,
                             return_eid=True)
    frozen = qt.GraphSageSampler(pg.base, [5, 3], device="cpu",
                                 sample_rng=srng, dedup="none",
                                 return_eid=True)
    for s in (0, 1):
        seeds = _seeds(s, b=16, n=400)
        jb, pb = js.sample(seeds, key=make_key(s)), ps.sample(
            seeds, key=rng.key(s))
        _same_batch(jb, pb)
        assert pb.version == jb.version
        _same_batch(jb, frozen.sample(seeds, key=rng.key(s)))


@pytest.mark.parametrize("srng", RNGS)
def test_uva_from_a_seed_matches_jax(csr, srng):
    """UVA from a seed: the device tier's words and each hop's host seed
    (the hop key's last word) as JAX derives them."""
    jt, pt = JaxTopo(indptr=csr[0], indices=csr[1]), qt.CSRTopo(
        indptr=csr[0], indices=csr[1])
    budget = pt.edge_count * 4 // 3
    js = JaxSampler(jt, [4, 3], mode="UVA", uva_budget=budget,
                    gather_mode="xla", sample_rng=srng)
    ps = qt.GraphSageSampler(pt, [4, 3], mode="UVA", uva_budget=budget,
                             device="cpu", sample_rng=srng)
    words = ps.words_of_key(rng.key(9))
    assert words.shape == (2, 3)
    np.testing.assert_array_equal(
        words[:, 2], _jkey_data(jax.random.split(make_key(9), 2))[:, -1])
    for s in (9, 10):
        seeds = np.concatenate([_seeds(s, b=20), np.arange(N - 20, N)])
        _same_batch(js.sample(seeds, key=make_key(s)),
                    ps.sample(seeds, key=rng.key(s)), eid=False)
    with pytest.raises(ValueError, match="not both"):
        ps.sample(seeds, key_words=words, key=rng.key(1))


@pytest.mark.parametrize("srng", RNGS)
@pytest.mark.parametrize("mode", ["xla", "auto"])
def test_hetero_from_a_seed_matches_jax(srng, mode):
    counts = {"paper": 200, "author": 120, "institution": 30}
    g = np.random.default_rng(0)

    def edges(n_src, n_dst, avg):
        dst = np.repeat(np.arange(n_dst), g.poisson(avg, n_dst))
        return np.stack([g.integers(0, n_src, len(dst)), dst])

    cites, writes = ("paper", "cites", "paper"), ("author", "writes",
                                                  "paper")
    employs = ("institution", "employs", "author")
    ei = {cites: edges(200, 200, 5), writes: edges(120, 200, 3),
          employs: edges(30, 120, 0.5)}
    sizes = [{employs: 2, cites: 3, writes: 2}, {cites: 2, writes: 1,
                                                 employs: 1}]
    js = JaxHeteroSampler(JaxHeteroTopo.from_edge_index_dict(ei, counts),
                          sizes, gather_mode="xla", sample_rng=srng)
    ps = qt.HeteroGraphSageSampler(
        qt.HeteroCSRTopo.from_edge_index_dict(ei, counts), sizes,
        device="cpu", gather_mode=mode, sample_rng=srng)
    for s in (0, 5):
        seeds = _seeds(s, b=12, n=200)
        jb, pb = js.sample(seeds, key=make_key(s)), ps.sample(
            seeds, key=rng.key(s))
        for t in counts:
            np.testing.assert_array_equal(pb.n_id[t].numpy(),
                                          np.asarray(jb.n_id[t]))
            np.testing.assert_array_equal(pb.n_id_mask[t].numpy(),
                                          np.asarray(jb.n_id_mask[t]))
        for jl, pl in zip(jb.layers, pb.layers):
            assert [b.relation for b in pl] == [b.relation for b in jl]
            for jblk, pblk in zip(jl, pl):
                np.testing.assert_array_equal(pblk.nbr_local.numpy(),
                                              np.asarray(jblk.nbr_local))
                np.testing.assert_array_equal(pblk.mask.numpy(),
                                              np.asarray(jblk.mask))


@pytest.mark.parametrize("srng", RNGS)
@pytest.mark.parametrize("n", [2, 4])
def test_dist_sampler_from_its_seed_matches_jax(srng, n):
    """``DistGraphSampler.sample(seeds, key=seed)``: the words JAX derives
    inside its program (``key(seed)``, ``split`` a hop, ``fold_in`` a
    rank), with no word passed in."""
    g = np.random.default_rng(1)
    pairs = np.unique(np.stack([g.integers(0, 300, 3000),
                                g.integers(0, 300, 3000)], 1), axis=0)
    ptopo, jtopo = qt.CSRTopo(edge_index=pairs.T), JaxTopo(
        edge_index=pairs.T)
    ps = DistGraphSampler(ptopo, qt.make_mesh(("data",), devices=[CPU] * n),
                          [4, 3], sample_rng=srng)
    js = JaxDistSampler(jtopo, jax_make_mesh(("data",),
                                             devices=jax.devices()[:n]),
                        [4, 3], gather_mode="xla", sample_rng=srng)
    seeds = g.integers(0, 300, (n, 16))
    for seed in (7, 2**31 - 1):
        got, want = ps.sample(seeds, key=seed), js.sample(seeds, key=seed)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for pb, jb in zip(got[3], want[3]):
            for f in ("nbr_local", "mask", "num_targets"):
                np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                              np.asarray(getattr(jb, f)))
    with pytest.raises(OverflowError):
        ps.sample(seeds, key=2**31)


def test_dist_sampler_refuses_rbg(monkeypatch):
    pairs = np.stack([np.arange(50), (np.arange(50) + 1) % 50], 1)
    ps = DistGraphSampler(qt.CSRTopo(edge_index=pairs.T),
                          qt.make_mesh(("data",), devices=[CPU] * 2), [2])
    monkeypatch.setenv("QUIVER_TPU_PRNG", "rbg")
    with pytest.raises(ValueError, match="rbg"):
        ps.sample(np.zeros((2, 4), np.int64), key=1)


@pytest.mark.parametrize("srng", RNGS)
def test_fused_step_and_eval_from_a_key_match_jax(csr, srng):
    """The fused step from ``key=``: JAX's ``ks, kd = split(key)`` drives
    the hops; the loss within ``rtol=1e-5`` at dropout 0.  Eval samples
    from its key directly; the epoch splits one key a step."""
    jt, pt = JaxTopo(indptr=csr[0], indices=csr[1]), qt.CSRTopo(
        indptr=csr[0], indices=csr[1])
    g = np.random.default_rng(6)
    D, C, B = 12, 5, 32
    feat = g.standard_normal((N, D)).astype(np.float32)
    labels = g.integers(0, C, N).astype(np.int32)
    js = JaxSampler(jt, [5, 4, 3], gather_mode="xla", sample_rng=srng)
    ps = qt.GraphSageSampler(pt, [5, 4, 3], device="cpu", sample_rng=srng)
    jf = JaxFeature(device_cache_size=feat.nbytes, csr_topo=jt
                    ).from_cpu_tensor(feat)
    jf.lookup_device(jnp.arange(2, dtype=jnp.int32))
    pf = qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                    device="cpu").from_cpu_tensor(feat)
    ids = g.integers(0, N, B)
    b0 = js.sample(ids, key=make_key(1))
    flax = FlaxSAGE(hidden=16, out_dim=C, num_layers=3, dropout=0.0)
    params = flax.init(jax.random.PRNGKey(0), jf[np.asarray(b0.n_id)],
                       b0.layers)

    def apply(p, x, blocks, train=False, rngs=None):
        return flax.apply(p, x, blocks, train=train, rngs=rngs)

    jstep = jax_fused_step(js, jf, apply, optax.adam(3e-3))
    model = qt.GraphSAGE(D, 16, C, num_layers=3, dropout=0.0, device="cpu")
    model.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    pstep = qt.make_fused_train_step(
        ps, pf, model, torch.optim.Adam(model.parameters(), lr=3e-3))
    ones = np.ones(B, bool)
    want_logits = jax_fused_eval(js, jf, apply)(
        params, jnp.asarray(ids, jnp.int32), make_key(3))
    got_logits = qt.make_fused_eval_fn(ps, pf, model)(ids, key=rng.key(3))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    _, jloss = jstep(JaxState.create(params, optax.adam(3e-3)),
                     jnp.asarray(ids, jnp.int32), jnp.asarray(labels[ids]),
                     jnp.asarray(ones), make_key(100))
    ploss = pstep(ids, torch.from_numpy(labels[ids]), torch.from_numpy(ones),
                  key=rng.key(100))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                               atol=1e-6)
    # the epoch: one key a step, split from the epoch's key
    keys = rng.split(rng.key(4), 2)
    words = np.stack([ps.words_of_key(rng.split(k)[0]) for k in keys])
    ep = qt.make_scan_epoch(ps, pf, model, torch.optim.SGD(
        model.parameters(), lr=0.0))
    seeds2 = torch.from_numpy(np.stack([ids, ids[::-1].copy()]))
    labs2 = torch.from_numpy(np.stack([labels[ids], labels[ids[::-1]]]))
    torch.testing.assert_close(ep(seeds2, labs2, key=rng.key(4)),
                               ep(seeds2, labs2, words), rtol=0, atol=0)


def test_serving_lanes_follow_the_samplers_rng(csr):
    """The sampler's ``sample_rng`` reaches both serving lanes (JAX
    ``serving.py:579-597``): under ``"key"`` the fused pass from a key's
    words is JAX's model on JAX's keyed batch from the same key, the
    unfused pass of the same words gives the same logits, and the hash
    pass's differ."""
    jt = JaxTopo(indptr=csr[0], indices=csr[1])
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    feat = np.random.default_rng(2).standard_normal(
        (N, 8)).astype(np.float32)
    jf = JaxFeature(device_cache_size=feat.nbytes, csr_topo=jt
                    ).from_cpu_tensor(feat)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                         device="cpu").from_cpu_tensor(feat)
    js = JaxSampler(jt, [4, 3], gather_mode="xla", sample_rng="key")
    keyed = qt.GraphSageSampler(pt, [4, 3], device="cpu", sample_rng="key")
    b0 = js.sample(_seeds(3, b=20), key=make_key(0))
    flax = FlaxSAGE(hidden=8, out_dim=3, num_layers=2, dropout=0.0)
    params = flax.init(jax.random.PRNGKey(0), jf.lookup_device(b0.n_id),
                       b0.layers)
    model = qt.GraphSAGE(8, 8, 3, num_layers=2, dropout=0.0, device="cpu")
    model.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    server = qt.InferenceServer(keyed, feature, model, None)
    padded = server._pad_ids(_seeds(3, b=20))
    jb = js.sample(padded, key=make_key(5))
    kw = keyed.words_of_key(rng.key(5))
    fused = server.fused_forward(padded, kw)
    want = np.asarray(flax.apply(params, jf.lookup_device(jb.n_id),
                                 jb.layers))
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(server.unfused_forward(padded, kw), fused,
                               rtol=1e-6, atol=1e-6)
    hashed = qt.InferenceServer(
        qt.GraphSageSampler(pt, [4, 3], device="cpu"), feature, model, None)
    assert not torch.equal(hashed.fused_forward(padded, kw), fused)


# -- resolution -----------------------------------------------------------
@pytest.fixture
def pins(monkeypatch):
    """Set ``QUIVER_TPU_*`` pins and rebuild both packages' configs."""
    pjax = importlib.import_module("quiver_tpu.config")

    def set_pins(gather=None, srng=None):
        for name, v in (("GATHER_MODE", gather), ("SAMPLE_RNG", srng)):
            if v is None:
                monkeypatch.delenv(f"QUIVER_TPU_{name}", raising=False)
            else:
                monkeypatch.setenv(f"QUIVER_TPU_{name}", v)
        monkeypatch.setattr(config, "_config", None)
        monkeypatch.setattr(pjax, "_config", None)

    yield set_pins


@pytest.mark.parametrize("gather_pin,rng_pin,gm,sr,want_gm,want_sr,warns", [
    # JAX's own cases: a "pwindow" pin under an explicit "key" -> blocked;
    # a "key" pin under a pinned or explicit "pwindow" -> hash, warned
    ("pwindow", None, "auto", "key", "blocked", "key", False),
    ("pwindow:4", None, "auto", "key", "blocked:4", "key", False),
    ("pwindow", "key", "auto", "auto", "pwindow", "hash", True),
    (None, "key", "pwindow", "auto", "pwindow", "hash", True),
    # an explicit "pwindow" with an explicit "key" is left as given
    (None, None, "pwindow", "key", "pwindow", "key", False),
    (None, None, "xla", "key", "xla", "key", False),
    ("lanes", "key", "auto", "auto", "lanes", "key", False),
    (None, "hash", "blocked:2", "auto", "blocked:2", "hash", False),
])
def test_resolution_matches_jax(pins, gather_pin, rng_pin, gm, sr, want_gm,
                                want_sr, warns):
    pins(gather_pin, rng_pin)
    for cfg in (config, jax_config):
        got_gm = cfg.resolve_gather_mode(gm, sr)
        assert got_gm == want_gm, cfg
        if warns:
            with pytest.warns(UserWarning, match="overridden to 'hash'"):
                got_sr = cfg.resolve_sample_rng(sr, got_gm)
        else:
            got_sr = cfg.resolve_sample_rng(sr, got_gm)
        assert got_sr == want_sr, cfg
    # the port's one entry resolves both, in JAX's order
    if warns:
        with pytest.warns(UserWarning, match="overridden to 'hash'"):
            assert config.resolve_sampling(gm, sr) == (want_gm, want_sr)
    else:
        assert config.resolve_sampling(gm, sr) == (want_gm, want_sr)


@pytest.mark.parametrize("rng_pin,sr", [(None, "key"), ("key", "auto")])
def test_key_under_the_ports_auto_gather_is_blocked(pins, rng_pin, sr):
    """The port's own default: ``"auto"`` is ``"pwindow"`` (JAX's is
    ``"lanes"``/``"xla"``); under a ``"key"`` RNG, explicit or pinned, it
    is ``"blocked"``, the key-capable counterpart.  ``"auto"`` alone is
    the hash, as JAX's on an accelerator."""
    pins(None, rng_pin)
    gm = config.resolve_gather_mode("auto", sr)
    assert gm == "blocked"
    assert config.resolve_sample_rng(sr, gm) == "key"
    pins(None, None)
    assert config.resolve_gather_mode("auto", "auto") == "pwindow"
    assert config.resolve_sample_rng("auto", "pwindow") == "hash"
    assert config.resolve_sample_rng("auto") == "hash"


def test_explicit_key_with_pwindow_raises_at_the_op(csr):
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    s = qt.GraphSageSampler(pt, [3], device="cpu", gather_mode="pwindow",
                            sample_rng="key")
    with pytest.raises(ValueError, match="requires sample_rng='hash'"):
        s.sample(np.arange(4), key=rng.key(0))
    with pytest.raises(ValueError, match="requires sample_rng='hash'"):
        qt.sample_neighbors(*pt.to_device("cpu"), torch.arange(4), 3,
                            rng.key(0), device="cpu", gather_mode="pwindow",
                            sample_rng="key")
    with pytest.raises(ValueError, match="auto\\|key\\|hash"):
        qt.GraphSageSampler(pt, [3], device="cpu", sample_rng="threefry")


def test_key_and_key_words_are_exclusive(csr):
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    s = qt.GraphSageSampler(pt, [3, 2], device="cpu")
    with pytest.raises(ValueError, match="not both"):
        s.sample(np.arange(4), key_words=s.draw_key_words(),
                 key=rng.key(0))
    # key_words keeps its meaning: the words of the key give the same batch
    a = s.sample(np.arange(4), key=rng.key(3))
    b = s.sample(np.arange(4), key_words=s.words_of_key(rng.key(3)))
    assert torch.equal(a.n_id, b.n_id)


@pytest.mark.parametrize("srng", RNGS)
def test_mesh_sampler_takes_sample_rng(csr, srng):
    """``MeshSampler(sample_rng=)`` against JAX's (``mesh/sampler.py:53-69,
    145-165``): the sharded hop from one hop key equals JAX's sharded hop
    from the same key, field by field, and the port's single-device hop
    under the same words and RNG."""
    from quiver_tpu.mesh import MeshSampler as JaxMeshSampler

    from quiver_tpu_torch.mesh import MeshSampler

    ms = MeshSampler(csr[0], csr[1], n_shards=3,
                     mesh=qt.make_mesh(("shard",), devices=[CPU] * 3),
                     sample_rng=srng)
    js = JaxMeshSampler(csr[0], csr[1], n_shards=3, sample_rng=srng)
    assert ms.sample_rng == js.sample_rng == srng
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    ps = qt.GraphSageSampler(pt, [5], device="cpu", sample_rng=srng,
                             gather_mode="xla")
    for trial in range(2):
        seeds = _seeds(2 + trial, b=30)
        hop_key = rng.split(rng.key(2 + trial), 1)[0]
        got = ms.sample(seeds, 5, hop_key_words(hop_key, srng)[0])
        want = js.sample(seeds, 5, jax.random.wrap_key_data(hop_key))
        for f in ("nbrs", "mask", "counts", "eid"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                err_msg=f)
        single = ps.sample_layer(seeds, 5, key=hop_key)
        np.testing.assert_array_equal(got.nbrs.numpy(),
                                      single.nbrs.numpy())
        np.testing.assert_array_equal(got.mask.numpy(),
                                      single.mask.numpy())


def test_subpackage_names_match_jax():
    """Each port subpackage's ``__init__`` holds every public name of
    JAX's (its ``__all__``, or else what its ``__init__`` imports and
    defines), but the deliberate omissions of ROADMAP §C."""
    import ast
    import pathlib

    import quiver_tpu

    omitted = {"FALLBACK_FRAC", "blocked_window_gather",
               "blocked_weighted_positions", "tree_flatten",
               "tree_unflatten"}
    root = pathlib.Path(quiver_tpu.__file__).parent
    checked = 0
    for init in sorted(root.glob("*/__init__.py")):
        names, declared = set(), None
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.level:
                names |= {a.asname or a.name for a in node.names}
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        declared = set(ast.literal_eval(node.value))
                    elif isinstance(t, ast.Name):
                        names.add(t.id)
        public = declared if declared is not None else {
            n for n in names if not n.startswith("_") and n != "*"}
        mod = importlib.import_module(f"quiver_tpu_torch.{init.parent.name}")
        missing = sorted(n for n in public - omitted if not hasattr(mod, n))
        assert not missing, (init.parent.name, missing)
        checked += 1
    assert checked >= 14
    from quiver_tpu_torch import ops, utils

    for name in ("reindex", "ReindexOut", "cal_neighbor_prob", "sample_prob",
                 "row_cumsum_weights", "sample_neighbors_weighted"):
        assert name in ops.__all__
    for name in ("make_mesh", "MeshTopo", "init_p2p"):
        assert name in utils.__all__
