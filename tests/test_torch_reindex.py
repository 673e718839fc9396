"""Port parity: exact dedup.  ``ops/reindex.py``, the ``dedup="hop"``
pipeline with and without frontier caps, the sampler surface around it
(``overflow_stats``, ``sample_sub``, ``to_pyg_adjs``, the new keyword
arguments), ``sample_prob`` and one fused train step, against the JAX
package on the same numpy inputs.

Integer outputs are bitwise equal.  The JAX references run
``gather_mode="xla"`` (or the same ``"blocked:U"``) with
``sample_rng="hash"``.  ``sample_prob`` sums with ``index_add_``, not
``segment_sum``, so it agrees within ``rtol=1e-5, atol=1e-6``; the fused
step's loss within ``rtol=1e-5``, as in test_torch_train.py.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops.prob import sample_prob as jax_sample_prob
from quiver_tpu.ops.reindex import reindex as jax_reindex
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.pipeline import make_fused_train_step as jax_fused_step
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config, sampler as port_sampler
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.ops import reindex as port_reindex

N = 2000
REINDEX_FIELDS = ("n_id", "num_nodes", "n_id_mask", "local_nbrs", "mask")


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


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


@pytest.fixture(scope="module")
def csr():
    return qt.synthetic_csr(N, 24_000, seed=7)


def _topos(csr):
    indptr, indices = csr
    return (JaxTopo(indptr=indptr, indices=indices),
            qt.CSRTopo(indptr=indptr, indices=indices))


def _assert_batches_equal(jb, pb):
    np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
    np.testing.assert_array_equal(pb.n_id_mask.numpy(),
                                  np.asarray(jb.n_id_mask))
    assert int(pb.num_nodes) == int(jb.num_nodes)
    assert pb.batch_size == jb.batch_size
    assert len(pb.layers) == len(jb.layers)
    for jl, pl in zip(jb.layers, pb.layers):
        np.testing.assert_array_equal(pl.nbr_local.numpy(),
                                      np.asarray(jl.nbr_local))
        np.testing.assert_array_equal(pl.mask.numpy(), np.asarray(jl.mask))
        assert int(pl.num_targets) == int(jl.num_targets)
        np.testing.assert_array_equal(pl.eid.numpy(), np.asarray(jl.eid))
    np.testing.assert_array_equal(pb.drops.numpy(), np.asarray(jb.drops))


@pytest.mark.parametrize("case", ["duplicates", "masked_seeds",
                                  "all_masked_rows", "k1"])
def test_reindex_matches_jax(case):
    rng = np.random.default_rng(len(case))
    B, k = (40, 1) if case == "k1" else (40, 6)
    seeds = rng.integers(0, 300, B).astype(np.int32)
    if case == "duplicates":  # a padded serving bucket repeats ids[0]
        seeds[25:] = seeds[0]
        seeds[5] = seeds[3]
    # neighbours drawn partly from the seeds, partly elsewhere; -1 where
    # masked, as a hop returns them
    nbrs = np.where(rng.random((B, k)) < 0.3,
                    rng.choice(seeds, (B, k)), rng.integers(0, 300, (B, k)))
    mask = rng.random((B, k)) < 0.8
    seed_mask = None
    if case == "masked_seeds":
        seed_mask = rng.random(B) < 0.7
        seed_mask[0] = True
        # a neighbour equal to a masked seed's id matches no seed
        nbrs[:, 0] = np.where(seed_mask, nbrs[:, 0], seeds)
    if case == "all_masked_rows":
        mask[::3] = False
    nbrs = np.where(mask, nbrs, -1).astype(np.int32)
    want = jax_reindex(jnp.asarray(seeds), jnp.asarray(nbrs),
                       jnp.asarray(mask),
                       None if seed_mask is None else jnp.asarray(seed_mask))
    got = port_reindex.reindex(
        torch.from_numpy(seeds), torch.from_numpy(nbrs),
        torch.from_numpy(mask),
        None if seed_mask is None else torch.from_numpy(seed_mask))
    for name in REINDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    n = int(got.num_nodes)
    assert got.n_id_mask[:B].tolist() == (
        [True] * B if seed_mask is None else seed_mask.tolist())
    rest = got.n_id[B:n].numpy()
    assert (np.diff(rest) > 0).all()  # non-seed nodes sorted, distinct


def test_reindex_path_never_syncs():
    """No host read-back and no data-dependent size on the dedup path:
    ``ops/reindex.py`` and the ``"hop"`` pipeline call none of these."""
    banned = {"item", "tolist", "unique", "nonzero", "masked_select", "cpu",
              "numpy"}
    for obj in (port_reindex, port_sampler._sample_pipeline):
        tree = ast.parse(inspect.getsource(obj))
        called = {n.func.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        assert not called & banned, (obj, called & banned)


@pytest.mark.parametrize("sizes,caps,mode", [
    ([8, 5], None, "xla"),
    ([8, 5], [None, 150], "xla"),
    ([5, 4, 3], None, "pwindow"),
    ([5, 4, 3], [60, 300, 900], "pallas"),
    ([5, 4, 3], [None, 200, 1000], "blocked:2"),
])
def test_hop_pipeline_matches_jax(csr, sizes, caps, mode):
    """Two and three ``"hop"`` hops; caps that force drops (``drops``
    equal too).  The port in ``mode`` against JAX's ``"xla"`` (or the same
    ``blocked:U``)."""
    jt, pt = _topos(csr)
    jmode = mode if mode.startswith("blocked") else "xla"
    seeds = np.random.default_rng(len(sizes)).integers(0, N, 24)
    seeds[20:] = seeds[0]  # duplicate seeds
    key = make_key(40 + len(sizes))
    js = JaxSampler(jt, sizes, gather_mode=jmode, sample_rng="hash",
                    dedup="hop", frontier_caps=caps, return_eid=True)
    ps = qt.GraphSageSampler(pt, sizes, device="cpu", gather_mode=mode,
                             dedup="hop", frontier_caps=caps,
                             return_eid=True)
    jb = js.sample(seeds, key=key)
    pb = ps.sample(seeds, key_words=hop_words(key, len(sizes)))
    _assert_batches_equal(jb, pb)
    if caps:
        assert int(pb.drops.sum()) > 0


def _drops_counted() -> float:
    """The port registry's count of frontier drops: its one source."""
    return ptel.snapshot()["counters"].get(
        "sampler_frontier_drops_total{mode=gpu}", 0.0)


def test_hop_sampler_surface(csr):
    """``sample``, ``to_pyg_adjs``, ``overflow_stats`` (and its counter,
    once per call) and ``sample_sub`` of a ``dedup="hop"`` sampler."""
    jt, pt = _topos(csr)
    caps = [None, 120]
    js = JaxSampler(jt, [6, 4], gather_mode="xla", sample_rng="hash",
                    dedup="hop", frontier_caps=caps, return_eid=True)
    ps = qt.GraphSageSampler(pt, [6, 4], device="cpu", dedup="hop",
                             frontier_caps=caps, return_eid=True)
    assert "dedup='hop'" in repr(ps)
    assert ps.overflow_stats() is None
    seeds = np.arange(16)
    key = make_key(3)
    jb = js.sample(seeds, key=key)
    pb = ps.sample(seeds, key_words=hop_words(key, 2))
    _assert_batches_equal(jb, pb)
    jn, jbs, jadjs = jb.to_pyg_adjs()
    pn, pbs, padjs = pb.to_pyg_adjs()
    np.testing.assert_array_equal(jn, pn)
    assert jbs == pbs
    for (je, jeid, jsz), (pe, peid, psz) in zip(jadjs, padjs):
        np.testing.assert_array_equal(je, pe)
        np.testing.assert_array_equal(jeid, peid)
        assert jsz == psz
    before = _drops_counted()
    drops = ps.overflow_stats()
    np.testing.assert_array_equal(drops, js.overflow_stats())
    np.testing.assert_array_equal(ps.overflow_stats(pb), drops)
    assert drops[1] > 0 and _drops_counted() - before == drops.sum()
    ps.overflow_stats()  # a second read of the same call counts nothing
    assert _drops_counted() - before == drops.sum()

    # sample_sub: JAX's sample_layer draws with its default RNG, so the
    # reference is JAX's hop under the hash and JAX's reindex
    sub = np.array([5, 9, 5, 30, 41])
    key = make_key(8)
    words = tuple(int(np.asarray(w)) for w in _fold_key_words(key))
    jip, jix = jt.to_device()
    out = jax_sample_neighbors(jip, jix, jnp.asarray(sub, jnp.int32), 7, key,
                               sample_rng="hash")
    r = jax_reindex(jnp.asarray(sub, jnp.int32), out.nbrs, out.mask)
    m = np.asarray(r.mask)
    want = (np.asarray(r.n_id)[:int(r.num_nodes)],
            np.repeat(np.arange(len(sub)), 7).reshape(m.shape)[m],
            np.asarray(r.local_nbrs)[m])
    for a, b in zip(ps.sample_sub(sub, 7, key_words=words), want):
        np.testing.assert_array_equal(a, b)
    layer = ps.sample_layer(sub, 7, key_words=words)
    np.testing.assert_array_equal(layer.nbrs.numpy(), np.asarray(out.nbrs))


def test_full_surface_sampler_matches_jax(csr):
    """Exact dedup, caps, edge weights, the hash RNG and ``blocked:3``
    together, bitwise against JAX."""
    jt, pt = _topos(csr)
    w = np.random.default_rng(2).random(pt.edge_count, dtype=np.float32)
    kw = dict(dedup="hop", frontier_caps=[None, 150, 600],
              edge_weights=w, sample_rng="hash", gather_mode="blocked:3",
              return_eid=True)
    js = JaxSampler(jt, [6, 4, 3], **kw)
    ps = qt.GraphSageSampler(pt, [6, 4, 3], device="cpu", **kw)
    seeds = np.random.default_rng(4).integers(0, N, 32)
    key = make_key(12)
    _assert_batches_equal(js.sample(seeds, key=key),
                          ps.sample(seeds, key_words=hop_words(key, 3)))


@pytest.mark.parametrize("kw", [dict(uva_budget="1G"),
                                dict(uva_overlap=False),
                                dict(uva_timings={}), dict(mode="CPU")],
                         ids=["uva_budget", "uva_overlap", "uva_timings",
                              "mode"])
def test_host_tier_arguments_refused(csr, kw):
    """The hot/cold split and the host sampler are ported (ROADMAP A10):
    each argument is taken and kept, not ignored; what UVA mode cannot
    serve (edge ids of hot-tier positions) is refused, as in JAX."""
    _, pt = _topos(csr)
    s = qt.GraphSageSampler(pt, [3], device="cpu", **kw)
    assert s.mode == kw.get("mode", "GPU")  # a budget needs mode="UVA"
    assert s.uva_budget == kw.get("uva_budget")
    assert s.uva_overlap == kw.get("uva_overlap", True)
    assert s.uva_timings is kw.get("uva_timings")
    uva = dict(kw, mode="UVA", uva_budget=kw.get("uva_budget", "1M"))
    with pytest.raises(ValueError, match="UVA"):
        qt.GraphSageSampler(pt, [3], device="cpu", return_eid=True, **uva)


def test_refusals_and_resolution(csr, monkeypatch):
    _, pt = _topos(csr)
    with pytest.raises(ValueError, match="key"):
        qt.GraphSageSampler(pt, [3], device="cpu", sample_rng="key")
    with pytest.raises(ValueError):
        qt.GraphSageSampler(pt, [3, 2], device="cpu", frontier_caps=[10])
    with pytest.raises(ValueError):
        qt.GraphSageSampler(pt, [3], device="cpu", dedup="exact")
    # the streaming overlay is ported (test_torch_overlay.py): an overlay
    # without its tables fails on the first one it reads, as in JAX
    with pytest.raises(KeyError, match="tomb"):
        qt.run_pipeline("none", *pt.to_device("cpu"), torch.arange(4),
                        np.zeros((1, 2), np.uint32), [3], overlay={})
    s = qt.GraphSageSampler(pt, [3], device="cpu", sample_rng="hash",
                            uva_overlap=True, uva_timings=None)
    assert s.mode == "GPU" and s.dedup == "none"

    assert config.resolve_dedup("hop") == "hop"
    assert config.resolve_dedup("none") == "none"
    assert config.resolve_dedup("auto") == "none"
    with config.override(dedup="hop"):
        assert config.resolve_dedup("auto") == "hop"
        assert config.resolve_dedup("none") == "none"
        assert qt.GraphSageSampler(pt, [3], device="cpu").dedup == "hop"
    monkeypatch.setenv("QUIVER_TPU_DEDUP", "hop")
    assert config.Config().dedup == "hop"
    with config.override(dedup=config.Config().dedup):
        assert config.resolve_dedup("auto") == "hop"
    monkeypatch.setenv("QUIVER_TPU_DEDUP", "bogus")
    with config.override(dedup=config.Config().dedup):
        with pytest.raises(ValueError):
            config.resolve_dedup("auto")
    for bad in ("exact", None):
        with pytest.raises(ValueError):
            config.resolve_dedup(bad)
    assert config.resolve_sample_rng("auto") == "hash"
    assert config.resolve_sample_rng("hash") == "hash"
    with pytest.raises(ValueError, match="ROADMAP"):
        config.resolve_sample_rng("key")


def test_sample_prob_matches_jax(csr):
    indptr, indices = csr
    jt, pt = _topos(csr)
    train = np.random.default_rng(3).choice(N, 300, replace=False)
    sizes = [6, 4, 3]
    jip, jix = jt.to_device()
    want = np.asarray(jax_sample_prob(jip, jix, jnp.asarray(train), N, sizes,
                                      num_edges=jt.edge_count))
    got = qt.GraphSageSampler(pt, sizes, device="cpu").sample_prob(train, N)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (want > 0).sum() > N // 2


def test_fused_train_step_hop_matches_jax(csr):
    """One fused step under ``dedup="hop"`` with a cap: loss within
    ``rtol=1e-5``.  A weighted sampler's fused step samples uniformly in
    both packages."""
    indptr, indices = csr
    jt, pt = _topos(csr)
    rng = np.random.default_rng(6)
    D, C, B = 12, 5, 48
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, C, N).astype(np.int32)
    w = rng.random(pt.edge_count, dtype=np.float32)
    kw = dict(dedup="hop", frontier_caps=[None, 400, 1500], edge_weights=w)
    js = JaxSampler(jt, [5, 4, 3], gather_mode="xla", sample_rng="hash",
                    **kw)
    ps = qt.GraphSageSampler(pt, [5, 4, 3], device="cpu", **kw)
    jf = JaxFeature(device_cache_size=feat.nbytes, csr_topo=jt
                    ).from_cpu_tensor(feat)
    jf.lookup_device(jnp.arange(2, dtype=jnp.int32))
    pf = qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                    device="cpu").from_cpu_tensor(feat)
    ids = rng.integers(0, N, B)
    b0 = js.sample(ids, key=make_key(1))
    flax = FlaxSAGE(hidden=16, out_dim=C, num_layers=3, dropout=0.0)
    params = flax.init(jax.random.PRNGKey(0), jf[np.asarray(b0.n_id)],
                       b0.layers)
    jstep = jax_fused_step(
        js, jf, lambda p, x, blocks, train=False, rngs=None: flax.apply(
            p, x, blocks, train=train, rngs=rngs), optax.adam(3e-3))
    model = qt.GraphSAGE(D, 16, C, num_layers=3, dropout=0.0,
                         device="cpu")
    model.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    pstep = qt.make_fused_train_step(
        ps, pf, model, torch.optim.Adam(model.parameters(), lr=3e-3))
    ones = np.ones(B, bool)
    key = make_key(100)
    ks, _ = jax.random.split(key)
    _, jloss = jstep(JaxState.create(params, optax.adam(3e-3)),
                     jnp.asarray(ids, jnp.int32), jnp.asarray(labels[ids]),
                     jnp.asarray(ones), key)
    ploss = pstep(ids, torch.from_numpy(labels[ids]), torch.from_numpy(ones),
                  hop_words(ks, 3))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                               atol=1e-6)
