"""Port parity: the multi-hop sampler and the feature store against the
JAX package on the same numpy inputs.

Every frontier, mask, count, relabel and edge id, and every gathered
feature row, must be bitwise equal.  The JAX sampler runs the
``gather_mode="xla", sample_rng="hash"`` route; the port takes the folded
words of the same per-hop keys (``jax.random.split(key, L)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt

N_NODES = 2000


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
    """The ``[L, 2]`` uint32 words the JAX pipeline derives from ``key``."""
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


@pytest.fixture(scope="module")
def csr():
    return qt.synthetic_csr(N_NODES, 24_000, seed=7)


@pytest.fixture(scope="module")
def feat():
    return np.random.default_rng(5).standard_normal(
        (N_NODES, 12)).astype(np.float32)


def _assert_batches_equal(jb, pb):
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    np.testing.assert_array_equal(np.asarray(jb.n_id_mask),
                                  pb.n_id_mask.numpy())
    assert int(jb.num_nodes) == int(pb.num_nodes)
    assert jb.batch_size == pb.batch_size
    assert len(jb.layers) == len(pb.layers)
    for jl, pl in zip(jb.layers, pb.layers):
        np.testing.assert_array_equal(np.asarray(jl.nbr_local),
                                      pl.nbr_local.numpy())
        np.testing.assert_array_equal(np.asarray(jl.mask), pl.mask.numpy())
        assert int(jl.num_targets) == int(pl.num_targets)
        np.testing.assert_array_equal(np.asarray(jl.eid), pl.eid.numpy())


@pytest.mark.parametrize("sizes,impl", [
    ([6], "threefry2x32"),
    ([8, 5], "threefry2x32"),
    ([5, 4, 3], "threefry2x32"),
    ([7, 3], "rbg"),
])
def test_pipeline_bitwise_equal(csr, sizes, impl):
    indptr, indices = csr
    seeds = np.random.default_rng(len(sizes)).integers(0, N_NODES, 24)
    key = make_key(40 + len(sizes), impl=impl)
    jb = JaxSampler(JaxTopo(indptr=indptr, indices=indices), sizes,
                    gather_mode="xla", sample_rng="hash", dedup="none",
                    return_eid=True).sample(seeds, key=key)
    ps = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             sizes, device="cpu", return_eid=True)
    pb = ps.sample(seeds, key_words=hop_words(key, len(sizes)))
    _assert_batches_equal(jb, pb)


def test_pyg_adjs_equal(csr):
    indptr, indices = csr
    seeds = np.arange(16)
    key = make_key(3)
    jb = JaxSampler(JaxTopo(indptr=indptr, indices=indices), [4, 3],
                    gather_mode="xla", sample_rng="hash", dedup="none",
                    return_eid=True).sample(seeds, key=key)
    pb = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             [4, 3], device="cpu", return_eid=True
                             ).sample(seeds, key_words=hop_words(key, 2))
    jn, jbs, jadjs = jb.to_pyg_adjs()
    pn, pbs, padjs = pb.to_pyg_adjs()
    np.testing.assert_array_equal(jn, pn)
    assert jbs == pbs
    for (je, jeid, jsz), (pe, peid, psz) in zip(jadjs, padjs):
        np.testing.assert_array_equal(je, pe)
        np.testing.assert_array_equal(jeid, peid)
        assert jsz == psz


def test_sampler_draws_words_from_its_seed(csr):
    indptr, indices = csr
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    a = qt.GraphSageSampler(topo, [5, 2], device="cpu", seed=3)
    b = qt.GraphSageSampler(topo, [5, 2], device="cpu", seed=3)
    ids = np.arange(10)
    for _ in range(2):
        ba, bb = a.sample(ids), b.sample(ids)
        assert torch.equal(ba.n_id, bb.n_id)
    with pytest.raises(ValueError):
        a.sample(np.array([N_NODES]))
    # the host mode is ported; an unknown mode is refused
    assert qt.GraphSageSampler(topo, [5], device="cpu",
                               mode="CPU").mode == "CPU"
    with pytest.raises(ValueError, match="mode"):
        qt.GraphSageSampler(topo, [5], device="cpu", mode="XPU")


# -- feature store -------------------------------------------------------

@pytest.mark.parametrize("order", ["degree", "none", "prob"])
def test_feature_rows_exact(csr, feat, order):
    indptr, indices = csr
    budget = feat.nbytes
    prob = (np.random.default_rng(1).random(N_NODES)
            if order == "prob" else None)
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    ptopo = qt.CSRTopo(indptr=indptr, indices=indices)
    jf = JaxFeature(device_cache_size=budget,
                    csr_topo=jtopo if order == "degree" else None
                    ).from_cpu_tensor(feat, prob=prob)
    pf = qt.Feature(device_cache_size=budget,
                    csr_topo=ptopo if order == "degree" else None,
                    device="cpu").from_cpu_tensor(feat, prob=prob)
    if order == "none":
        assert pf.feature_order is None and jf.feature_order is None
    else:
        np.testing.assert_array_equal(jf.feature_order, pf.feature_order)
    if order == "degree":
        np.testing.assert_array_equal(jtopo.feature_order,
                                      ptopo.feature_order)
    ids = np.random.default_rng(2).integers(0, N_NODES, 300)
    np.testing.assert_array_equal(np.asarray(jf[ids]), pf[ids].numpy())
    np.testing.assert_array_equal(
        np.asarray(jf.lookup_device(jnp.asarray(ids, jnp.int32))),
        pf.lookup_device(torch.from_numpy(ids.astype(np.int32))).numpy())
    np.testing.assert_array_equal(feat[ids], pf[ids].numpy())


def test_feature_bf16_and_rows_unit(csr, feat):
    indptr, indices = csr
    jf = JaxFeature(device_cache_size=N_NODES, cache_unit="rows",
                    dtype=jnp.bfloat16,
                    csr_topo=JaxTopo(indptr=indptr, indices=indices)
                    ).from_cpu_tensor(feat)
    pf = qt.Feature(device_cache_size=N_NODES, cache_unit="rows",
                    dtype=torch.bfloat16,
                    csr_topo=qt.CSRTopo(indptr=indptr, indices=indices),
                    device="cpu").from_cpu_tensor(feat)
    assert pf.hot.dtype == torch.bfloat16
    ids = np.arange(0, N_NODES, 7)
    np.testing.assert_array_equal(
        np.asarray(jf[ids].astype(jnp.float32)), pf[ids].float().numpy())


@pytest.mark.parametrize("ordered", [True, False])
def test_feature_lookup_device_clips_ids(csr, feat, ordered):
    """Out-of-range device ids read the first or last row, with or
    without a feature order, so the B2 kernel never leaves the table."""
    indptr, indices = csr
    topo = qt.CSRTopo(indptr=indptr, indices=indices) if ordered else None
    pf = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                    device="cpu").from_cpu_tensor(feat)
    got = pf.lookup_device(torch.tensor([-3, 0, N_NODES - 1, N_NODES + 9]))
    want = pf[np.array([0, 0, N_NODES - 1, N_NODES - 1])]
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), feat[[0, 0, -1, -1]])


def test_feature_partial_budget_raises(feat):
    """A partial budget builds (the budgeted store, test_torch_feature.py),
    but the device-id gather of the fused lane still needs the whole
    table, and an unknown cache policy is refused (``ici_shard`` is
    ported: test_torch_feature.py)."""
    f = qt.Feature(device_cache_size=feat.nbytes // 2,
                   device="cpu").from_cpu_tensor(feat)
    assert 0 < f.cache_count < feat.shape[0]
    with pytest.raises(RuntimeError, match="whole table"):
        f.lookup_device(torch.arange(4))
    with pytest.raises(ValueError, match="cache_policy"):
        qt.Feature(cache_policy="clique_shard", device="cpu")


@pytest.mark.parametrize("pin", ["key", "hash", "auto", "bogus"])
def test_sample_rng_pin_is_read_from_the_environment(monkeypatch, csr, pin):
    """``QUIVER_TPU_SAMPLE_RNG`` reaches ``Config.sample_rng`` as in JAX
    (``quiver_tpu/config.py:34-36``); ``resolve_sample_rng("auto")``
    honours it, and a ``"key"`` pin is refused as the argument is."""
    from quiver_tpu_torch import config

    monkeypatch.setenv("QUIVER_TPU_SAMPLE_RNG", pin)
    monkeypatch.setattr(config, "_config", None)  # built anew from the env
    assert config.get_config().sample_rng == pin
    topo = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    if pin in ("hash", "auto"):
        assert config.resolve_sample_rng("auto") == "hash"
        qt.GraphSageSampler(topo, [3], device="cpu")
        return
    with pytest.raises(ValueError) as pinned:
        config.resolve_sample_rng("auto")
    with pytest.raises(ValueError):
        qt.GraphSageSampler(topo, [3], device="cpu")
    if pin == "key":
        with pytest.raises(ValueError) as explicit:
            config.resolve_sample_rng("key")
        assert str(pinned.value) == str(explicit.value)
    # an explicit "hash" wins over any pin
    assert config.resolve_sample_rng("hash") == "hash"
