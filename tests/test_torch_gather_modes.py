"""Port parity: the sampler's element-gather modes.

Every mode of the port (``xla``, ``lanes``, ``lanes_fused``, ``pallas``
and ``auto``, which resolves to the fused ``pwindow`` hop) must sample
bitwise what JAX samples with ``gather_mode="xla", sample_rng="hash"``
under the same folded key words: one hop (``nbrs``, ``mask``, ``counts``,
``eid``) and a 3-hop ``GraphSageSampler.sample`` (``n_id`` and every
``LayerBlock``).  On the CPU the kernels B1, B3 and B4 run their plain
versions.  Also: how a mode is resolved and validated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu.config as jax_config
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config
from quiver_tpu_torch.ops import sample as psample

N_NODES = 3000
MODES = ["xla", "lanes", "lanes_fused", "pallas", "auto"]


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
    return qt.synthetic_csr(N_NODES, 40_000, seed=11)


@pytest.mark.parametrize("mode", MODES)
def test_gather_mode_samples_bitwise_like_jax(csr, mode):
    indptr, indices = csr
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    ip, ix = topo.to_device("cpu")
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    jip, jix = jtopo.to_device()
    rng = np.random.default_rng(7)

    # one hop over seeds with masked entries and both ends of the id range
    seeds = np.concatenate([[0, N_NODES - 1],
                            rng.integers(0, N_NODES, 300)]).astype(np.int32)
    smask = rng.random(seeds.shape[0]) < 0.8
    key = make_key(21)
    want = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), 12, key,
                                seed_mask=jnp.asarray(smask),
                                gather_mode="xla", sample_rng="hash")
    got = qt.sample_neighbors(ip, ix, torch.from_numpy(seeds), 12,
                              [int(np.asarray(w))
                               for w in _fold_key_words(key)],
                              seed_mask=torch.from_numpy(smask),
                              device="cpu", gather_mode=mode)
    for name in ("nbrs", "mask", "counts", "eid"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), name)

    # the 3-hop sampler
    sizes = [15, 10, 5]
    ids = rng.integers(0, N_NODES, 64)
    key = make_key(22)
    jb = JaxSampler(jtopo, sizes, gather_mode="xla", sample_rng="hash",
                    dedup="none", return_eid=True).sample(ids, key=key)
    ps = qt.GraphSageSampler(topo, sizes, device="cpu", return_eid=True,
                             gather_mode=mode)
    assert ps.gather_mode == ("pwindow" if mode == "auto" else mode)
    pb = ps.sample(ids, key_words=hop_words(key, len(sizes)))
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    np.testing.assert_array_equal(np.asarray(jb.n_id_mask),
                                  pb.n_id_mask.numpy())
    assert int(jb.num_nodes) == int(pb.num_nodes)
    for jl, pl in zip(jb.layers, pb.layers):
        for name in ("nbr_local", "mask", "eid"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                          getattr(pl, name).numpy(), name)
        assert int(jl.num_targets) == int(pl.num_targets)


@pytest.mark.parametrize("mode", ["xla", "lanes", "lanes_fused", "pallas"])
def test_bounds_read_matches_jax_clip(csr, mode):
    """A hop's ``indptr`` reads at the seeds and the seeds plus one (one
    paired read of B3 under ``"pallas"``) against JAX's clipped
    ``_gather(indptr, seeds)`` and ``_gather(indptr, seeds + 1)``, with
    seeds at both ends of the padded table and beyond it."""
    from quiver_tpu.ops.sample import _gather as jax_gather

    indptr, indices = csr
    ip, _ = qt.CSRTopo(indptr=indptr, indices=indices).to_device("cpu")
    jip, _ = JaxTopo(indptr=indptr, indices=indices).to_device()
    m = ip.shape[0]
    seeds = np.concatenate([[0, N_NODES - 1, N_NODES, m - 2, m - 1, m,
                             m + 77, -4],
                            np.random.default_rng(3).integers(0, N_NODES,
                                                              200)])
    seeds = seeds.astype(np.int32)
    start, end = psample._gather_bounds(ip, torch.from_numpy(seeds), mode)
    js = jnp.asarray(seeds)
    np.testing.assert_array_equal(start.numpy(), np.asarray(
        jax_gather(jip, js, "xla")))
    np.testing.assert_array_equal(end.numpy(), np.asarray(
        jax_gather(jip, js + 1, "xla")))


def test_resolve_gather_mode(monkeypatch):
    assert config.resolve_gather_mode("auto") == "pwindow"
    for m in ("xla", "lanes", "lanes_fused", "pallas", "pwindow",
              "pwindow:4"):
        assert config.resolve_gather_mode(m) == m
    with config.override(gather_mode="lanes_fused"):
        assert config.resolve_gather_mode("auto") == "lanes_fused"
        assert config.resolve_gather_mode("pallas") == "pallas"
    with config.override(gather_mode="blocked"):
        assert config.resolve_gather_mode("auto") == "blocked"
    assert config.resolve_gather_mode("blocked:2") == "blocked:2"
    for bad in ("pwindow:0", "pwindow4", "blocked:0", "blocked4", "gather",
                3):
        with pytest.raises(ValueError):
            config.resolve_gather_mode(bad)
    topo = qt.CSRTopo(indptr=np.array([0, 1, 2]), indices=np.array([1, 0]))
    assert qt.GraphSageSampler(topo, [2], device="cpu",
                               gather_mode="blocked:2").gather_mode == \
        "blocked:2"

    # the environment knob has JAX's name and default
    assert config.Config().gather_mode == jax_config.Config().gather_mode
    monkeypatch.setenv("QUIVER_TPU_GATHER_MODE", "pallas")
    assert config.Config().gather_mode == "pallas"
    assert jax_config.Config().gather_mode == "pallas"
    with config.override(**{f.name: getattr(config.Config(), f.name)
                            for f in dataclasses.fields(config.Config)}):
        s = qt.GraphSageSampler(topo, [2], device="cpu")
        assert s.gather_mode == "pallas"


def test_gather_needs_a_padded_table():
    t = torch.arange(200, dtype=torch.int32)
    idx = torch.tensor([0, 5, 199, 400, -3], dtype=torch.int32)
    assert psample._gather(t, idx, "xla").tolist() == [0, 5, 199, 199, 0]
    for mode in ("lanes", "lanes_fused", "pallas"):
        with pytest.raises(ValueError, match="128"):
            psample._gather(t, idx, mode)
        padded = qt.ops.fastgather.pad_table_128(t)
        # clipped to the padded table, as JAX clips
        assert psample._gather(padded, idx, mode).tolist() == [
            0, 5, 199, 0, 0]
    with pytest.raises(ValueError):
        psample._gather(t, idx, "pwindow")
