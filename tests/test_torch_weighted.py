"""Port parity: the weighted sampler.  ``row_cumsum_weights``, one
weighted hop in every gather mode, the weighted multi-hop sampler under
both dedup rules, and weighted fused serving, against the JAX package on
the same numpy inputs.

The JAX references run ``gather_mode="xla"`` (``"blocked:U"`` for the
port's blocked hops) with ``sample_rng="hash"``; the port's ``"pallas"``
and ``"lanes_fused"`` run their kernels' plain versions here.  Integer
outputs are bitwise equal; logits agree within ``rtol=atol=1e-5``.
"""

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models.sage import GraphSAGE as JaxSAGE
from quiver_tpu.ops.fastgather import pad_table_128 as jax_pad_table_128
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import row_cumsum_weights as jax_row_cumsum
from quiver_tpu.ops.sample import \
    sample_neighbors_weighted as jax_sample_weighted
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops import sample as port_sample

N = 1500
K = 6
TOL = dict(rtol=1e-5, atol=1e-5)


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def _words(key):
    return tuple(int(np.asarray(w)) for w in _fold_key_words(key))


@pytest.fixture(scope="module")
def world():
    """A skewed graph (degree 0, at most K, and windows far wider than
    three 128-lane rows) with random edge weights, some of them 0."""
    rng = np.random.default_rng(11)
    deg = np.where(rng.random(N) < 0.15, rng.integers(400, 3000, N),
                   rng.integers(0, 2 * K, N))
    deg[:4] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, N, int(indptr[-1])).astype(np.int32)
    w = rng.random(indices.shape[0], dtype=np.float32)
    w[rng.random(w.shape[0]) < 0.05] = 0.0
    return indptr, indices, w


def test_row_cumsum_weights_bitwise(world):
    indptr, _, w = world
    got = port_sample.row_cumsum_weights(indptr, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_row_cumsum(indptr, w))


@pytest.mark.parametrize("mode", ["xla", "lanes", "lanes_fused", "pallas",
                                  "pwindow", "blocked:1", "blocked:2",
                                  "blocked:3"])
def test_weighted_hop_matches_jax(world, mode):
    """Seeds of degree 0, at most K and far above it, a masked tail; the
    port in ``mode`` against JAX's ``"xla"`` (or the same ``blocked:U``)."""
    indptr, indices, w = world
    jip, jix = JaxTopo(indptr=indptr, indices=indices).to_device()
    pip, pix = qt.CSRTopo(indptr=indptr, indices=indices).to_device("cpu")
    cw = jax_row_cumsum(indptr, w)
    jcw = jax_pad_table_128(jnp.asarray(cw), fill=float(cw[-1]))
    pcw = torch.from_numpy(np.array(jcw))
    rng = np.random.default_rng(len(mode))
    seeds = np.concatenate([np.arange(6), rng.integers(0, N, 250)]
                           ).astype(np.int32)
    smask = np.arange(seeds.shape[0]) < 230
    key = make_key(3)
    j = jax_sample_weighted(
        jip, jix, jcw, jnp.asarray(seeds), K, key,
        seed_mask=jnp.asarray(smask), sample_rng="hash",
        gather_mode=mode if mode.startswith("blocked") else "xla")
    p = port_sample.sample_neighbors_weighted(
        pip, pix, pcw, torch.from_numpy(seeds), K, _words(key),
        torch.from_numpy(smask), mode)
    for name in ("nbrs", "mask", "counts", "eid"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    counts = p.counts.numpy()
    assert (counts[~smask] == 0).all() and (counts[:4] == 0).all()
    assert (counts == K).any() and ((counts > 0) & (counts < K)).any()


@pytest.mark.parametrize("dedup,caps,mode", [
    ("none", None, "xla"),
    ("none", None, "pwindow"),
    ("hop", None, "pallas"),
    ("hop", [None, 150, 700], "blocked:3"),
])
def test_weighted_sampler_matches_jax(world, dedup, caps, mode):
    """Three weighted hops; the port's sampler in ``mode`` against JAX's
    ``"xla"`` (``"blocked:3"`` for the blocked case), caps that drop."""
    indptr, indices, w = world
    jmode = mode if mode.startswith("blocked") else "xla"
    js = JaxSampler(JaxTopo(indptr=indptr, indices=indices), [5, 4, 3],
                    gather_mode=jmode, sample_rng="hash", dedup=dedup,
                    frontier_caps=caps, edge_weights=w, return_eid=True)
    ps = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             [5, 4, 3], device="cpu", gather_mode=mode,
                             dedup=dedup, frontier_caps=caps,
                             edge_weights=w, sample_rng="hash",
                             return_eid=True)
    np.testing.assert_array_equal(ps._cum_weights.numpy(),
                                  np.asarray(js._cum_weights))
    seeds = np.random.default_rng(5).integers(0, N, 40)
    key = make_key(21)
    jb = js.sample(seeds, key=key)
    pb = ps.sample(seeds, key_words=hop_words(key, 3))
    np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
    np.testing.assert_array_equal(pb.n_id_mask.numpy(),
                                  np.asarray(jb.n_id_mask))
    assert int(pb.num_nodes) == int(jb.num_nodes)
    for jl, pl in zip(jb.layers, pb.layers):
        for name in ("nbr_local", "mask", "eid"):
            np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                          np.asarray(getattr(jl, name)),
                                          err_msg=name)
        assert int(pl.num_targets) == int(jl.num_targets)
    np.testing.assert_array_equal(ps.overflow_stats(pb),
                                  js.overflow_stats(jb))
    if caps:
        assert ps.overflow_stats(pb)[1] > 0


def test_weighted_fused_serving_matches_jax(world):
    """The fused forward of a weighted ``"hop"`` sampler (padded bucket,
    so duplicate seeds) against JAX's weighted sample and model."""
    indptr, indices, w = world
    feat = np.random.default_rng(4).standard_normal(
        (N, 8)).astype(np.float32)
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    ptopo = qt.CSRTopo(indptr=indptr, indices=indices)
    js = JaxSampler(jtopo, [5, 3], gather_mode="xla", sample_rng="hash",
                    dedup="hop", edge_weights=w)
    ps = qt.GraphSageSampler(ptopo, [5, 3], device="cpu", dedup="hop",
                             edge_weights=w)
    jf = JaxFeature(device_cache_size=feat.nbytes,
                    csr_topo=jtopo).from_cpu_tensor(feat)
    pf = qt.Feature(device_cache_size=feat.nbytes, csr_topo=ptopo,
                    device="cpu").from_cpu_tensor(feat)
    key = make_key(9)
    padded = np.concatenate([np.arange(10, 30), np.full(12, 10)])
    jb = js.sample(padded, key=key)
    model = JaxSAGE(hidden=16, out_dim=5, num_layers=2, dropout=0.0)
    params = model.init(make_key(1), jf.lookup_device(jb.n_id), jb.layers)
    want = np.asarray(model.apply(params, jf.lookup_device(jb.n_id),
                                  jb.layers))
    port = qt.GraphSAGE(8, 16, 5, num_layers=2, device="cpu")
    port.load_state_dict(
        qt.sage_params_from_flax(jax.tree.map(np.asarray, params)))
    server = qt.InferenceServer_Debug(ps, pf, port, queue.Queue())
    assert server._fused
    got = server.fused_forward(padded, hop_words(key, 2)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # uniform draws give other logits: the weights reached the pass
    uniform = qt.GraphSageSampler(ptopo, [5, 3], device="cpu", dedup="hop")
    other = qt.InferenceServer_Debug(uniform, pf, port, queue.Queue())
    assert not np.allclose(
        other.fused_forward(padded, hop_words(key, 2)).numpy(), got)
