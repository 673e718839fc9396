"""Port parity: PyG/DGL interop (``quiver_tpu_torch/interop.py``) and the
process hand-off (``quiver_tpu_torch/multiprocessing``).

``to_torch_adjs``, ``block_specs`` and ``TorchSampleLoader`` batches (the
same shuffle seed, the port handed the words JAX folds from each batch's
key) are bitwise equal to the JAX package's; the port's tensors stay on
the batch's device.  A ``ForkingPickler`` round trip of a feature and of a
sampler in each mode gives the same rows and the same draws.
"""

import io
import pickle
from multiprocessing.reduction import ForkingPickler

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.interop import TorchSampleLoader as JaxLoader
from quiver_tpu.interop import block_specs as jax_block_specs
from quiver_tpu.interop import to_torch_adjs as jax_to_torch_adjs
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import interop

N, D, SIZES = 700, 8, [5, 3]


@pytest.fixture(autouse=True)
def _jax_registry_emptied():
    """The JAX calls here record metrics in the JAX package's registry when
    its telemetry is on; each test empties the registry after it, so no
    metric recorded here (or left by an earlier file) reaches a later file
    on the same worker (ROADMAP "Open items")."""
    yield
    telemetry.reset()


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


@pytest.fixture(scope="module")
def world():
    indptr, indices = qt.synthetic_csr(N, 8_000, seed=17)
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, 5, N).astype(np.int64)
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    return dict(
        indptr=indptr, indices=indices, feat=feat, labels=labels, pt=pt,
        js=JaxSampler(jt, SIZES, gather_mode="xla", sample_rng="hash",
                      dedup="none", return_eid=True),
        ps=qt.GraphSageSampler(pt, SIZES, device="cpu", return_eid=True),
        jf=JaxFeature(device_cache_size=feat.nbytes,
                      csr_topo=jt).from_cpu_tensor(feat),
        pf=qt.Feature(device_cache_size=feat.nbytes, csr_topo=pt,
                      device="cpu").from_cpu_tensor(feat))


def _same_adjs(got, want):
    n_id, bs, adjs = got
    jn_id, jbs, jadjs = want
    assert bs == jbs and n_id.dtype == torch.int64
    np.testing.assert_array_equal(n_id.numpy(), jn_id.numpy())
    assert len(adjs) == len(jadjs)
    for (ei, eid, size), (jei, jeid, jsize) in zip(adjs, jadjs):
        assert ei.dtype == eid.dtype == torch.int64 and size == jsize
        np.testing.assert_array_equal(ei.numpy(), jei.numpy())
        np.testing.assert_array_equal(eid.numpy(), jeid.numpy())


@pytest.mark.parametrize("eid", [True, False])
def test_to_torch_adjs_and_block_specs_match_jax(world, eid):
    seeds = np.random.default_rng(1).integers(0, N, 40)
    key = make_key(31)
    js, ps = world["js"], world["ps"]
    jb = js.sample(seeds, key=key)
    pb = ps.sample(seeds, key_words=hop_words(key, 2))
    if not eid:
        pb = pb._replace(layers=tuple(l._replace(eid=None)
                                      for l in pb.layers))
        jb = jb._replace(layers=tuple(l._replace(eid=None)
                                      for l in jb.layers))
    _same_adjs(qt.to_torch_adjs(pb), jax_to_torch_adjs(jb))
    got, want = interop.block_specs(pb), jax_block_specs(jb)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class _KeyedSampler:
    """JAX's sampler with batch ``i`` keyed ``make_key(1000 + i)``."""

    def __init__(self, sampler):
        self.sampler, self.i = sampler, 0

    def sample(self, seeds):
        self.i += 1
        return self.sampler.sample(seeds, key=make_key(1000 + self.i - 1))


def test_torch_sample_loader_matches_jax(world):
    train = np.random.default_rng(5).permutation(N)[:300]
    jl = JaxLoader(train, _KeyedSampler(world["js"]), world["jf"],
                   labels=world["labels"], batch_size=128, seed=9)
    pl = qt.TorchSampleLoader(
        train, world["ps"], world["pf"], labels=world["labels"],
        batch_size=128, seed=9,
        key_words_fn=lambda i: hop_words(make_key(1000 + i), 2))
    assert len(pl) == len(jl) == 3
    got, want = list(pl), list(jl)
    assert len(got) == len(want) == 3
    for (n_id, bs, adjs, x, y), (jn, jbs, jadjs, jx, jy) in zip(got, want):
        _same_adjs((n_id, bs, adjs), (jn, jbs, jadjs))
        np.testing.assert_array_equal(x.numpy(), jx.numpy())
        np.testing.assert_array_equal(x.numpy(), world["feat"][n_id.numpy()])
        np.testing.assert_array_equal(y.numpy(), jy.numpy())


def test_to_torch_and_dgl():
    t = torch.arange(4)
    assert interop.to_torch(t) is t
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = interop.to_torch(a)
    b[0, 0] = 9
    assert a[0, 0] == 9  # shares the host memory
    try:
        import dgl  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            interop.to_dgl_blocks(None)


def _round_trip(obj):
    buf = io.BytesIO()
    ForkingPickler(buf).dump(obj)
    return pickle.loads(buf.getvalue())


@pytest.mark.parametrize("budget", ["full", "budgeted"])
def test_feature_round_trip(world, budget):
    import quiver_tpu_torch.multiprocessing  # noqa: F401  (registers)

    feat = world["feat"]
    size = feat.nbytes if budget == "full" else 200
    f = qt.Feature(device_cache_size=size, cache_unit="bytes"
                   if budget == "full" else "rows",
                   csr_topo=qt.CSRTopo(indptr=world["indptr"],
                                       indices=world["indices"]),
                   device="cpu").from_cpu_tensor(feat)
    g = _round_trip(f)
    assert g is not f and g._lazy_state is not None and g.hot is None
    ids = np.random.default_rng(4).integers(0, N, 90)
    np.testing.assert_array_equal(g[ids].numpy(), f[ids].numpy())
    np.testing.assert_array_equal(g[ids].numpy(), feat[ids])
    assert g._lazy_state is None and g.device == f.device
    assert (g.cache_count, g.node_count, g.dim) == (
        f.cache_count, f.node_count, f.dim)
    h = qt.Feature.new_from_ipc_handle(3, f.share_ipc())
    assert h.rank == 3
    np.testing.assert_array_equal(h[ids].numpy(), feat[ids])


@pytest.mark.parametrize("mode", ["GPU", "CPU", "UVA"])
def test_sampler_round_trip(world, mode):
    import quiver_tpu_torch.multiprocessing  # noqa: F401  (registers)

    kw = dict(uva_budget=4_000) if mode == "UVA" else {}
    s = qt.GraphSageSampler(world["pt"], SIZES, device="cpu", mode=mode,
                            seed=7, **kw)
    r = _round_trip(s)
    assert r is not s and r.mode == s.mode and r.device == s.device
    assert r.csr_topo._device_arrays == {} or mode == "GPU"
    seeds = np.arange(0, N, 13)
    for _ in range(2):  # own words (the same seed), then one more call
        a, b = s.sample(seeds), r.sample(seeds)
        assert torch.equal(a.n_id, b.n_id)
        assert torch.equal(a.n_id_mask, b.n_id_mask)
        for la, lb in zip(a.layers, b.layers):
            assert torch.equal(la.nbr_local, lb.nbr_local)
            assert torch.equal(la.mask, lb.mask)
