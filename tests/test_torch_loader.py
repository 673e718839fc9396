"""Port parity: ``SeedLoader`` with ``Feature.prefetch``, and the
``Prefetcher`` under it.

Against JAX's ``SeedLoader`` with ``prefetch=0`` and ``prefetch=2`` over a
feature whose budget is below the table: seed order, padding,
``label_mask``, labels and every sampled batch equal for every batch of
two epochs, feature rows bitwise equal, and ``Feature.stats()`` counters
equal to JAX's telemetry (``feature_h2d_bytes_total`` left out: JAX pads
its copies to shape buckets).  The port's batches take the key words JAX
folds from ``make_key((epoch * 1_000_003 + i) & 0x7FFFFFFF)`` through
``key_words_fn``, and sample in ``gather_mode="lanes_fused"``.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.loader import SeedLoader as JaxLoader
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.parallel import AsyncNeighborSampler

N, D, HOT, B = 1500, 16, 400, 384
SIZES = [5, 3]
COUNTED = ("feature_rows_total", "feature_coldcache_", "feature_page_",
           "feature_gather_batches_total", "feature_prefetch_total")


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


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def jax_key_words(epoch, i):
    return hop_words(make_key((epoch * 1_000_003 + i) & 0x7FFFFFFF),
                     len(SIZES))


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, 15_000, seed=6)
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    feat[::13, 3] = -0.0
    labels = rng.integers(0, 7, N).astype(np.int32)
    train = rng.permutation(N)[:1000]  # 3 batches, the last 232 of 384
    return indptr, indices, feat, labels, train


class _FreshBuffers(dict):
    """A staging-buffer map that never hands a buffer out again.  JAX's CPU
    backend may read a reused staging buffer after the next stage has
    rewritten it (the feature's prefetch worker stages batch i+1 while
    batch i is merged), so the reference gets a fresh buffer per stage."""

    def get(self, key, default=None):
        return default


def _counts(d) -> dict:
    return {k: float(v) for k, v in d.items() if k.startswith(COUNTED) and v}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_seed_loader_matches_jax(data, prefetch):
    indptr, indices, feat, labels, train = data
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    ptopo = qt.CSRTopo(indptr=indptr, indices=indices)
    telemetry.reset()
    jf = JaxFeature(device_cache_size=HOT, cache_unit="rows",
                    csr_topo=jtopo).from_cpu_tensor(feat)
    jf._stage_bufs = _FreshBuffers()
    pf = qt.Feature(device_cache_size=HOT, cache_unit="rows", csr_topo=ptopo,
                    device="cpu").from_cpu_tensor(feat)
    assert 0 < pf.cache_count < N
    jl = JaxLoader(train, JaxSampler(jtopo, SIZES, gather_mode="xla",
                                     sample_rng="hash", dedup="none"),
                   jf, labels=labels, batch_size=B, prefetch=prefetch,
                   seed=3)
    pl = qt.SeedLoader(train, qt.GraphSageSampler(
        ptopo, SIZES, device="cpu", gather_mode="lanes_fused"), pf,
        labels=labels, batch_size=B, prefetch=prefetch, seed=3,
        key_words_fn=jax_key_words)
    assert len(pl) == len(jl) == 3
    try:
        for epoch in range(2):
            got = list(pl)
            want = list(jl)
            assert len(got) == len(want) == 3
            for (jb, jx, jlab, jm), (pb, px, plab, pm) in zip(want, got):
                np.testing.assert_array_equal(np.asarray(jb.n_id),
                                              pb.n_id.numpy())
                for a, b in zip(jb.layers, pb.layers):
                    np.testing.assert_array_equal(np.asarray(a.nbr_local),
                                                  b.nbr_local.numpy())
                    np.testing.assert_array_equal(np.asarray(a.mask),
                                                  b.mask.numpy())
                np.testing.assert_array_equal(
                    np.asarray(jx).view(np.int32), px.numpy().view(np.int32))
                np.testing.assert_array_equal(
                    feat[pb.n_id.numpy()].view(np.int32),
                    px.numpy().view(np.int32))
                np.testing.assert_array_equal(np.asarray(jlab), plab.numpy())
                np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
            # the seeds are the frontier's prefix; the tail is padded
            assert int(got[-1][3].sum()) == 1000 - 2 * B
            seen = np.concatenate([b.n_id[:B].numpy()[m.numpy()]
                                   for b, _, _, m in got])
            assert sorted(seen) == sorted(train)
    finally:
        pf.close()
    want = _counts(telemetry.snapshot()["counters"])
    assert want == _counts(pf.stats()["counters"])
    # batches 1 and 2 of each epoch were prefetched one batch ahead
    assert want["feature_prefetch_total{result=hit}"] == 4


def test_prefetch_then_read_keeps_rows(data):
    """Prefetch batch i+1, then read batch i, then i+1: rows bitwise equal
    to the source; the second read claims the staged rows."""
    indptr, indices, feat, _, _ = data
    f = qt.Feature(device_cache_size=HOT, cache_unit="rows",
                   csr_topo=qt.CSRTopo(indptr=indptr, indices=indices),
                   device="cpu").from_cpu_tensor(feat)
    rng = np.random.default_rng(9)
    try:
        for i in range(4):
            cur = rng.integers(0, N, 700).astype(np.int32)
            nxt = torch.from_numpy(rng.integers(0, N, 900).astype(np.int32))
            f.prefetch(nxt)
            assert torch.equal(f[cur], torch.from_numpy(feat[cur]))
            assert torch.equal(f[nxt.numpy()], torch.from_numpy(feat[nxt]))
        c = f.stats()["counters"]
        assert c["feature_prefetch_total{result=hit}"] == 4
        assert c["feature_prefetch_total{result=miss}"] == 4
        with pytest.raises(ValueError):
            f.prefetch(np.array([N]))
            f[np.array([N])]
    finally:
        f.close()
    full = qt.Feature(device_cache_size=feat.nbytes,
                      device="cpu").from_cpu_tensor(feat)
    full.prefetch(np.arange(5))
    assert full._pool is None


def test_prefetcher_raises_and_stops():
    def make(i):
        if i == 3:
            raise KeyError(i)
        return i

    with pytest.raises(KeyError):
        list(qt.Prefetcher(range(6), make, depth=2))
    p = qt.Prefetcher(range(100), lambda i: (time.sleep(0.001), i)[1],
                      depth=2)
    it = iter(p)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer leaves early: the worker is reaped
    assert not p._thread.is_alive()
    before = threading.active_count()
    assert list(qt.Prefetcher(range(5), lambda i: i * i)) == [0, 1, 4, 9, 16]
    assert threading.active_count() <= before


def test_async_sampler_matches_sample_neighbors(data):
    indptr, indices, _, _, _ = data
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    s = AsyncNeighborSampler(topo, 7, device="cpu")
    ip, ix = topo.to_device("cpu")
    seeds = np.arange(0, N, 11)
    got = s.sample(seeds, (5, 6))
    want = qt.sample_neighbors(ip, ix, torch.from_numpy(seeds), 7, (5, 6),
                               device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
