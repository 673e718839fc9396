"""Port parity: ``quiver_tpu_torch.dist.sampler`` (``plan_row_shards``,
``shard_csr_by_rows``, ``DistGraphSampler``) against the JAX package's
``tests/test_dist_sampler.py`` cases and JAX's sampler on the same inputs.

JAX runs ``gather_mode="xla", sample_rng="hash"`` on ``conftest.py``'s 8
virtual CPU devices; the port runs its default ``"auto"``, which resolves
to ``"blocked"`` (B3's plain version here), and gets JAX's key words: for
each hop ``key, sub = split(key)``, then ``fold_in(sub, rank)`` folded to
two words.  ``n_id``, masks, counts, blocks and overflow counts must be
bitwise JAX's at 2, 4 and 8 ranks.
"""

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.dist.sampler import DistGraphSampler as JaxDistSampler
from quiver_tpu.dist.sampler import plan_row_shards as jax_plan
from quiver_tpu.dist.sampler import shard_csr_by_rows as jax_shard_csr
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.telemetry import metric_key
from quiver_tpu.utils.mesh import make_mesh as jax_make_mesh
from quiver_tpu.utils.rng import default_impl
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.dist.sampler import (DistGraphSampler, plan_row_shards,
                                           shard_csr_by_rows)
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.resilience.errors import PeerTimeout

CPU = torch.device("cpu")
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries start and end empty, no chaos plan is
    armed; JAX's telemetry returns to its process default."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    pchaos.uninstall()
    yield
    pchaos.uninstall()
    for tel in (ptel, jtel):
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(1)
    n = 200
    deg = rng.poisson(8, n)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, len(src))
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    ei = pairs.T
    return qt.CSRTopo(edge_index=ei), JaxTopo(edge_index=ei)


def jax_words(seed, n_hops, n_ranks):
    """The words JAX's pipeline draws hop ``l`` of rank ``r`` with."""
    key = jax.random.key(seed, impl=default_impl())
    out = np.zeros((n_hops, n_ranks, 2), np.uint32)
    for hop in range(n_hops):
        key, sub = jax.random.split(key)
        for r in range(n_ranks):
            out[hop, r] = [int(np.asarray(w)) for w in
                           _fold_key_words(jax.random.fold_in(sub, r))]
    return out


def both(graph, n, sizes, **kw):
    ptopo, jtopo = graph
    pm = qt.make_mesh(("data",), devices=[CPU] * n)
    jm = jax_make_mesh(("data",), devices=jax.devices()[:n])
    return (DistGraphSampler(ptopo, pm, sizes, **kw),
            JaxDistSampler(jtopo, jm, sizes, gather_mode="xla",
                           sample_rng="hash",
                           **{k: v for k, v in kw.items()
                              if k == "request_cap_frac"}))


def assert_same_sample(got, want):
    for name, a, b in zip(("n_id", "n_mask", "num"), got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert len(got[3]) == len(want[3])
    for i, (pb, jb) in enumerate(zip(got[3], want[3])):
        for f in ("nbr_local", "mask", "num_targets"):
            np.testing.assert_array_equal(
                getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                err_msg=f"block {i} {f}")


def test_shard_csr_by_rows(graph):
    ptopo, jtopo = graph
    rs, lips, lids = shard_csr_by_rows(ptopo, 4)
    jrs, jlips, jlids = jax_shard_csr(jtopo, 4)
    np.testing.assert_array_equal(rs, jrs)
    assert rs[0] == 0 and rs[-1] == ptopo.node_count
    np.testing.assert_array_equal(np.concatenate(lids), ptopo.indices)
    for a, b in zip(lips + lids, jlips + jlids):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dist_sampler_matches_jax(graph, n):
    """Two hops at exact caps: every output bitwise JAX's, seeds the
    frontier prefix, no overflow."""
    sizes = [4, 3]
    ps, js = both(graph, n, sizes)
    assert ps.gather_mode == "blocked"
    seeds = np.random.default_rng(n).integers(0, 200, (n, 16))
    got = ps.sample(seeds, key_words=jax_words(7, len(sizes), n))
    want = js.sample(seeds, key=7)
    assert_same_sample(got, want)
    np.testing.assert_array_equal(got[0].numpy()[:, :16], seeds)
    np.testing.assert_array_equal(ps.overflow_stats(), js.overflow_stats())
    assert ps.overflow_stats().sum() == 0
    np.testing.assert_array_equal(ps.indptr_sh, np.asarray(js.indptr_sh))
    np.testing.assert_array_equal(ps.indices_sh, np.asarray(js.indices_sh))


def test_dist_sampler_counts_match_single(graph):
    """Per-seed counts equal min(deg, k) at exact caps."""
    ptopo, _ = graph
    ps, _ = both(graph, 8, [5])
    seeds = np.tile(np.arange(8)[None], (8, 1))
    _, _, _, blocks = ps.sample(seeds, key=3)
    counts = blocks[0].mask.numpy().sum(axis=2)
    for d in range(8):
        np.testing.assert_array_equal(counts[d],
                                      np.minimum(ptopo.degree[:8], 5))


def test_dist_sampler_cap_overflow_drops(graph):
    """With a tiny request cap overflowed seeds sample nothing: drops and
    outputs equal JAX's, and the overflow counter ticks as JAX's."""
    ptopo, _ = graph
    ps, js = both(graph, 8, [4], request_cap_frac=0.01)
    seeds = np.zeros((8, 32), dtype=np.int64)  # one owner: pressure
    got = ps.sample(seeds, key_words=jax_words(1, 1, 8))
    want = js.sample(seeds, key=1)
    assert_same_sample(got, want)
    ov = ps.overflow_stats()
    np.testing.assert_array_equal(ov, js.overflow_stats())
    assert ov.sum() > 0
    assert ptel.snapshot()["counters"].get(
        metric_key("dist_sampler_overflow_total", {})) == \
        jtel.snapshot()["counters"].get(
            metric_key("dist_sampler_overflow_total", {}))
    counts = got[3][0].mask.numpy().sum(axis=2)
    assert set(np.unique(counts)) <= {0, min(int(ptopo.degree[0]), 4)}


def test_dist_sampler_edges_real_and_deterministic(graph):
    ptopo, _ = graph
    ps, _ = both(graph, 8, [4, 3])
    seeds = np.random.default_rng(1).integers(0, 200, (8, 8))
    a = ps.sample(seeds, key=11)
    b = ps.sample(seeds, key=11)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    n_id = a[0].numpy()
    blk = a[3][-1]  # innermost hop: targets are the seeds
    local, m = blk.nbr_local.numpy(), blk.mask.numpy()
    for d in range(8):
        for t in range(8):
            row = set(ptopo.indices[ptopo.indptr[seeds[d, t]]:
                                    ptopo.indptr[seeds[d, t] + 1]].tolist())
            for j in range(local.shape[-1]):
                if m[d, t, j]:
                    assert n_id[d, local[d, t, j]] in row


# -- the >2^31-edge regime: planned from indptr alone ------------------------
def _big_indptr(n_nodes=1024, deg=4_300_000):
    indptr = np.arange(n_nodes + 1, dtype=np.int64) * deg
    assert indptr[-1] > 2**31
    return indptr


def test_plan_row_shards_raises_on_int32_overflow():
    with pytest.raises(ValueError, match="shard"):
        plan_row_shards(_big_indptr(), 2)
    with pytest.raises(ValueError):
        plan_row_shards(_big_indptr(), 0)


def test_plan_row_shards_big_graph_offsets():
    indptr = _big_indptr()
    rs = plan_row_shards(indptr, 4)
    np.testing.assert_array_equal(rs, jax_plan(indptr, 4))
    assert rs[0] == 0 and rs[-1] == len(indptr) - 1
    assert np.all(np.diff(rs) > 0)
    for s in range(4):
        assert int(indptr[rs[s + 1]] - indptr[rs[s]]) < 2**31


def test_dist_sampler_padded_indptr_is_monotone(graph):
    ps, js = both(graph, 8, [3])
    for row in ps.indptr_sh:
        assert np.all(np.diff(row.astype(np.int64)) >= 0)
    assert ps.indptr_sh.shape[1] % 128 == 0


def test_dist_sampler_degrades_pwindow_to_blocked(graph):
    """JAX's resolution of the fused window modes for the per-shard hop:
    ``pwindow:U`` reads as ``blocked:U``, and draws what ``xla`` draws."""
    ptopo, _ = graph
    pm = qt.make_mesh(("data",), devices=[CPU] * 8)
    s = DistGraphSampler(ptopo, pm, [3], gather_mode="pwindow:2",
                         sample_rng="hash")
    assert s.gather_mode == "blocked:2"
    seeds = np.arange(16).reshape(8, 2) % ptopo.node_count
    kw = jax_words(5, 1, 8)
    got = s.sample(seeds, key_words=kw)
    ref = DistGraphSampler(ptopo, pm, [3], gather_mode="xla").sample(
        seeds, key_words=kw)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    assert got[0].shape[0] == 8


def test_dist_sampler_degrades_all_pallas_modes(graph):
    ptopo, _ = graph
    pm = qt.make_mesh(("data",), devices=[CPU] * 8)
    for gm, want in (("pallas", "lanes"), ("lanes_fused", "lanes"),
                     ("auto", "blocked")):
        s = DistGraphSampler(ptopo, pm, [3], gather_mode=gm)
        assert s.gather_mode == want, (gm, s.gather_mode)
    # "key" is accepted and resolves as JAX resolves it: the auto mode
    # lands on "blocked", which the per-shard hop runs as it is
    s = DistGraphSampler(ptopo, pm, [3], sample_rng="key")
    assert (s.gather_mode, s.sample_rng) == ("blocked", "key")
    s = DistGraphSampler(ptopo, pm, [3], gather_mode="pallas",
                         sample_rng="key")
    assert (s.gather_mode, s.sample_rng) == ("lanes", "key")


def test_exchange_retries_a_peer_timeout_once(graph):
    """A transient peer timeout is retried once after the seeded backoff
    (``dist_sampler_retries_total``); a second one reaches the caller."""
    ps, _ = both(graph, 4, [3])
    seeds = np.arange(16).reshape(4, 4)
    want = ps.sample(seeds, key=2)
    with pchaos.active(pchaos.ChaosPlan(0).fail(
            "dist.sampler.exchange", exc=PeerTimeout("t"), times=1)):
        got = ps.sample(seeds, key=2)
    assert torch.equal(got[0], want[0])
    assert ptel.snapshot()["counters"].get(
        metric_key("dist_sampler_retries_total", {})) == 1
    with pchaos.active(pchaos.ChaosPlan(0).fail(
            "dist.sampler.exchange", exc=PeerTimeout("t"), times=2)):
        with pytest.raises(PeerTimeout):
            ps.sample(seeds, key=2)
