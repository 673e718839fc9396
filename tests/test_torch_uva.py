"""Port parity: the UVA hot/cold split (``quiver_tpu_torch/uva.py``) and
``GraphSageSampler(mode="UVA")``.

For budgets ``None`` (the device mode), ``0`` (every row cold) and
``E * 4 // 3`` (a third of the edges hot): ``UVAGraph``'s stats, hot mask
and padded hot tables, and every sampled batch, are bitwise equal to the
JAX package's.  The port takes the words JAX folds from each hop's split
key (``_fold_key_words``) for the device tier and the last word of each
split key (``key_data(keys)[:, -1]``) for the host tier.  ``overlap=False``
gives the same batch as ``overlap=True``, and the ``uva_seeds_total``
counts equal JAX's telemetry.
"""

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo
from quiver_tpu.uva import UVAGraph as JaxUVAGraph

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel

N = 600  # n + 1 = 601: the last 89 ids lie past a 128 boundary
SIZES = [4, 3]

_JAX_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _jax_telemetry_on():
    """The JAX counters compared here need JAX telemetry on; a file run
    earlier on the same worker may have left it off.  The registry is
    emptied and the switch restored after each test; the port's registry,
    the one source of the port's counters, likewise."""
    telemetry.set_enabled(True)
    telemetry.reset()
    on = ptel.enabled()
    ptel.set_enabled(True)
    ptel.reset()
    yield
    ptel.reset()
    ptel.set_enabled(on)
    telemetry.reset()
    telemetry.set_enabled(_JAX_TELEMETRY_DEFAULT)


@pytest.fixture(scope="module")
def graph():
    indptr, indices = qt.synthetic_csr(N, 7_000, seed=21)
    return indptr, indices, int(indptr[-1])


def uva_words(key, n_hops):
    """The port's device words and host seeds for JAX's ``key``."""
    keys = jax.random.split(key, n_hops)
    words = np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                      for k in keys], np.uint32)
    return words, np.asarray(jax.random.key_data(keys))[:, -1]


def _same_batch(pb, jb):
    np.testing.assert_array_equal(pb.n_id.numpy(), np.asarray(jb.n_id))
    np.testing.assert_array_equal(pb.n_id_mask.numpy(),
                                  np.asarray(jb.n_id_mask))
    assert int(pb.num_nodes) == int(jb.num_nodes)
    assert pb.batch_size == jb.batch_size
    assert len(pb.layers) == len(jb.layers)
    for p, j in zip(pb.layers, jb.layers):
        np.testing.assert_array_equal(p.nbr_local.numpy(),
                                      np.asarray(j.nbr_local))
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
        assert int(p.num_targets) == int(j.num_targets)


def _budgets(e):
    return [None, 0, e * 4 // 3]


@pytest.mark.parametrize("which", ["none", "zero", "third"])
def test_uva_graph_matches_jax(graph, which):
    indptr, indices, e = graph
    budget = dict(zip(("none", "zero", "third"), _budgets(e)))[which]
    jg = JaxUVAGraph(JaxTopo(indptr=indptr, indices=indices), budget)
    pg = qt.UVAGraph(qt.CSRTopo(indptr=indptr, indices=indices), budget,
                     device="cpu")
    assert pg.stats() == jg.stats()
    np.testing.assert_array_equal(pg.is_hot, jg.is_hot)
    np.testing.assert_array_equal(pg.indptr_dev.numpy(),
                                  np.asarray(jg.indptr_dev))
    np.testing.assert_array_equal(pg.indices_dev.numpy(),
                                  np.asarray(jg.indices_dev))
    assert pg.indptr_dev.shape[0] % 128 == 0
    assert pg.indices_dev.shape[0] % 128 == 0 and pg.indices_dev.numel()


@pytest.mark.parametrize("which", ["none", "zero", "third"])
def test_uva_sample_matches_jax(graph, which):
    """Three calls per budget, each bitwise equal to JAX's, both overlap
    settings equal; the seed counters equal JAX's telemetry and the host
    tier's time is recorded."""
    indptr, indices, e = graph
    budget = dict(zip(("none", "zero", "third"), _budgets(e)))[which]
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    js = JaxSampler(jt, SIZES, mode="UVA", uva_budget=budget,
                    gather_mode="xla", sample_rng="hash")
    timings = {}
    ps = qt.GraphSageSampler(pt, SIZES, mode="UVA", uva_budget=budget,
                             device="cpu", uva_timings=timings)
    serial = qt.GraphSageSampler(pt, SIZES, mode="UVA", uva_budget=budget,
                                 device="cpu", uva_overlap=False)
    assert ps.mode == ("GPU" if budget is None else "UVA")
    assert ps.mode == {"TPU": "GPU", "UVA": "UVA"}[js.mode]
    rng = np.random.default_rng(6)
    for i in range(3):
        seeds = np.concatenate([rng.integers(0, N, 30),
                                np.arange(N - 40, N)])
        key = make_key(100 + i)
        jb = js.sample(seeds, key=key)
        words, host = uva_words(key, len(SIZES))
        if budget is None:
            pb = ps.sample(seeds, key_words=words)
        else:
            pb = ps.sample(seeds, key_words=words, host_seeds=host)
            _same_batch(serial.sample(seeds, key_words=np.column_stack(
                [words, host]).astype(np.uint32)), jb)
        _same_batch(pb, jb)
    if budget is not None:
        want = {k: v for k, v in telemetry.snapshot()["counters"].items()
                if k.startswith("uva_seeds_total")}
        got = {k: v for k, v in ptel.snapshot()["counters"].items()
               if k.startswith("uva_seeds_total")}
        # two port samplers (overlap on and off) drew what JAX's one did
        assert got == {k: 2 * want.get(k, 0.0) for k in got}
        assert got["uva_seeds_total{tier=cold}"] > 0
        assert timings["host_s"] > 0
        # both UVA samplers (overlap on and off) time their host tier
        assert sum(ptel.snapshot()["histograms"]["uva_host_tier_seconds"][
            "counts"]) == 2 * 3 * len(SIZES)


def test_uva_draws_its_own_words_reproducibly(graph):
    """Without words the sampler draws ``[L, 3]`` from its generator: two
    samplers with one seed give one batch; the hot rows of hop 1 equal the
    device mode's for the same folded words."""
    indptr, indices, e = graph
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    a, b = (qt.GraphSageSampler(pt, SIZES, mode="UVA", uva_budget=e * 4 // 3,
                                device="cpu", seed=4) for _ in range(2))
    seeds = np.arange(0, N, 9)
    kw = a.draw_key_words()
    assert kw.shape == (len(SIZES), 3) and kw.dtype == np.uint32
    bb = b.sample(seeds)  # b's first draw: the words a drew
    ba = a.sample(seeds, key_words=kw)
    for x, y in zip((ba.n_id, ba.n_id_mask, ba.num_nodes),
                    (bb.n_id, bb.n_id_mask, bb.num_nodes)):
        assert torch.equal(x, y)
    for la, lb in zip(ba.layers, bb.layers):
        assert all(torch.equal(x, y) for x, y in zip(la[:3], lb[:3]))
    dev = qt.GraphSageSampler(pt, SIZES[:1], device="cpu", gather_mode="xla")
    d = dev.sample(seeds, key_words=kw[:1, :2])
    hot = a._uva.is_hot[seeds]
    hop1 = bb.layers[-1]
    np.testing.assert_array_equal(hop1.mask.numpy()[hot],
                                  d.layers[-1].mask.numpy()[hot])
    np.testing.assert_array_equal(
        bb.n_id.numpy()[hop1.nbr_local.numpy()][hot],
        d.n_id.numpy()[d.layers[-1].nbr_local.numpy()][hot])
    with pytest.raises(ValueError, match="host_seeds"):
        a.sample(seeds, key_words=kw[:, :2])


def test_uva_rejects_dedup_and_weights(graph):
    """The arguments JAX's UVA mode refuses (``test_uva.py::
    test_uva_rejects_dedup_and_weights`` and the asserts beside it) are
    refused here too; ``dedup="auto"`` resolves to ``"none"``."""
    indptr, indices, e = graph
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    w = np.ones(e, np.float32)
    for kw in (dict(dedup="hop"), dict(edge_weights=w),
               dict(return_eid=True)):
        with pytest.raises(AssertionError):
            JaxSampler(jt, [4], mode="UVA", uva_budget=10, **kw)
        with pytest.raises(ValueError, match="UVA"):
            qt.GraphSageSampler(pt, [4], mode="UVA", uva_budget=10,
                                device="cpu", **kw)
    assert qt.GraphSageSampler(pt, [4], mode="UVA", uva_budget=10,
                               device="cpu").dedup == "none"


def test_uva_lanes_gather_covers_tail_nodes():
    """The hot tables' 128 padding: every node of an all-hot graph whose
    ``n + 1`` is not a multiple of 128, sampled under ``"lanes"`` (which
    reads whole 128-wide rows), keeps ``min(deg, k)`` true neighbours."""
    rng = np.random.default_rng(7)
    n = 300
    deg = rng.integers(1, 6, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, indptr[-1])
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    s = qt.GraphSageSampler(topo, [4], mode="UVA", device="cpu",
                            uva_budget=topo.edge_count * 4,
                            gather_mode="lanes")
    tail = np.arange(256, n)
    b = s.sample(tail)
    assert s._uva.stats()["cold_edges"] == 0
    blk = b.layers[-1]
    m = blk.mask.numpy()
    np.testing.assert_array_equal(m.sum(1), np.minimum(deg[tail], 4))
    got = b.n_id.numpy()[blk.nbr_local.numpy()]
    for i, v in enumerate(tail):
        assert set(got[i][m[i]]) <= set(indices[indptr[v]: indptr[v + 1]])
