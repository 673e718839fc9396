"""Port parity: the streaming overlay hop and pipeline
(``quiver_tpu_torch.ops.sample.sample_neighbors_overlay``, the sampler's
overlay pipeline) against the JAX package's ``sample_neighbors_overlay``
and ``_sample_pipeline_overlay`` on the same numpy graphs and mutations.

Every comparison is bitwise (``nbrs``, ``mask``, ``counts``, ``eid``, the
frontier and the blocks): with zero deltas and no tombstones, with deltas
and tombstones, and with time windows on base and delta edges.  JAX runs
``gather_mode="xla", sample_rng="hash"``; the port's gather modes all run
their plain versions here, and are held equal to its ``"xla"`` draws.  No
interpret-mode Pallas call is made.
"""

import jax
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_hop
from quiver_tpu.ops.sample import sample_neighbors_overlay as jax_overlay
from quiver_tpu.resilience import chaos as jchaos
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.stream import StreamingGraph as JaxGraph
from quiver_tpu.telemetry import flightrec as jflightrec
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.ops import sample as psample
from quiver_tpu_torch.ops.cuda import element_gather as b3
from quiver_tpu_torch.resilience import chaos as pchaos
from quiver_tpu_torch.sampler import run_pipeline
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.telemetry import flightrec as pflightrec

N, E = 300, 2000
MODES = ["pwindow", "pallas", "blocked:3", "lanes", "lanes_fused"]
_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, chaos plans and flight recorders (the
    graphs register a version provider) start and end empty."""
    for tel, chaos, rec in ((ptel, pchaos, pflightrec),
                            (jtel, jchaos, jflightrec)):
        tel.set_enabled(True)
        tel.reset()
        chaos.uninstall()
        rec.reset()
    yield
    for tel, chaos, rec in ((ptel, pchaos, pflightrec),
                            (jtel, jchaos, jflightrec)):
        chaos.uninstall()
        rec.set_version_provider(None)
        rec.reset()
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _edges(seed, n=N, e=E):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei[:, -1] = n - 1  # pins the node count at n
    ts = rng.integers(0, 100, e)
    return ei, ts


def _graphs(seed, with_ts=True, mutate=True, n=N, e=E):
    """The same StreamingGraph in both packages, with ``mutate``: 60
    inserts (some onto one hub row), a third of the first 40 base edges
    and 5 of the inserts deleted."""
    ei, ts = _edges(seed, n, e)
    jt, pt = JaxTopo(edge_index=ei), qt.CSRTopo(edge_index=ei)
    ets = np.random.default_rng(seed + 1).integers(0, 100, jt.edge_count)
    jg = JaxGraph(jt, edge_ts=ets if with_ts else None)
    pg = StreamingGraph(pt, edge_ts=ets if with_ts else None, device="cpu")
    if mutate:
        rng = np.random.default_rng(seed + 2)
        src = np.concatenate([rng.integers(0, n, 50), np.full(10, 7)])
        dst = rng.integers(0, n, 60)
        dts = rng.integers(0, 100, 60)
        u = np.repeat(np.arange(n), jt.degree)[:40:3]
        v = jt.indices[:40:3]
        for g in (jg, pg):
            g.add_edges(src, dst, ts=dts if with_ts else None)
            assert g.remove_edges(u, v) == len(u)
            g.remove_edges(src[:5], dst[:5])
    return jg, pg


def _words(key):
    return tuple(int(np.asarray(w)) for w in _fold_key_words(key))


def _hop_words(key, n_hops):
    return np.array([_words(k) for k in jax.random.split(key, n_hops)],
                    np.uint32)


def _snap_args(snap):
    return (snap.indptr, snap.indices, snap.tomb, snap.d_indptr,
            snap.d_indices)


def _seeds(seed, b=48, n=N):
    s = np.random.default_rng(seed).integers(0, n, b)
    s[:4] = 7  # the row that holds ten inserts
    return s


def _assert_out_equal(jo, po):
    np.testing.assert_array_equal(np.asarray(jo.nbrs), po.nbrs.numpy())
    np.testing.assert_array_equal(np.asarray(jo.mask), po.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jo.counts), po.counts.numpy())
    np.testing.assert_array_equal(np.asarray(jo.eid), po.eid.numpy())


def _jax_hop(jg, seeds, k, key, window=None, seed_mask=None):
    js = jg.snapshot()
    w = {}
    if window is not None:
        w = dict(base_ts=js.base_ts, d_ts=js.d_ts, windowed=True,
                 window_lo=np.int32(window[0]), window_hi=np.int32(window[1]))
    return jax_overlay(js.indptr, js.indices, js.tomb, js.d_indptr,
                       js.d_indices, np.asarray(seeds, np.int32), k, key,
                       seed_mask=seed_mask, gather_mode="xla",
                       sample_rng="hash", **w)


def _port_hop(pg, seeds, k, key, window=None, mode="xla", seed_mask=None):
    ps = pg.snapshot("cpu")
    return psample.sample_neighbors_overlay(
        *_snap_args(ps), torch.as_tensor(np.asarray(seeds, np.int32)), k,
        *_words(key), seed_mask, ps.base_ts, ps.d_ts, window, mode)


# -- one hop ----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["xla"] + MODES)
def test_zero_delta_hop_is_the_frozen_hop(mode):
    """No deltas, no tombstones: the overlay hop's draws are the frozen
    hop's (the port's ``sample_hop`` in the same mode, and JAX's frozen
    ``sample_neighbors``), bit for bit."""
    jg, pg = _graphs(3, mutate=False)
    seeds = _seeds(3)
    mask = torch.from_numpy(np.arange(len(seeds)) % 5 != 0)
    for s in range(2):
        key = make_key(s)
        got = _port_hop(pg, seeds, 6, key, mode=mode, seed_mask=mask)
        ps = pg.snapshot("cpu")
        frozen = psample.sample_hop(
            ps.indptr, ps.indices, torch.as_tensor(seeds.astype(np.int32)),
            6, *_words(key), mask, "xla")
        for a, b in zip(got, frozen):
            assert torch.equal(a, b)
        js = jg.snapshot()
        want = jax_hop(js.indptr, js.indices, seeds.astype(np.int32), 6,
                       key, seed_mask=mask.numpy(), gather_mode="xla",
                       sample_rng="hash")
        _assert_out_equal(want, got)


@pytest.mark.parametrize("windowed", [False, True])
def test_hop_with_deltas_and_tombstones_matches_jax(windowed):
    jg, pg = _graphs(5)
    seeds = _seeds(5)
    window = (20, 75) if windowed else None
    for s in range(3):
        key = make_key(10 + s)
        jo = _jax_hop(jg, seeds, 5, key, window)
        po = _port_hop(pg, seeds, 5, key, window)
        _assert_out_equal(jo, po)
    # rejection, not resampling: a tombstoned (or out-of-window) draw
    # lowers a seed's count below min(deg, k)
    ps = pg.snapshot("cpu")
    ip, dip = ps.indptr.numpy(), ps.d_indptr.numpy()
    deg = ip[seeds + 1] - ip[seeds] + dip[seeds + 1] - dip[seeds]
    counts = po.counts.numpy()
    assert (counts <= np.minimum(deg, 5)).all()
    assert (counts < np.minimum(deg, 5)).any()


@pytest.mark.parametrize("mode", MODES)
def test_hop_gather_modes_agree(mode):
    """Every gather mode (their plain versions here) draws the ``"xla"``
    hop's values with deltas, tombstones and a window."""
    _, pg = _graphs(6)
    seeds = _seeds(6)
    key = make_key(3)
    want = _port_hop(pg, seeds, 5, key, (10, 90), "xla")
    got = _port_hop(pg, seeds, 5, key, (10, 90), mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_window_applies_to_base_and_delta_edges():
    """A window keeps exactly the draws whose base or delta timestamp is
    in ``[lo, hi)``; JAX agrees on both segments."""
    jg, pg = _graphs(8)
    seeds = _seeds(8)
    key = make_key(4)
    full = _port_hop(pg, seeds, 8, key)
    win = _port_hop(pg, seeds, 8, key, (30, 60))
    _assert_out_equal(_jax_hop(jg, seeds, 8, key, (30, 60)), win)
    ps = pg.snapshot("cpu")
    epad = ps.epad
    eid = full.eid.numpy()
    ts = np.where(eid < epad, ps.base_ts.numpy()[np.clip(eid, 0, epad - 1)],
                  ps.d_ts.numpy()[np.clip(eid - epad, 0,
                                          ps.delta_bucket - 1)])
    keep = full.mask.numpy() & (ts >= 30) & (ts < 60)
    np.testing.assert_array_equal(win.mask.numpy(), keep)
    assert (keep & (eid >= epad)).any() and (keep & (eid < epad)).any()
    assert (full.mask.numpy() & ~keep & (eid >= epad)).any()


def test_delta_eid_is_epad_plus_position():
    """A delta draw's edge id is the padded base length plus its place in
    the delta CSR, and names the drawn neighbour there."""
    _, pg = _graphs(9)
    ps = pg.snapshot("cpu")
    seeds = np.full(16, 7)
    out = _port_hop(pg, seeds, 25, make_key(1))
    eid, nbrs, m = out.eid.numpy(), out.nbrs.numpy(), out.mask.numpy()
    delta = m & (eid >= ps.epad)
    assert delta.any()
    assert ps.epad == -(-pg.base.edge_count // 128) * 128
    np.testing.assert_array_equal(
        ps.d_indices.numpy()[eid[delta] - ps.epad], nbrs[delta])
    base = m & (eid < ps.epad)
    np.testing.assert_array_equal(ps.indices.numpy()[eid[base]], nbrs[base])
    assert not ps.tomb.numpy()[eid[base]].any()


@pytest.mark.parametrize("n_edges", [5, 128, 129])
def test_epad_and_snapshot_tables_match_jax(n_edges):
    """The padded base length (the delta edge-id offset) and every
    snapshot table equal JAX's, at the 128 floor and either side of a
    multiple of 128."""
    jg, pg = _graphs(11, n=40, e=n_edges)
    js, ps = jg.snapshot(), pg.snapshot("cpu")
    assert (ps.epad, ps.delta_bucket, ps.pending, ps.version) == (
        js.epad, js.delta_bucket, js.pending, js.version)
    for name in ("indptr", "indices", "tomb", "d_indptr", "d_indices",
                 "base_ts", "d_ts"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
        assert getattr(ps, name).dtype == torch.int32
        assert getattr(ps, name).shape[0] % 128 == 0


@pytest.mark.parametrize("windowed", [False, True])
def test_overlay_reads_through_b3(monkeypatch, windowed):
    """Under ``"pwindow"`` a hop reads through kernel B3's entries only:
    two pair reads (base and delta bounds) and three element reads
    (``indices``, ``d_indices``, ``tomb``), two more with a window."""
    _, pg = _graphs(12)
    calls = {"element_gather": 0, "element_gather_pair": 0}
    for name in calls:
        real = getattr(b3, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(b3, name, counted)
    _port_hop(pg, _seeds(12), 5, make_key(2), (0, 50) if windowed else None,
              "pwindow")
    assert calls == {"element_gather": 5 if windowed else 3,
                     "element_gather_pair": 2}


# -- the pipeline -----------------------------------------------------------
def _samplers(jg, pg, sizes):
    js = JaxSampler(jg, sizes=sizes, gather_mode="xla", sample_rng="hash",
                    return_eid=True)
    ps = qt.GraphSageSampler(pg, sizes, device="cpu", gather_mode="xla",
                             return_eid=True)
    return js, ps


def _assert_batches_equal(jb, pb):
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    np.testing.assert_array_equal(np.asarray(jb.n_id_mask),
                                  pb.n_id_mask.numpy())
    assert int(jb.num_nodes) == int(pb.num_nodes)
    assert len(jb.layers) == len(pb.layers)
    for la, lb in zip(jb.layers, pb.layers):
        for f in ("nbr_local", "mask", "eid"):
            np.testing.assert_array_equal(np.asarray(getattr(la, f)),
                                          getattr(lb, f).numpy(), err_msg=f)
        assert int(la.num_targets) == int(lb.num_targets)
    assert jb.version == pb.version


@pytest.mark.parametrize("case", ["zero", "deltas", "windowed"])
def test_pipeline_matches_jax(case):
    jg, pg = _graphs(13, mutate=case != "zero")
    js, ps = _samplers(jg, pg, [5, 3])
    seeds = _seeds(13, b=16)
    window = (25, 80) if case == "windowed" else None
    for s in range(3):
        key = make_key(s)
        _assert_batches_equal(
            js.sample(seeds, key=key, time_window=window),
            ps.sample(seeds, key_words=_hop_words(key, 2),
                      time_window=window))


def test_zero_delta_pipeline_is_the_frozen_pipeline():
    """The overlay pipeline with an empty overlay equals the port's frozen
    positional pipeline on the base, under ``"pwindow"`` (B1's plain
    version) as under ``"xla"``."""
    _, pg = _graphs(14, mutate=False)
    seeds = torch.as_tensor(_seeds(14, b=32).astype(np.int32))
    kw = _hop_words(make_key(5), 2)
    for mode in ("pwindow", "xla"):
        stream = qt.GraphSageSampler(pg, [5, 3], device="cpu",
                                     gather_mode=mode)
        frozen = qt.GraphSageSampler(pg.base, [5, 3], device="cpu",
                                     gather_mode=mode, dedup="none")
        a, b = stream.pipeline(seeds, kw), frozen.pipeline(seeds, kw)
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)
        for la, lb in zip(a[3], b[3]):
            assert torch.equal(la.nbr_local, lb.nbr_local)
            assert torch.equal(la.mask, lb.mask)
            assert int(la.num_targets) == int(lb.num_targets)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_gather_modes_agree(mode):
    _, pg = _graphs(15)
    seeds = torch.as_tensor(_seeds(15, b=16).astype(np.int32))
    kw = _hop_words(make_key(6), 2)
    want = qt.GraphSageSampler(pg, [5, 3], device="cpu", gather_mode="xla",
                               return_eid=True).pipeline(seeds, kw)
    got = qt.GraphSageSampler(pg, [5, 3], device="cpu", gather_mode=mode,
                              return_eid=True).pipeline(seeds, kw)
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x, y)
    for la, lb in zip(got[3], want[3]):
        assert torch.equal(la.nbr_local, lb.nbr_local)
        assert torch.equal(la.eid, lb.eid)


def test_run_pipeline_overlay_refuses_dedup_and_weights():
    _, pg = _graphs(16)
    ps = pg.snapshot("cpu")
    overlay = dict(tomb=ps.tomb, d_indptr=ps.d_indptr,
                   d_indices=ps.d_indices)
    seeds = torch.arange(4, dtype=torch.int32)
    kw = _hop_words(make_key(0), 1)
    with pytest.raises(ValueError, match="positional"):
        run_pipeline("hop", ps.indptr, ps.indices, seeds, kw, [3],
                     overlay=overlay)
    with pytest.raises(ValueError, match="uniform"):
        run_pipeline("none", ps.indptr, ps.indices, seeds, kw, [3],
                     cum_weights=torch.zeros(128), overlay=overlay)
    out = run_pipeline("none", ps.indptr, ps.indices, seeds, kw, [3],
                       gather_mode="xla", overlay=overlay)
    assert out[0].shape == (16,)
