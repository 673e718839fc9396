"""Port parity: kernel B1's keyed entries (``sample_rng="key"``).

Under ``"key"`` a uniform ``"blocked[:U]"`` hop is one launch of B1's
threefry instance: its literal entry (``window_sample``) for a hop, its
pipeline entry (``window_sample_frontier``) for each hop of the
positional pipeline.  On the CPU each runs its plain version, the
``"xla"`` hop with threefry uniforms (``threefry_uniform_plain``).  Here:

- the literal entry against JAX's ``sample_neighbors(...,
  gather_mode="xla", sample_rng="key")``, bitwise, at degrees below and
  above the fanout, masked seeds, ``k = 1`` and a 128-padded table;
- the keyed pipeline through ``_pwindow_pipeline`` against JAX's keyed
  ``dedup="none"`` pipeline and the port's generic loop, bitwise, over
  frontiers with masked slots (the entry's counter ``b*k + j`` runs over
  the masked slots as the loop's ``[t, k]`` draw does);
- the dispatch: which keyed hops reach B1's keyed entries, and which keep
  the threefry kernel and B3;
- the hash instance's outputs, unchanged.

Every JAX reference runs ``gather_mode="xla"``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_hop
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import sampler as psampler
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.ops import sample as psample
from quiver_tpu_torch.ops.cuda import element_gather as b3
from quiver_tpu_torch.ops.cuda import threefry as tf
from quiver_tpu_torch.ops.cuda import window_sample as b1
from quiver_tpu_torch.ops.cuda.build import KernelArgumentError
from quiver_tpu_torch.ops.sample import hop_key_words
from quiver_tpu_torch.stream import StreamingGraph
from quiver_tpu_torch.utils import rng

N = 3000


@pytest.fixture(autouse=True)
def _registries_left_empty():
    """Both packages' registries emptied and JAX's telemetry switch set
    back after every test, so nothing recorded here reaches another test
    or a later file on this worker."""
    on = jtel.enabled()
    yield
    jtel.reset()
    jtel.set_enabled(on)
    ptel.reset()


def _graph():
    """Degrees 0, at most and above every fanout tested (up to 600), the
    last node's window at the end of the edge table, which is not a
    128-multiple (so the padded table has a tail of padding)."""
    g = np.random.default_rng(17)
    deg = np.where(g.random(N) < 0.25, g.integers(30, 600, N),
                   g.integers(0, 9, N))
    deg[:7] = 0
    deg[-1] = 250
    if int(deg.sum()) % 128 == 0:
        deg[-1] += 1
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = g.integers(0, N, int(indptr[-1])).astype(np.int32)
    assert indices.shape[0] % 128 != 0
    return indptr, indices


@pytest.fixture(scope="module")
def csr():
    return _graph()


@pytest.fixture(scope="module")
def tables(csr):
    """The padded tables of both packages: JAX's on its CPU device, the
    port's on the CPU."""
    jt = JaxTopo(indptr=csr[0], indices=csr[1])
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    jip, jix = jt.to_device(None)
    pip, pix = pt.to_device("cpu")
    assert pix.shape[0] % 128 == 0 and pix.shape[0] > csr[1].shape[0]
    return jip, jix, pip, pix


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _seeds(seed, b=64):
    """Degree-0 nodes, the last node (its window ends at the table's
    padding) and random ones."""
    g = np.random.default_rng(seed)
    return np.concatenate([[0, 3, N - 1, N - 1],
                           g.integers(0, N, b)]).astype(np.int32)


# -- the literal entry -----------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 25, 700])
@pytest.mark.parametrize("masked", [False, True])
def test_keyed_literal_entry_matches_jax_xla_hop(tables, k, masked):
    """B1's keyed literal entry (its plain version on the CPU) draws JAX's
    keyed ``"xla"`` hop bit for bit: neighbours, mask, counts and edge
    ids.  ``k = 700`` is above every degree (every window whole),
    ``k = 1`` one stratum a window."""
    jip, jix, pip, pix = tables
    seeds = _seeds(k)
    smask = (np.random.default_rng(k + 1).random(seeds.shape[0]) < 0.7
             if masked else None)
    for s in (0, 2**31 - 1):
        key = make_key(s)
        want = jax_hop(jip, jix, jnp.asarray(seeds), k, key,
                       None if smask is None else jnp.asarray(smask),
                       gather_mode="xla", sample_rng="key")
        before = b1.window_sample.launches
        got = b1.window_sample(pip, pix, torch.from_numpy(seeds), k,
                               *_words(key),
                               None if smask is None
                               else torch.from_numpy(smask),
                               sample_rng="key")
        assert b1.window_sample.launches == before  # the CPU launches none
        for name in ("nbrs", "mask", "counts", "eid"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=name)
        if k < 600:  # some seed drew from a window wider than k
            assert bool((got.counts == k).any())
        if masked:
            assert not bool(got.mask[torch.from_numpy(~smask)].any())


def test_keyed_literal_entry_is_the_keyed_blocked_hop(tables):
    """The entry equals the port's own keyed hop under every other gather
    mode (same draws, other reads), and differs from the hashed hop."""
    _, _, pip, pix = tables
    seeds = torch.from_numpy(_seeds(5))
    words = _words(make_key(5))
    got = b1.window_sample(pip, pix, seeds, 10, *words, sample_rng="key")
    for mode in ("xla", "pallas", "lanes", "lanes_fused"):
        want = psample.sample_hop(pip, pix, seeds, 10, *words, None, mode,
                                  "key")
        for a, b in zip(got, want):
            assert torch.equal(a, b), mode
    hashed = b1.window_sample(pip, pix, seeds, 10, *words)
    assert not torch.equal(got.nbrs, hashed.nbrs)


# -- the pipeline entry ----------------------------------------------------
def _same_pipeline(got, want):
    """Two ``run_pipeline`` results, bitwise."""
    for i in range(3):
        assert torch.equal(got[i], want[i]), i
    assert len(got[3]) == len(want[3])
    for a, b in zip(got[3], want[3]):
        for name in ("nbr_local", "mask", "num_targets", "eid"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("sizes", [[5, 4, 3], [1, 6], [25, 10], [40, 1, 2]])
def test_keyed_pipeline_entry_matches_jax_and_the_generic_loop(csr, tables,
                                                               sizes):
    """The keyed positional pipeline through ``_pwindow_pipeline`` (B1's
    pipeline entry a hop) against JAX's keyed ``dedup="none"`` pipeline
    and against the port's generic loop (``"xla"`` hops, threefry
    uniforms ``[t, k]`` a hop): frontier, masks, node count, every
    block's local ids, mask, target count and edge ids, bitwise.  The
    later hops run over frontiers with masked slots."""
    _, _, pip, pix = tables
    seeds = _seeds(len(sizes) + sum(sizes))
    js = JaxSampler(JaxTopo(indptr=csr[0], indices=csr[1]), sizes,
                    gather_mode="xla", sample_rng="key", dedup="none",
                    return_eid=True)
    for s in (3, 2**31 - 1):
        kw = hop_key_words(rng.split(rng.key(s), len(sizes)), "key")
        fused = psampler._pwindow_pipeline(pip, pix, torch.from_numpy(seeds),
                                           kw, sizes, True, "key")
        loop = psampler.run_pipeline("none", pip, pix,
                                     torch.from_numpy(seeds), kw, sizes,
                                     return_eid=True, gather_mode="xla",
                                     sample_rng="key")
        _same_pipeline(fused, loop)
        assert not bool(fused[1].all())  # the hops met masked slots
        jb = js.sample(seeds, key=make_key(s))
        np.testing.assert_array_equal(fused[0].numpy(), np.asarray(jb.n_id))
        np.testing.assert_array_equal(fused[1].numpy(),
                                      np.asarray(jb.n_id_mask))
        assert int(fused[2]) == int(jb.num_nodes)
        for pl, jl in zip(fused[3], jb.layers):
            for name in ("nbr_local", "mask", "eid"):
                np.testing.assert_array_equal(
                    getattr(pl, name).numpy(), np.asarray(getattr(jl, name)),
                    err_msg=name)
            assert int(pl.num_targets) == int(jl.num_targets)


def test_keyed_frontier_entry_draws_at_the_hops_counters(tables):
    """One pipeline hop over a frontier whose slots are partly masked: the
    entry's uniforms are ``jax.random.uniform(key, (t, k))`` at counter
    ``b*k + j`` whatever ``fmask[b]`` is, so its tail equals the literal
    entry's hop over ``frontier[:t]`` masked by ``fmask[:t]``, and
    differs from a hop over the live seeds alone."""
    _, _, pip, pix = tables
    seeds = torch.from_numpy(_seeds(9, b=200))
    t, k = seeds.shape[0], 6
    live = torch.from_numpy(np.random.default_rng(9).random(t) < 0.5)
    frontier = torch.zeros(t * (1 + k), dtype=torch.int32)
    fmask = torch.zeros(t * (1 + k), dtype=torch.bool)
    frontier[:t], fmask[:t] = seeds, live
    words = _words(make_key(9))
    hop = b1.window_sample_frontier(pip, pix, frontier, fmask, t, k, *words,
                                    return_eid=True, sample_rng="key")
    lit = b1.window_sample(pip, pix, seeds, k, *words, live,
                           sample_rng="key")
    assert torch.equal(hop.mask, lit.mask)
    assert torch.equal(hop.counts, lit.counts)
    assert torch.equal(hop.eid, lit.eid)
    assert torch.equal(frontier[t:].view(t, k),
                       torch.where(lit.mask, lit.nbrs,
                                   torch.zeros_like(lit.nbrs)))
    pos = t + torch.arange(t * k, dtype=torch.int32).view(t, k)
    assert torch.equal(hop.nbr_local,
                       torch.where(lit.mask, pos, torch.zeros_like(pos)))
    # the live seeds alone draw at other counters
    alone = b1.window_sample(pip, pix, seeds[live], k, *words,
                             sample_rng="key")
    assert not torch.equal(alone.eid, lit.eid[live])


# -- the dispatch ----------------------------------------------------------
class _Calls:
    """Spies on B1's two entries (with the RNG of each call), the threefry
    kernel's wrapper and B3's two entries, each calling through."""

    def __init__(self, monkeypatch):
        self.b1, self.threefry, self.b3 = [], [], 0
        real_lit, real_front = b1.window_sample, b1.window_sample_frontier
        real_tf = tf.threefry_uniform
        real_b3, real_pair = b3.element_gather, b3.element_gather_pair

        def rng_of(fn, a, kw):
            bound = inspect.signature(fn).bind(*a, **kw)
            bound.apply_defaults()
            return bound.arguments["sample_rng"]

        def lit(*a, **kw):
            self.b1.append(("literal", rng_of(real_lit, a, kw)))
            return real_lit(*a, **kw)

        def front(*a, **kw):
            self.b1.append(("pipeline", rng_of(real_front, a, kw)))
            return real_front(*a, **kw)

        def threefry(words, shape, device=None):
            self.threefry.append(tuple(shape))
            return real_tf(words, shape, device)

        def gather(*a, **kw):
            self.b3 += 1
            return real_b3(*a, **kw)

        def pair(*a, **kw):
            self.b3 += 1
            return real_pair(*a, **kw)

        monkeypatch.setattr(b1, "window_sample", lit)
        monkeypatch.setattr(b1, "window_sample_frontier", front)
        monkeypatch.setattr(psampler, "window_sample_frontier", front)
        monkeypatch.setattr(tf, "threefry_uniform", threefry)
        monkeypatch.setattr(b3, "element_gather", gather)
        monkeypatch.setattr(b3, "element_gather_pair", pair)

    def reset(self):
        self.b1, self.threefry, self.b3 = [], [], 0


@pytest.mark.parametrize("mode", ["auto", "blocked", "blocked:4"])
def test_keyed_blocked_hops_and_pipelines_reach_b1(csr, monkeypatch, mode):
    """Under ``"key"`` a uniform ``"auto"``/``"blocked[:U]"`` pipeline is
    B1's keyed pipeline entry a hop (``dedup="none"``) or its literal
    entry a hop (``dedup="hop"``, ``sample_layer``, ``sample_neighbors``);
    no B3 read and no call of the threefry kernel's wrapper (B1's plain
    version draws by ``threefry_uniform_plain``)."""
    calls = _Calls(monkeypatch)
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    seeds = _seeds(1, b=16)
    for dedup, entry in (("none", "pipeline"), ("hop", "literal")):
        s = qt.GraphSageSampler(pt, [5, 4, 3], device="cpu",
                                gather_mode=mode, sample_rng="key",
                                dedup=dedup)
        assert s.gather_mode.startswith("blocked")
        calls.reset()
        s.sample(seeds, key=rng.key(1))
        assert calls.b1 == [(entry, "key")] * 3
        assert calls.b3 == 0
        assert calls.threefry == []
    calls.reset()
    s.sample_layer(seeds, 6, key=rng.key(2))
    qt.sample_neighbors(*pt.to_device("cpu"), torch.from_numpy(seeds), 6,
                        rng.key(2), device="cpu", gather_mode=mode,
                        sample_rng="key")
    assert calls.b1 == [("literal", "key")] * 2
    assert calls.b3 == 0 and calls.threefry == []


@pytest.mark.parametrize("mode", ["pallas", "xla", "lanes_fused"])
def test_other_keyed_hops_keep_threefry_and_their_reads(csr, monkeypatch,
                                                        mode):
    """Keyed ``"pallas"``/``"xla"``/``"lanes*"`` hops draw through the
    threefry kernel's wrapper, one call a hop, and never reach B1;
    ``"pallas"`` reads through B3."""
    calls = _Calls(monkeypatch)
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    for dedup in ("none", "hop"):
        s = qt.GraphSageSampler(pt, [5, 4, 3], device="cpu",
                                gather_mode=mode, sample_rng="key",
                                dedup=dedup)
        calls.reset()
        s.sample(_seeds(2, b=16), key=rng.key(2))
        assert calls.b1 == []
        assert calls.threefry == [(20, 5), (120, 4), (600, 3)]
        assert (calls.b3 > 0) == (mode == "pallas")


def test_keyed_weighted_and_overlay_hops_do_not_reach_b1(csr, monkeypatch):
    """The weighted hop and the streaming overlay hop keep their own draw
    sites under ``"key"`` (the threefry kernel and B3's reads under the
    auto gather mode), as in JAX: neither has a fused kernel."""
    calls = _Calls(monkeypatch)
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    w = np.random.default_rng(4).random(csr[1].shape[0]).astype(np.float32)
    seeds = _seeds(3, b=16)
    for dedup in ("none", "hop"):
        calls.reset()
        qt.GraphSageSampler(pt, [4, 3], device="cpu", sample_rng="key",
                            dedup=dedup, edge_weights=w).sample(
            seeds, key=rng.key(3))
        assert calls.b1 == [] and len(calls.threefry) == 2
        assert calls.b3 > 0
    g = StreamingGraph(qt.CSRTopo(indptr=csr[0], indices=csr[1]),
                       device="cpu")
    calls.reset()
    qt.GraphSageSampler(g, [4, 3], device="cpu", sample_rng="key").sample(
        seeds, key=rng.key(3))
    assert calls.b1 == [] and len(calls.threefry) == 2
    assert calls.b3 > 0


def test_hashed_routes_are_unchanged(csr, monkeypatch):
    """Under the hash ``"auto"``/``"pwindow"`` is B1's hash instance and a
    ``"blocked"`` hop keeps its B3 reads; no threefry call anywhere."""
    calls = _Calls(monkeypatch)
    pt = qt.CSRTopo(indptr=csr[0], indices=csr[1])
    seeds = _seeds(4, b=16)
    for mode, dedup, want in (("auto", "none", [("pipeline", "hash")] * 2),
                              ("auto", "hop", [("literal", "hash")] * 2),
                              ("blocked", "none", []),
                              ("blocked", "hop", [])):
        calls.reset()
        qt.GraphSageSampler(pt, [4, 3], device="cpu", gather_mode=mode,
                            sample_rng="hash", dedup=dedup).sample(
            seeds, key=rng.key(4))
        assert calls.b1 == want, (mode, dedup)
        assert (calls.b3 > 0) == (mode == "blocked")
        assert calls.threefry == []


# -- the hash instance, unchanged ------------------------------------------
@pytest.mark.parametrize("k", [1, 7, 25])
def test_hash_entries_still_match_jax(csr, tables, k):
    """The hash instance's outputs are JAX's hashed ``"xla"`` hop's and
    pipeline's, bitwise, whether ``sample_rng="hash"`` is passed or
    left to its default."""
    jip, jix, pip, pix = tables
    seeds = _seeds(20 + k)
    key = make_key(20 + k)
    words = tuple(int(np.asarray(w)) for w in _fold_key_words(key))
    want = jax_hop(jip, jix, jnp.asarray(seeds), k, key, gather_mode="xla",
                   sample_rng="hash")
    for got in (b1.window_sample(pip, pix, torch.from_numpy(seeds), k,
                                 *words),
                b1.window_sample(pip, pix, torch.from_numpy(seeds), k,
                                 *words, sample_rng="hash")):
        for name in ("nbrs", "mask", "counts", "eid"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=name)
    sizes = [k, 3]
    jb = JaxSampler(JaxTopo(indptr=csr[0], indices=csr[1]), sizes,
                    gather_mode="xla", sample_rng="hash", dedup="none",
                    return_eid=True).sample(seeds, key=key)
    kw = np.array([[int(np.asarray(w)) for w in _fold_key_words(sub)]
                   for sub in jax.random.split(key, 2)], np.uint32)
    got = psampler._pwindow_pipeline(pip, pix, torch.from_numpy(seeds), kw,
                                     sizes, True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jb.n_id))
    for pl, jl in zip(got[3], jb.layers):
        for name in ("nbr_local", "mask", "eid"):
            np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                          np.asarray(getattr(jl, name)))


def test_bad_sample_rng_is_refused(tables):
    """Each entry and its plain version refuse an RNG other than
    ``"hash"`` or ``"key"`` (on the CPU too), as a fault of the caller."""
    _, _, pip, pix = tables
    seeds = torch.from_numpy(_seeds(6))
    t, k = seeds.shape[0], 3
    frontier = torch.zeros(t * (1 + k), dtype=torch.int32)
    fmask = torch.zeros(t * (1 + k), dtype=torch.bool)
    frontier[:t] = seeds
    for bad in ("auto", "threefry", None, 1):
        with pytest.raises(KernelArgumentError, match="sample_rng"):
            b1.window_sample(pip, pix, seeds, k, 1, 2, sample_rng=bad)
        with pytest.raises(KernelArgumentError, match="sample_rng"):
            b1.window_sample_frontier(pip, pix, frontier, fmask, t, k, 1, 2,
                                      sample_rng=bad)
        with pytest.raises(KernelArgumentError, match="sample_rng"):
            b1.window_sample_frontier_plain(pip, pix, frontier, fmask, t, k,
                                            1, 2, sample_rng=bad)


def test_explicit_pwindow_with_key_still_raises(tables):
    """An explicit ``"pwindow"`` with an explicit ``"key"`` raises at the
    hop, as JAX's op does: the keyed instance is reached through
    ``"blocked"`` only."""
    _, _, pip, pix = tables
    with pytest.raises(ValueError, match="requires sample_rng='hash'"):
        psample.run_hop(pip, pix, torch.from_numpy(_seeds(7)), 3, 1, 2, None,
                        "pwindow", "key")
