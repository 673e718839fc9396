"""Port parity: kernel B1's pipeline entry and the ``"pwindow"`` pipeline
against the JAX package's positional (``dedup="none"``) pipeline.

On the CPU the pipeline entry runs its plain version
(``window_sample_frontier_plain``).  The JAX references run the
``gather_mode="xla", sample_rng="hash"`` route, which the JAX suite holds
bitwise equal to its Pallas ``pwindow`` kernel; the port takes the folded
words of the same per-hop keys.  Every frontier id, mask, local id, edge
id, target count and PyG adjacency must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops.cuda import window_sample as b1

N_NODES = 255  # indptr holds 256 words: no padding after the last node


def _graph():
    """Degrees 0, at most and above every fanout (up to 700); the edge
    count is a multiple of 128, so the last node's window ends at the
    padded table's end."""
    rng = np.random.default_rng(11)
    deg = np.where(rng.random(N_NODES) < 0.3, rng.integers(41, 700, N_NODES),
                   rng.integers(0, 8, N_NODES))
    deg[:6] = 0
    deg[-1] = 300
    deg[-1] += (-int(deg.sum())) % 128
    indptr = np.zeros(N_NODES + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N_NODES, int(indptr[-1])).astype(np.int32)
    assert indices.shape[0] % 128 == 0
    return indptr, indices


@pytest.fixture(scope="module")
def csr():
    return _graph()


def _seeds():
    """Degree-0 nodes, the last node, and random ones."""
    rng = np.random.default_rng(3)
    return np.concatenate([[0, 3, N_NODES - 1],
                           rng.integers(0, N_NODES, 9)]).astype(np.int32)


def hop_words(key, n_hops):
    """The ``[L, 2]`` uint32 words the JAX pipeline derives from ``key``."""
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def _words(key):
    return tuple(int(np.asarray(w)) for w in _fold_key_words(key))


def _samples(csr, sizes, key, return_eid):
    indptr, indices = csr
    seeds = _seeds()
    jb = JaxSampler(JaxTopo(indptr=indptr, indices=indices), sizes,
                    gather_mode="xla", sample_rng="hash", dedup="none",
                    return_eid=return_eid).sample(seeds, key=key)
    before = b1.window_sample.launches
    pb = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             sizes, device="cpu", return_eid=return_eid,
                             gather_mode="pwindow"
                             ).sample(seeds, key_words=hop_words(key,
                                                                 len(sizes)))
    assert b1.window_sample.launches == before  # the CPU launches nothing
    return jb, pb


@pytest.mark.parametrize("sizes,impl", [
    ([3, 2], "threefry2x32"),
    ([5, 4, 3], "threefry2x32"),
    ([1, 6], "threefry2x32"),
    ([40, 2], "threefry2x32"),
    ([33, 1, 2], "rbg"),
])
def test_pwindow_pipeline_matches_jax(csr, sizes, impl):
    jb, pb = _samples(csr, sizes, make_key(50 + len(sizes), impl=impl), True)
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    np.testing.assert_array_equal(np.asarray(jb.n_id_mask),
                                  pb.n_id_mask.numpy())
    assert not pb.n_id_mask.all()  # the hops met masked seeds
    assert int(jb.num_nodes) == int(pb.num_nodes)
    np.testing.assert_array_equal(np.asarray(jb.drops), pb.drops.numpy())
    assert len(jb.layers) == len(pb.layers)
    for jl, pl in zip(jb.layers, pb.layers):
        for name in ("nbr_local", "mask", "eid"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                          getattr(pl, name).numpy(),
                                          err_msg=name)
        assert pl.num_targets.dtype == torch.int32
        assert int(jl.num_targets) == int(pl.num_targets)
    jn, jbs, jadjs = jb.to_pyg_adjs()
    pn, pbs, padjs = pb.to_pyg_adjs()
    np.testing.assert_array_equal(jn, pn)
    assert jbs == pbs
    for (je, jeid, jsz), (pe, peid, psz) in zip(jadjs, padjs):
        np.testing.assert_array_equal(je, pe)
        np.testing.assert_array_equal(jeid, peid)
        assert jsz == psz


def test_pwindow_pipeline_without_eid(csr):
    jb, pb = _samples(csr, [4, 3], make_key(9), False)
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    for jl, pl in zip(jb.layers, pb.layers):
        assert jl.eid is None and pl.eid is None
        np.testing.assert_array_equal(np.asarray(jl.nbr_local),
                                      pl.nbr_local.numpy())
        np.testing.assert_array_equal(np.asarray(jl.mask), pl.mask.numpy())


@pytest.mark.parametrize("k", [1, 7, 40])
def test_frontier_entry_matches_jax_hop(csr, k):
    """One hop over a frontier with masked ids, as JAX's pipeline builds
    it: the hop through JAX's ``sample_neighbors``, then its epilogue.  The
    buffers' head and whatever lies past the hop's tail are untouched."""
    indptr, indices = csr
    jip, jix = JaxTopo(indptr=indptr, indices=indices).to_device()
    pip, pix = qt.CSRTopo(indptr=indptr, indices=indices).to_device("cpu")
    rng = np.random.default_rng(k)
    t = 50
    ids = rng.integers(0, N_NODES, t).astype(np.int32)
    ids[:3] = [0, N_NODES - 1, 2]
    live = rng.random(t) < 0.7
    key = make_key(70 + k)
    want = jax_sample_neighbors(jip, jix, jnp.asarray(ids), k, key,
                                seed_mask=jnp.asarray(live),
                                gather_mode="xla", sample_rng="hash")
    w_mask = np.asarray(want.mask)
    w_front = np.where(w_mask, np.asarray(want.nbrs), 0).reshape(-1)
    pos = t + np.arange(t, dtype=np.int32)[:, None] * k + np.arange(k)
    w_local = np.where(w_mask, pos, 0)

    n = t * (1 + k) + 5
    frontier = torch.full((n,), -7, dtype=torch.int32)
    fmask = torch.zeros((n,), dtype=torch.bool)
    frontier[:t] = torch.from_numpy(ids)
    fmask[:t] = torch.from_numpy(live)
    fmask[-5:] = True
    hop = b1.window_sample_frontier(pip, pix, frontier, fmask, t, k,
                                    *_words(key), return_eid=True)
    np.testing.assert_array_equal(frontier[t:t + t * k].numpy(), w_front)
    np.testing.assert_array_equal(fmask[t:t + t * k].numpy(),
                                  w_mask.reshape(-1))
    np.testing.assert_array_equal(hop.nbr_local.numpy(), w_local)
    np.testing.assert_array_equal(hop.mask.numpy(), w_mask)
    np.testing.assert_array_equal(hop.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(hop.eid.numpy(), np.asarray(want.eid))
    np.testing.assert_array_equal(frontier[:t].numpy(), ids)
    np.testing.assert_array_equal(fmask[:t].numpy(), live)
    assert (frontier[-5:] == -7).all() and fmask[-5:].all()
    assert hop.mask.data_ptr() == fmask.data_ptr() + t
    assert b1.window_sample_frontier(pip, pix, frontier, fmask, t, k,
                                     *_words(key)).eid is None


def test_frontier_entry_refuses_bad_buffers(csr):
    pip, pix = qt.CSRTopo(indptr=csr[0], indices=csr[1]).to_device("cpu")
    frontier = torch.zeros(40, dtype=torch.int32)
    fmask = torch.ones(40, dtype=torch.bool)
    big = (torch.zeros(2048, dtype=torch.int32),
           torch.ones(2048, dtype=torch.bool))
    for args, match in [
            ((frontier, fmask, 10, 4), "too short"),
            ((*big, 2048, 2**20), "2\\*\\*31"),
            ((frontier, fmask, 41, 1), "outside"),
            ((frontier, fmask, 4, 0), "fanout"),
            ((frontier.long(), fmask, 4, 2), "int32"),
            ((frontier, fmask[1:], 4, 2), "fmask"),
            ((frontier, fmask.int(), 4, 2), "fmask")]:
        with pytest.raises(ValueError, match=match):
            b1.window_sample_frontier(pip, pix, *args, 1, 2)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 10, 15, 25, 33, 100, 128,
                               1_000, 65_537, 2**20 - 1, 2**20])
def test_div_magic_divides_exactly(k):
    """The kernel's ``t / k``: a multiply-high by ``div_magic(k)``, exact
    for every ``t < 2**31`` (checked at the edges, around every multiple of
    ``k`` near them, and at random), with no 32-bit overflow."""
    mul, shift = b1.div_magic(k)
    assert 0 < mul < 2**32 and 0 <= shift <= 20
    rng = np.random.default_rng(k)
    edges = np.array([0, 1, k - 1, k, k + 1, 2**31 - 1, 2**31 - 2],
                     np.uint64)
    mults = (np.arange(1, 2000, dtype=np.uint64) * np.uint64(k))
    mults = mults[mults < 2**31]
    top = np.uint64((2**31 - 1) // k * k)
    n = np.concatenate([edges, mults, mults - 1, top - np.arange(
        0, min(int(top), 3 * k), dtype=np.uint64),
        rng.integers(0, 2**31, 200_000).astype(np.uint64)])
    hi = (n * np.uint64(mul)) >> np.uint64(32)
    assert ((hi + n) < np.uint64(2**32)).all()
    np.testing.assert_array_equal((hi + n) >> np.uint64(shift),
                                  n // np.uint64(k))
