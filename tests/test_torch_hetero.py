"""Port parity: the heterogeneous slice.  ``HeteroGraphSageSampler``
against the JAX package's on the same MAG-style schema and keys (JAX:
``gather_mode="xla", sample_rng="hash"``; JAX's ``key, sub = split(key)``
per sampled block, folded into the port's words), bitwise: frontiers,
masks, blocks and target counts.  ``HeteroFeature.lookup`` rows bitwise,
whole and budgeted, an empty type included.  ``RGAT`` logits within
``rtol=atol=1e-5``, the converters both ways, a relation whose targets
sample nothing (output 0, finite gradients) and 3 Adam steps against
optax at dropout 0 (losses ``rtol=1e-5``, parameters ``atol=2e-5``, as
for GraphSAGE).
"""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.hetero import HeteroCSRTopo as JaxHeteroTopo
from quiver_tpu.hetero import HeteroFeature as JaxHeteroFeature
from quiver_tpu.hetero import HeteroGraphSageSampler as JaxHeteroSampler
from quiver_tpu.models.rgat import RGAT as FlaxRGAT
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.parallel.train import make_train_step as jax_train_step
from quiver_tpu.utils.rng import make_key

import quiver_tpu_torch as qt

COUNTS = {"paper": 300, "author": 200, "institution": 40, "field": 7}
DIMS = {"paper": 12, "author": 8, "institution": 6, "field": 5}
CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")
EMPLOYS = ("institution", "employs", "author")
HIDDEN, HEADS, CLASSES, B = 16, 4, 5, 24
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 2e-5

# the JAX package's telemetry switch as the process starts (collection
# runs before any test can change it)
_JAX_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _clean_jax_registry():
    """The JAX calls here record metrics in the JAX package's registry;
    after each test it is emptied and the switch set back to its default,
    so nothing recorded here reaches a later file in the same worker."""
    yield
    telemetry.reset()
    telemetry.set_enabled(_JAX_TELEMETRY_DEFAULT)


@pytest.fixture(scope="module")
def graph():
    """The MAG schema with a fourth type no relation reaches; employs at
    MAG240M's 0.36 institutions an author, so most authors have none."""
    rng = np.random.default_rng(0)

    def edges(n_src, n_dst, avg):
        deg = rng.poisson(avg, n_dst)
        dst = np.repeat(np.arange(n_dst), deg)
        return np.stack([rng.integers(0, n_src, len(dst)), dst])

    ei = {CITES: edges(300, 300, 6), WRITES: edges(200, 300, 3),
          EMPLOYS: edges(40, 200, 0.36)}
    feats = {t: rng.standard_normal((n, DIMS[t])).astype(np.float32)
             for t, n in COUNTS.items()}
    labels = rng.integers(0, CLASSES, COUNTS["paper"]).astype(np.int32)
    return (JaxHeteroTopo.from_edge_index_dict(ei, COUNTS),
            qt.HeteroCSRTopo.from_edge_index_dict(ei, COUNTS), feats, labels)


def block_words(key, n):
    """JAX's per-block key chain, folded: ``key, sub = split(key)``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append([int(np.asarray(w)) for w in _fold_key_words(sub)])
    return np.array(out, np.uint32).reshape(-1, 2)


def sample_both(graph, sizes, num_hops, seeds, key, mode="xla", **kw):
    jtopo, ptopo, _, _ = graph
    js = JaxHeteroSampler(jtopo, sizes, num_hops=num_hops, gather_mode="xla",
                          sample_rng="hash", **kw)
    ps = qt.HeteroGraphSageSampler(ptopo, sizes, num_hops=num_hops,
                                   device="cpu", gather_mode=mode, **kw)
    jb = js.sample(seeds, key=key)
    pb = ps.sample(seeds, key_words=block_words(key, ps.num_blocks(
        len(seeds))))
    return jb, pb, ps


def assert_same_batch(jb, pb):
    assert pb.batch_size == jb.batch_size and pb.seed_type == jb.seed_type
    # jit returns JAX's dicts with sorted keys; the port keeps type order
    assert list(pb.n_id) == list(COUNTS) and sorted(jb.n_id) == sorted(COUNTS)
    for t in jb.n_id:
        np.testing.assert_array_equal(pb.n_id[t].numpy(),
                                      np.asarray(jb.n_id[t]), err_msg=t)
        np.testing.assert_array_equal(pb.n_id_mask[t].numpy(),
                                      np.asarray(jb.n_id_mask[t]), err_msg=t)
    assert len(pb.layers) == len(jb.layers)
    for l, (jl, pl) in enumerate(zip(jb.layers, pb.layers)):
        assert [b.relation for b in pl] == [b.relation for b in jl]
        for jblk, pblk in zip(jl, pl):
            what = f"layer {l} {jblk.relation}"
            for f in ("nbr_local", "mask", "num_targets"):
                np.testing.assert_array_equal(
                    getattr(pblk, f).numpy(), np.asarray(getattr(jblk, f)),
                    err_msg=f"{what} {f}")
            assert pblk.nbr_local.dtype == torch.int32


SIZE_CASES = {
    "int": (3, "hops"),
    "dict": ({CITES: 4, WRITES: 2, EMPLOYS: 3}, "hops"),
    # employs first: skipped at hop 0 (no author yet), it must use no
    # key there and take the first key of hop 1
    "dict_skip_first": ({EMPLOYS: 2, CITES: 3, WRITES: 2}, "hops"),
    "list": ([{CITES: 5, WRITES: 3}, {EMPLOYS: 2, CITES: 2, WRITES: 1}],
             None),
    "list_int": ([4, 2], None),
}


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_sampler_matches_jax(graph, case, hops):
    sizes, how = SIZE_CASES[case]
    if how is None:
        sizes = sizes[:hops]
    seeds = np.random.default_rng(hops).integers(0, COUNTS["paper"], B)
    jb, pb, ps = sample_both(graph, sizes, hops if how else None, seeds,
                             make_key(10 + hops))
    assert_same_batch(jb, pb)
    n_blocks = sum(len(layer) for layer in pb.layers)
    assert ps.num_blocks(B) == n_blocks
    assert ps.layer_relations(B) == tuple(tuple(b.relation for b in layer)
                                          for layer in pb.layers)
    assert pb.n_id["field"].shape == (0,)


@pytest.mark.parametrize("mode", ["pwindow", "pallas", "lanes_fused"])
def test_sampler_gather_modes_match_jax(graph, mode):
    """Every gather mode samples JAX's batch (B1's, B3's and B4's plain
    versions on the CPU); the seeds repeat and hit a degree-0 paper."""
    deg = np.diff(graph[1].relations[CITES].indptr)
    seeds = np.concatenate([np.arange(B - 2), [np.argmin(deg)] * 2])
    jb, pb, _ = sample_both(graph, 3, 2, seeds, make_key(4), mode=mode)
    assert_same_batch(jb, pb)


def test_sampler_draws_and_refusals(graph):
    _, ptopo, _, _ = graph
    s = qt.HeteroGraphSageSampler(ptopo, 2, num_hops=2, device="cpu",
                                  seed=3)
    kw = s.draw_key_words(B)
    assert kw.shape == (5, 2) and kw.dtype == np.uint32
    a = qt.HeteroGraphSageSampler(ptopo, 2, num_hops=2, device="cpu",
                                  seed=3).sample(np.arange(B))
    b = s.sample(np.arange(B), key_words=kw)
    for t in a.n_id:
        assert torch.equal(a.n_id[t], b.n_id[t])
    keyed = qt.HeteroGraphSageSampler(ptopo, 2, num_hops=1, device="cpu",
                                      sample_rng="key")
    assert (keyed.gather_mode, keyed.sample_rng) == ("blocked", "key")
    with pytest.raises(ValueError, match="pwindow"):
        qt.HeteroGraphSageSampler(ptopo, 2, num_hops=1, device="cpu",
                                  gather_mode="pwindow",
                                  sample_rng="key").sample(np.arange(B))
    with pytest.raises(ValueError, match="key-word pairs"):
        s.sample(np.arange(B), key_words=kw[:4])
    with pytest.raises(ValueError, match="num_hops"):
        qt.HeteroGraphSageSampler(ptopo, 2, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 300\)"):
        s.sample([300])
    with pytest.raises(ValueError, match="relation"):
        qt.HeteroGraphSageSampler(ptopo, [{("a", "b", "c"): 1}],
                                  device="cpu")
    empty = s.sample(np.zeros(0, np.int64), key_words=np.zeros((0, 2)))
    assert all(len(layer) == 0 for layer in empty.layers)


def test_sample_path_never_syncs():
    """No host read-back on the hetero sampling path: ``sample``, the
    ``pipeline`` it and the fused step call, and the lookups call none of
    these, and the sampling functions store into no tensor by subscript
    (a store from a Python scalar waits for the stream; they fill and
    copy instead)."""
    banned = {"item", "tolist", "unique", "nonzero", "masked_select", "cpu",
              "numpy", "cat"}
    for obj in (qt.HeteroGraphSageSampler.sample,
                qt.HeteroGraphSageSampler.pipeline, qt.HeteroFeature.lookup,
                qt.HeteroFeature.lookup_device, qt.HeteroFeature._each):
        tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
        called = {n.func.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        assert not called & banned, (obj, called & banned)
        if obj.__name__ in ("sample", "pipeline"):
            assert not [n for n in ast.walk(tree)
                        if isinstance(n, ast.Assign) and any(
                            isinstance(t, ast.Subscript) for t in n.targets)]


@pytest.mark.parametrize("budget", ["whole", "budgeted"])
def test_feature_lookup_matches_jax(graph, budget):
    """Rows of every type's frontier, bitwise; ``field`` has an empty
    frontier and gives ``[0, 5]``."""
    _, _, feats, _ = graph
    size = ("1G" if budget == "whole" else 30 * 4 * max(DIMS.values()))
    seeds = np.random.default_rng(5).integers(0, COUNTS["paper"], B)
    jb, pb, _ = sample_both(graph, 3, 2, seeds, make_key(6))
    jf = JaxHeteroFeature.from_cpu_tensors(feats, device_cache_size=size)
    pf = qt.HeteroFeature.from_cpu_tensors(feats, device_cache_size=size,
                                           device="cpu")
    if budget == "budgeted":
        assert pf.features["paper"].cache_count < COUNTS["paper"]
    want, got = jf.lookup(jb), pf.lookup(pb)
    assert list(got) == list(COUNTS) and sorted(want) == sorted(COUNTS)
    for t in want:
        assert got[t].dtype == torch.float32
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want[t]),
                                      err_msg=t)
        np.testing.assert_array_equal(
            got[t].numpy(), feats[t][pb.n_id[t].numpy()], err_msg=t)
    assert got["field"].shape == (0, DIMS["field"])
    ids = pb.n_id["author"][:5]
    assert torch.equal(pf["author", ids], got["author"][:5])


def rgat_pair(graph, seeds, key, dropout=0.0):
    """The JAX and port batches, features, a Flax R-GAT with its params,
    and the port's R-GAT loaded from them."""
    _, _, feats, _ = graph
    jb, pb, ps = sample_both(graph, [{CITES: 4, WRITES: 3, EMPLOYS: 3},
                                     {CITES: 3, WRITES: 2, EMPLOYS: 4}],
                             None, seeds, key)
    jx = {t: jnp.asarray(feats[t][np.asarray(jb.n_id[t])]) for t in feats}
    px = {t: torch.from_numpy(feats[t][pb.n_id[t].numpy()]) for t in feats}
    fm = FlaxRGAT(hidden=HIDDEN, out_dim=CLASSES, num_layers=2,
                  in_dims=DIMS, heads=HEADS, dropout=dropout)
    params = fm.init(jax.random.PRNGKey(2), jx, jb)
    pm = qt.RGAT(DIMS, HIDDEN, CLASSES, 2, ps.layer_relations(len(seeds)),
                 heads=HEADS, dropout=dropout, device="cpu")
    pm.load_state_dict(qt.rgat_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jb, pb, jx, px, fm, params, pm


def test_rgat_logits_match_flax(graph):
    seeds = np.random.default_rng(7).integers(0, COUNTS["paper"], B)
    jb, pb, jx, px, fm, params, pm = rgat_pair(graph, seeds, make_key(8))
    want = np.asarray(fm.apply(params, jx, jb))
    pm.eval()
    got = pm(px, pb)
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


def test_rgat_converters_round_trip(graph):
    seeds = np.arange(B)
    *_, params, pm = rgat_pair(graph, seeds, make_key(9))
    want = jax.tree_util.tree_map(np.asarray, params)
    got = qt.rgat_params_to_flax(pm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    names = set(got["params"])
    assert {"proj_field", "self_0_author", "self_1_paper",
            "rel_0_institution__employs__author", "classifier"} <= names
    assert "rel_1_institution__employs__author" not in names
    with pytest.raises(ValueError, match="not a"):
        qt.rgat_params_from_flax({"conv0": {}})
    with pytest.raises(ValueError, match="'.'"):
        qt.RGAT({"a.b": 3}, HIDDEN, CLASSES, 1, [[]], device="cpu")


def test_rgat_targets_with_nothing_sampled(graph):
    """Most authors have no institution: their ``employs`` attention rows
    are all masked, an all ``-inf`` softmax (NaN).  The output there is 0,
    as in JAX, and every gradient is finite."""
    seeds = np.arange(B)
    jb, pb, jx, px, fm, params, pm = rgat_pair(graph, seeds, make_key(11))
    blk = next(b for b in pb.layers[0] if b.relation == EMPLOYS)
    empty = ~blk.mask.any(dim=1)
    assert empty.sum() > blk.mask.shape[0] // 2
    h = {t: pm.mods[f"proj_{t}"](x) for t, x in px.items()}
    att = pm.mods["rel_0_institution__employs__author"]
    out = att(h["institution"], h["author"], blk)
    assert torch.isfinite(out).all()
    assert (out[empty] == 0).all() and (out[~empty] != 0).any()
    pm.train()
    loss = pm(px, pb).square().sum() + out.sum()
    loss.backward()
    for name, p in pm.named_parameters():
        if p.grad is not None:
            assert torch.isfinite(p.grad).all(), name
    assert att.att_src.grad is not None
    np.testing.assert_allclose(pm.eval()(px, pb).detach().numpy(),
                               np.asarray(fm.apply(params, jx, jb)),
                               **LOGIT_TOL)


def rgat_loss_grads(graph, seeds, key):
    """``rgat_pair`` and JAX's gradients of the masked loss at the Flax
    parameters, as numpy leaves by path."""
    _, _, _, labels = graph
    pair = rgat_pair(graph, seeds, key)
    jb, _, jx, _, fm, params, _ = pair
    lab, mask = labels[seeds], np.arange(len(seeds)) < len(seeds) - 5

    def loss(p):
        logits = fm.apply(p, jx, jb)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(lab))
        return (ls * jnp.asarray(mask)).sum() / mask.sum()

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    return pair, lab, mask, dict(jax.tree_util.tree_leaves_with_path(grads))


def port_leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


SEEDS = np.random.default_rng(12).integers(0, COUNTS["paper"], B)


def test_rgat_gradients_match_jax(graph):
    """One loss's gradients, every leaf within ``atol=1e-6`` of JAX's."""
    (_, pb, _, px, _, _, pm), lab, mask, want = rgat_loss_grads(
        graph, SEEDS, make_key(13))
    qt.parallel.train.masked_cross_entropy(
        pm(px, pb), torch.from_numpy(lab), torch.from_numpy(mask)).backward()
    # a type that reaches no loss (``field``) has no gradient: JAX's is 0
    got = port_leaves(qt.rgat_params_to_flax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in pm.named_parameters()}))
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


ADAM_EPS = 1e-8  # optax.adam's and torch.optim.Adam's default


def test_rgat_adam_steps_match_optax(graph):
    """3 steps of ``make_train_step(RGAT)`` (Adam 1e-3, a padded label
    tail) against JAX's step with optax on the same batch: losses within
    ``rtol=1e-5``, parameters within ``atol=2e-5`` after steps 1 and 3.

    One set of elements is held to Adam's step bound instead: those whose
    gradient is below Adam's ``eps``.  In exact arithmetic a ``w_dst`` or
    ``att_dst`` gradient is 0 for every target whose scores all lie on one
    side of the leaky ReLU (the destination term shifts a softmax's
    logits, which changes nothing); both frameworks return rounding noise
    there (about 1e-10, equal within 1e-6 in
    ``test_rgat_gradients_match_jax``), which Adam scales to about
    ``lr * g / eps`` of either sign."""
    (jb, pb, jx, px, fm, params, pm), lab, mask, grads = rgat_loss_grads(
        graph, SEEDS, make_key(13))
    noise = {p: np.abs(g) < ADAM_EPS for p, g in grads.items()}
    assert 0 < sum(n.sum() for n in noise.values()) < 0.2 * sum(
        n.size for n in noise.values())
    lr = 1e-3
    state = JaxState.create(params, optax.adam(lr))
    jstep = jax_train_step(
        lambda p, x, batch, train=False, rngs=None: fm.apply(
            p, x, batch, train=train, rngs=rngs), optax.adam(lr))
    pstep = qt.make_train_step(pm, torch.optim.Adam(pm.parameters(), lr=lr))
    for i in range(3):
        state, jloss = jstep(state, jx, jb, jnp.asarray(lab),
                             jnp.asarray(mask), jax.random.PRNGKey(i))
        ploss = pstep(px, pb, torch.from_numpy(lab), torch.from_numpy(mask))
        np.testing.assert_allclose(float(ploss), float(jloss), **LOSS_TOL)
        if i in (0, 2):
            want = port_leaves(jax.tree_util.tree_map(np.asarray,
                                                      state.params))
            got = port_leaves(qt.rgat_params_to_flax(pm))
            assert got.keys() == want.keys()
            for path, leaf in want.items():
                err = np.abs(got[path] - leaf)
                what = jax.tree_util.keystr(path)
                assert (err[~noise[path]] <= PARAM_ATOL).all(), what
                assert (err[noise[path]] <= 2 * lr * (i + 1)).all(), what
