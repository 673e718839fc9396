"""Port parity: the GAT and GCN families.  ``GATConv``, ``GAT``,
``GCNConv`` and ``GCN`` of the port against the JAX package's Flax modules
on the same sampled blocks (JAX: ``gather_mode="xla", sample_rng="hash"``)
with converted parameters; the converters both ways; losses and Adam
parameters after 1 and 3 steps at dropout 0 (its bits cannot match
Flax's).

Tolerances (fp32), as for GraphSAGE (``test_torch_train.py``): logits
``rtol=atol=1e-5``; losses ``rtol=1e-5``; parameters ``atol=2e-5``, since
Adam divides by the square root of the second moment and so amplifies
summation-order differences of near-zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.models import GAT as FlaxGAT
from quiver_tpu.models import GCN as FlaxGCN
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.models.gcn import GCNConv as FlaxGCNConv
from quiver_tpu.models.layers import GATConv as FlaxGATConv
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.parallel.train import make_train_step as jax_train_step
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt

N, D, HIDDEN, CLASSES, B = 1500, 12, 8, 5, 48
SIZES = [5, 4, 3]
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
def data():
    """A graph, features, labels and one JAX batch with its blocks as
    port ``LayerBlock``s."""
    indptr, indices = qt.synthetic_csr(N, 12_000, seed=6)
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    ids = rng.integers(0, N, B)
    jb = JaxSampler(JaxTopo(indptr=indptr, indices=indices), SIZES,
                    gather_mode="xla", sample_rng="hash",
                    dedup="none").sample(ids, key=make_key(3))
    x = feat[np.asarray(jb.n_id)]
    return jb, port_blocks(jb.layers), x, labels[ids]


def port_blocks(layers, drop_every=None):
    """JAX blocks as port blocks; ``drop_every`` masks every slot of every
    ``drop_every``-th target (the same change is made to the JAX block)."""
    jax_out, port_out = [], []
    for blk in layers:
        mask = np.asarray(blk.mask).copy()
        nbr = np.asarray(blk.nbr_local).copy()
        if drop_every:
            mask[::drop_every] = False
            nbr[~mask] = 0
        jax_out.append(blk._replace(nbr_local=jnp.asarray(nbr),
                                    mask=jnp.asarray(mask)))
        port_out.append(qt.LayerBlock(
            nbr_local=torch.from_numpy(nbr), mask=torch.from_numpy(mask),
            num_targets=torch.tensor(int(np.asarray(blk.num_targets)))))
    return (tuple(jax_out), tuple(port_out)) if drop_every else tuple(
        port_out)


def tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def strip(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def conv_pair(family, heads=1, concat=True):
    """A Flax conv and the port's, unparameterised."""
    if family == "gat":
        return (FlaxGATConv(HIDDEN, heads=heads, concat=concat),
                qt.GATConv(D, HIDDEN, heads=heads, concat=concat,
                           device="cpu"), qt.gat_params_from_flax)
    return (FlaxGCNConv(HIDDEN), qt.GCNConv(D, HIDDEN, device="cpu"),
            qt.gcn_params_from_flax)


def check_conv(family, x, jblk, pblk, heads=1, concat=True):
    fconv, pconv, from_flax = conv_pair(family, heads, concat)
    params = fconv.init(jax.random.PRNGKey(0), jnp.asarray(x), jblk)
    want = np.asarray(fconv.apply(params, jnp.asarray(x), jblk))
    top = "gat0" if family == "gat" else "gcn0"
    pconv.load_state_dict(strip(from_flax({top: tree(params)["params"]}),
                                "convs.0."))
    got = pconv(torch.from_numpy(x), pblk)
    width = HIDDEN * heads if (family == "gat" and concat) else HIDDEN
    assert got.shape == (pblk.nbr_local.shape[0], width)
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)
    return got, pconv


@pytest.mark.parametrize("heads,concat", [(1, True), (1, False), (2, True),
                                          (2, False)])
def test_gatconv_matches_flax(data, heads, concat):
    jb, pblocks, x, _ = data
    check_conv("gat", x, jb.layers[0], pblocks[0], heads, concat)


def test_gcnconv_matches_flax(data):
    jb, pblocks, x, _ = data
    check_conv("gcn", x, jb.layers[0], pblocks[0])


@pytest.mark.parametrize("family", ["gat", "gcn"])
def test_fully_masked_rows(data, family):
    """Targets with every slot masked: GAT keeps only the self loop, GCN
    only its own row (norm 1); both equal Flax, and gradients are
    finite."""
    jb, _, x, _ = data
    (jblk,), (pblk,) = port_blocks(jb.layers[:1], drop_every=3)
    got, pconv = check_conv(family, x, jblk, pblk, heads=2)
    assert not pblk.mask[::3].any()
    got.sum().backward()
    assert torch.isfinite(got).all()
    for name, p in pconv.named_parameters():
        assert torch.isfinite(p.grad).all(), name


def flax_model(family, x, blocks, dropout=0.0):
    if family == "gat":
        model = FlaxGAT(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                        heads=2, dropout=dropout)
    else:
        model = FlaxGCN(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                        dropout=dropout)
    return model, model.init(jax.random.PRNGKey(1), jnp.asarray(x), blocks)


def port_model(family, params=None, dropout=0.0):
    if family == "gat":
        m = qt.GAT(D, HIDDEN, CLASSES, num_layers=3, heads=2,
                   dropout=dropout, device="cpu")
        conv = qt.gat_params_from_flax
    else:
        m = qt.GCN(D, HIDDEN, CLASSES, num_layers=3, dropout=dropout,
                   device="cpu")
        conv = qt.gcn_params_from_flax
    if params is not None:
        m.load_state_dict(conv(tree(params)))
    return m


TO_FLAX = {"gat": qt.gat_params_to_flax, "gcn": qt.gcn_params_to_flax}


@pytest.mark.parametrize("family", ["gat", "gcn"])
def test_model_logits_match_flax(data, family):
    jb, pblocks, x, _ = data
    fm, params = flax_model(family, x, jb.layers)
    want = np.asarray(fm.apply(params, jnp.asarray(x), jb.layers))
    m = port_model(family, params)
    m.eval()
    got = m(torch.from_numpy(x), pblocks)
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("family", ["gat", "gcn"])
def test_converters_round_trip(data, family):
    """Flax -> port -> Flax gives the same tree, and port -> Flax -> port
    the same state_dict."""
    jb, _, x, _ = data
    _, params = flax_model(family, x, jb.layers)
    want = tree(params)
    got = TO_FLAX[family](port_model(family, params))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    m = port_model(family)
    m2 = port_model(family)
    m2.load_state_dict(port_model(family, TO_FLAX[family](m)).state_dict())
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="not a"):
        (qt.gcn_params_from_flax if family == "gat"
         else qt.gat_params_from_flax)(want)


@pytest.mark.parametrize("family", ["gat", "gcn"])
def test_train_steps_match_jax(data, family):
    """1 and 3 Adam steps at 3e-3, dropout 0, a padded label tail."""
    jb, pblocks, x, lab = data
    mask = np.arange(B) < B - 7
    fm, params = flax_model(family, x, jb.layers)
    state = JaxState.create(params, optax.adam(3e-3))
    jstep = jax_train_step(
        lambda p, x, blocks, train=False, rngs=None: fm.apply(
            p, x, blocks, train=train, rngs=rngs), optax.adam(3e-3))
    m = port_model(family, params)
    pstep = qt.make_train_step(m, torch.optim.Adam(m.parameters(), lr=3e-3))
    for i in range(3):
        state, jloss = jstep(state, jnp.asarray(x), jb.layers,
                             jnp.asarray(lab), jnp.asarray(mask),
                             jax.random.PRNGKey(i))
        ploss = pstep(torch.from_numpy(x), pblocks, torch.from_numpy(lab),
                      torch.from_numpy(mask))
        np.testing.assert_allclose(float(ploss), float(jloss), **LOSS_TOL)
        if i in (0, 2):
            want = jax.tree_util.tree_leaves_with_path(tree(state.params))
            got = dict(jax.tree_util.tree_leaves_with_path(
                TO_FLAX[family](m)))
            assert len(got) == len(want)
            for path, leaf in want:
                np.testing.assert_allclose(
                    got[path], leaf, rtol=0, atol=PARAM_ATOL,
                    err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", ["gat", "gcn"])
def test_dropout_follows_the_generator(data, family):
    """In training, dropout masks come from the step's generator: the same
    seed gives the same logits, another seed others."""
    _, pblocks, x, _ = data
    torch.manual_seed(0)
    m = port_model(family, dropout=0.5)
    m.train()
    xt = torch.from_numpy(x)
    outs = [m(xt, pblocks, generator=torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    m.eval()
    assert torch.equal(m(xt, pblocks), m(xt, pblocks))
    with pytest.raises(ValueError, match="blocks"):
        m(xt, pblocks[:2])


# -- dtype=: bf16 compute, fp32 parameters (A5) ----------------------------
# XLA's CPU bf16 and torch's CPU bf16 both compute each dense product with
# fp32 accumulation and one rounding to bf16; the masked sums and means of
# a bf16 layer input could still round in another order.  On these inputs
# every bf16 layer output is bitwise Flax's and GAT's fp32 scores differ in
# the last fp32 bit, so BF16_TOL allows one bf16 ulp (2**-7 of the value)
# for a rounding flip, and no more (ROADMAP §C).
BF16_TOL = dict(rtol=2**-7, atol=1e-5)
FLAX_BF16 = {
    "sage": lambda: FlaxSAGE(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                             dropout=0.0, dtype=jnp.bfloat16),
    "gat": lambda: FlaxGAT(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                           heads=2, dropout=0.0, dtype=jnp.bfloat16),
    "gcn": lambda: FlaxGCN(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                           dropout=0.0, dtype=jnp.bfloat16),
}
CONV_NAMES = {"sage": "conv", "gat": "gat", "gcn": "gcn"}


def port_bf16(family, params):
    kw = dict(num_layers=3, dropout=0.0, device="cpu", dtype=torch.bfloat16)
    if family == "sage":
        m, conv = qt.GraphSAGE(D, HIDDEN, CLASSES, **kw), \
            qt.sage_params_from_flax
    elif family == "gat":
        m, conv = qt.GAT(D, HIDDEN, CLASSES, heads=2, **kw), \
            qt.gat_params_from_flax
    else:
        m, conv = qt.GCN(D, HIDDEN, CLASSES, **kw), qt.gcn_params_from_flax
    m.load_state_dict(conv(tree(params)))
    return m


@pytest.mark.parametrize("family", ["sage", "gat", "gcn"])
def test_bf16_models_match_flax_layer_by_layer(data, family):
    """``dtype=torch.bfloat16`` against Flax's ``dtype=jnp.bfloat16`` on
    the same blocks and parameters: each conv's output and the logits
    within BF16_TOL, in Flax's dtypes (GraphSAGE's layers are bf16; GAT's
    and GCN's promote to fp32 through their fp32 attention vectors and
    masks, as in JAX), with fp32 parameters."""
    jb, pblocks, x, _ = data
    fm = FLAX_BF16[family]()
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x), jb.layers)
    want, inter = fm.apply(params, jnp.asarray(x), jb.layers,
                           capture_intermediates=True,
                           mutable=["intermediates"])
    m = port_bf16(family, params)
    m.eval()
    assert all(p.dtype == torch.float32 for p in m.parameters())
    outs = []
    hooks = [c.register_forward_hook(lambda mod, i, o: outs.append(o))
             for c in m.convs]
    got = m(torch.from_numpy(x), pblocks)
    for h in hooks:
        h.remove()
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    for i, out in enumerate(outs):
        ref = inter["intermediates"][f"{CONV_NAMES[family]}{i}"][
            "__call__"][0]
        assert str(out.dtype).split(".")[-1] == str(ref.dtype), i
        np.testing.assert_allclose(
            out.detach().float().numpy(),
            np.asarray(ref.astype(jnp.float32)), **BF16_TOL,
            err_msg=f"layer {i}")
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_bfloat16_models_train(data):
    """``tests/test_models.py::test_bfloat16_models_train`` on the port:
    finite bf16 logits, fp32 parameters, and Adam lowers the loss."""
    jb, pblocks, x, lab = data
    m = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=3, dropout=0.0,
                     device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    xt = torch.from_numpy(x)
    out = m(xt, pblocks)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    opt = torch.optim.Adam(m.parameters(), lr=1e-2)
    labels = torch.from_numpy(lab).long()

    def loss():
        return torch.nn.functional.cross_entropy(
            m(xt, pblocks).float(), labels)

    with torch.no_grad():
        l0 = float(loss())
    for _ in range(8):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        assert float(loss()) < l0
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_serving_reads_bf16_logits_back_widened():
    """numpy has no bfloat16: a bf16 model's answers come back as fp32,
    widened exactly (ROADMAP §C)."""
    from quiver_tpu_torch.serving import _host_logits

    y = torch.randn(5, 3).to(torch.bfloat16)
    got = _host_logits(y)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, y.float().numpy())
    assert _host_logits(torch.ones(2)).dtype == np.float32
