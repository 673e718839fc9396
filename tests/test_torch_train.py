"""Port parity: training.  ``make_train_step`` and the fused
``make_fused_train_step`` / ``make_fused_eval_fn`` against the JAX
package's, from the same Flax parameters and a fresh Adam at 3e-3, on the
same sampled batches (JAX: ``gather_mode="xla", sample_rng="hash"``; the
port's fused lane: ``gather_mode="pallas"``, kernel B3's plain version).
Dropout is 0: its bits cannot match Flax's.

Tolerances (fp32): losses ``rtol=1e-5``; parameters after 1 and 3 Adam
steps ``atol=2e-5``, since Adam divides by the square root of the second
moment and so amplifies summation-order differences of near-zero
gradients (the backends sum the neighbour means and matrix products in
different orders); logits ``rtol=atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.parallel.train import TrainState as JaxState
from quiver_tpu.parallel.train import make_train_step as jax_train_step
from quiver_tpu.pipeline import make_fused_eval_fn as jax_fused_eval
from quiver_tpu.pipeline import make_fused_train_step as jax_fused_step
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils import synthetic as jax_synthetic
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.utils import synthetic as port_synthetic

N, D, HIDDEN, CLASSES, B = 2000, 16, 32, 5, 64
SIZES = [6, 4, 3]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 2e-5
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _jax_registry_left_empty():
    """The JAX code this file runs sets gauges and counters in the JAX
    package's registry: empty it when the file ends and set JAX's
    telemetry switch back, so nothing reaches a later file on this
    worker."""
    from quiver_tpu import telemetry as jax_telemetry

    on = jax_telemetry.enabled()
    yield
    jax_telemetry.reset()
    jax_telemetry.set_enabled(on)


def hop_words(key, n_hops):
    return np.array([[int(np.asarray(w)) for w in _fold_key_words(k)]
                     for k in jax.random.split(key, n_hops)], np.uint32)


def apply_fn(model):
    return lambda p, x, blocks, train=False, rngs=None: model.apply(
        p, x, blocks, train=train, rngs=rngs)


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, 20_000, seed=4)
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    return indptr, indices, feat, labels


def flax_params(x, blocks):
    model = FlaxSAGE(hidden=HIDDEN, out_dim=CLASSES, num_layers=3,
                     dropout=0.0)
    return model, model.init(jax.random.PRNGKey(0), x, blocks)


def port_model(params):
    m = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=3, dropout=0.0,
                     device="cpu")
    m.load_state_dict(qt.sage_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m


def assert_params_close(jparams, model):
    want = jax.tree_util.tree_map(np.asarray, jparams)["params"]
    got = qt.sage_params_to_flax(model)["params"]
    assert want.keys() == got.keys()
    for conv in want:
        for lin in want[conv]:
            for leaf in want[conv][lin]:
                np.testing.assert_allclose(
                    got[conv][lin][leaf], want[conv][lin][leaf], rtol=0,
                    atol=PARAM_ATOL, err_msg=f"{conv}.{lin}.{leaf}")


def test_flax_round_trip(data):
    _, _, feat, _ = data
    m = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=3, device="cpu")
    tree = qt.sage_params_to_flax(m)
    assert tree["params"]["conv0"]["lin_self"]["kernel"].shape == (D, HIDDEN)
    m2 = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=3, device="cpu")
    m2.load_state_dict(qt.sage_params_from_flax(tree))
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k


def test_train_step_matches_jax(data):
    indptr, indices, feat, labels = data
    ids = np.random.default_rng(1).integers(0, N, B)
    key = make_key(5)
    jb = JaxSampler(JaxTopo(indptr=indptr, indices=indices), SIZES,
                    gather_mode="xla", sample_rng="hash",
                    dedup="none").sample(ids, key=key)
    pb = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                             SIZES, device="cpu", gather_mode="lanes_fused"
                             ).sample(ids, key_words=hop_words(key, 3))
    np.testing.assert_array_equal(np.asarray(jb.n_id), pb.n_id.numpy())
    jx = jnp.asarray(feat[np.asarray(jb.n_id)])
    px = torch.from_numpy(feat[pb.n_id.numpy()])
    lab = labels[ids]
    mask = np.arange(B) < B - 9  # a padded tail

    flax, params = flax_params(jx, jb.layers)
    state = JaxState.create(params, optax.adam(3e-3))
    jstep = jax_train_step(apply_fn(flax), optax.adam(3e-3))
    model = port_model(params)
    ts = qt.TrainState.create(model, lr=3e-3)
    pstep = qt.make_train_step(ts.model, ts.optimizer)
    for i in range(3):
        state, jloss = jstep(state, jx, jb.layers, jnp.asarray(lab),
                             jnp.asarray(mask), jax.random.PRNGKey(i))
        ploss = pstep(px, pb.layers, torch.from_numpy(lab),
                      torch.from_numpy(mask))
        assert ploss.dim() == 0 and not ploss.requires_grad
        np.testing.assert_allclose(float(ploss), float(jloss), **LOSS_TOL)
        if i in (0, 2):
            assert_params_close(state.params, model)


def test_fused_step_and_eval_match_jax(data):
    indptr, indices, feat, labels = data
    jtopo = JaxTopo(indptr=indptr, indices=indices)
    ptopo = qt.CSRTopo(indptr=indptr, indices=indices)
    js = JaxSampler(jtopo, SIZES, gather_mode="xla", sample_rng="hash",
                    dedup="none")
    jf = JaxFeature(device_cache_size=feat.nbytes, csr_topo=jtopo
                    ).from_cpu_tensor(feat)
    # JAX caches its device copy of feature_order at the first
    # lookup_device call; made inside the jitted step, the cache would
    # hold a tracer
    jf.lookup_device(jnp.arange(2, dtype=jnp.int32))
    ps = qt.GraphSageSampler(ptopo, SIZES, device="cpu", gather_mode="pallas")
    pf = qt.Feature(device_cache_size=feat.nbytes, csr_topo=ptopo,
                    device="cpu").from_cpu_tensor(feat)
    rng = np.random.default_rng(2)
    ids0 = rng.integers(0, N, B)
    b0 = js.sample(ids0, key=make_key(1))
    flax, params = flax_params(jf[np.asarray(b0.n_id)], b0.layers)
    state = JaxState.create(params, optax.adam(3e-3))
    jstep = jax_fused_step(js, jf, apply_fn(flax), optax.adam(3e-3))
    model = port_model(params)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    pstep = qt.make_fused_train_step(ps, pf, model, opt)
    ones = np.ones(B, bool)
    for i in range(3):
        ids = rng.integers(0, N, B)
        key = make_key(100 + i)
        ks, _ = jax.random.split(key)
        state, jloss = jstep(state, jnp.asarray(ids, jnp.int32),
                             jnp.asarray(labels[ids]), jnp.asarray(ones), key)
        ploss = pstep(ids, torch.from_numpy(labels[ids]),
                      torch.from_numpy(ones), hop_words(ks, 3))
        np.testing.assert_allclose(float(ploss), float(jloss), **LOSS_TOL)
    assert_params_close(state.params, model)

    key = make_key(7)
    want = jax_fused_eval(js, jf, apply_fn(flax))(state.params,
                                                  jnp.asarray(ids0), key)
    got = qt.make_fused_eval_fn(ps, pf, model)(ids0, hop_words(key, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert not model.training


def test_loss_falls_over_one_epoch():
    """One epoch of the fused lane (``make_scan_epoch``) on the learnable
    ``community_graph``, dropout 0.5 from the step's generator."""
    topo, feat, labels = qt.community_graph(3000, 6, feat_extra=10, seed=3)
    sampler = qt.GraphSageSampler(topo, [5, 5], device="cpu", seed=1,
                                  gather_mode="pallas")
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    torch.manual_seed(0)
    model = qt.GraphSAGE(feat.shape[1], 32, 6, num_layers=2, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    epoch = qt.make_scan_epoch(sampler, feature, model, opt)
    order = np.random.default_rng(0).permutation(3000)[:2048]
    seeds = order.reshape(16, 128)
    losses = epoch(seeds, torch.from_numpy(labels[seeds]))
    assert losses.shape == (16,) and torch.isfinite(losses).all()
    assert losses[-4:].mean() < 0.95 * losses[:4].mean(), losses


def test_dropout_follows_the_step_seed(data):
    indptr, indices, feat, labels = data
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    sampler = qt.GraphSageSampler(topo, [4, 3], device="cpu")
    feature = qt.Feature(device_cache_size=feat.nbytes, device="cpu"
                         ).from_cpu_tensor(feat)
    ids = np.arange(B)
    kw = np.array([[1, 2], [3, 4]], np.uint32)
    losses = []
    for seed in (5, 5, 6):
        torch.manual_seed(0)
        m = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=2, dropout=0.5,
                         device="cpu")
        step = qt.make_fused_train_step(
            sampler, feature, m, torch.optim.Adam(m.parameters()), seed=seed)
        losses.append([float(step(ids, torch.from_numpy(labels[ids]),
                                  torch.ones(B, dtype=torch.bool), kw))
                       for _ in range(2)])
    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_refusals(data):
    indptr, indices, feat, _ = data
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    m = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=3, device="cpu")
    opt = torch.optim.Adam(m.parameters())
    # the data-parallel step is ported (test_torch_dist.py); a mesh
    # without the batch's axis is refused
    mesh = qt.make_mesh(("model",), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="axis 'data'"):
        qt.make_train_step(m, opt, mesh=mesh)
    budgeted = qt.Feature(device_cache_size=feat.nbytes // 2,
                          device="cpu").from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, SIZES, device="cpu")
    for make in (lambda: qt.make_fused_train_step(sampler, budgeted, m, opt),
                 lambda: qt.make_fused_eval_fn(sampler, budgeted, m),
                 lambda: qt.make_scan_epoch(sampler, budgeted, m, opt)):
        with pytest.raises(ValueError, match="whole feature table"):
            make()


def test_synthetic_generators_match_jax(monkeypatch):
    """``community_graph`` returns JAX's arrays; ``synthetic_products`` and
    ``synthetic_reddit`` ask ``synthetic_csr`` for JAX's sizes (recorded
    through a stub, since the real graphs take gigabytes)."""
    jt, jfeat, jlab = jax_synthetic.community_graph(500, 7, feat_extra=3,
                                                    seed=9)
    pt, pfeat, plab = qt.community_graph(500, 7, feat_extra=3, seed=9)
    np.testing.assert_array_equal(jt.indptr, pt.indptr)
    np.testing.assert_array_equal(jt.indices, pt.indices)
    np.testing.assert_array_equal(jfeat, pfeat)
    np.testing.assert_array_equal(jlab, plab)
    calls = {}
    for mod in (jax_synthetic, port_synthetic):
        got = calls[mod.__name__] = []

        def stub(n_nodes, n_edges, seed=0, got=got):
            got.append((n_nodes, n_edges, seed))
            return np.array([0, 1, 1]), np.array([1], np.int32)

        monkeypatch.setattr(mod, "synthetic_csr", stub)
        mod.synthetic_products(3)
        mod.synthetic_reddit(4)
    assert list(calls.values()) == 2 * [
        [(2_449_029, 123_718_280, 3), (232_965, 11_606_919, 4)]]
