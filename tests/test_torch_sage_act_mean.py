"""A hidden GraphSAGE layer's activation fused with the next layer's
neighbour mean (``ops/cuda/sage_act_mean.py``) on the CPU: the plain
versions the kernels are held to on the card and the autograd Function
that binds them, against the chain they replace (``SageAct``, then
``SageMean`` over the positional ``nbr_local``), bit for bit; which
samplers declare the positional layout (``LayerBlock.positional``); and
``GraphSAGE``'s choice of route.

The fused route runs on the card only; here ``sage._act_kernel_takes`` is
patched to take CPU tensors, so that the route runs through the plain
versions.  The kernels themselves are held to the chain on the card by
``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.dist.sampler import DistGraphSampler
from quiver_tpu_torch.models import sage as sage_mod
from quiver_tpu_torch.ops.cuda import sage_act as sa
from quiver_tpu_torch.ops.cuda import sage_act_mean as sam
from quiver_tpu_torch.ops.cuda import sage_mean as sm
from quiver_tpu_torch.ops.cuda.build import KernelArgumentError
from quiver_tpu_torch.resilience import qos as pqos
from quiver_tpu_torch.stream import StreamingGraph

_JAX_TELEMETRY_DEFAULT = jtel.enabled()
DTYPES = [torch.float32, torch.bfloat16]
# (targets, slots a target, width): products' fanouts at fewer targets,
# one slot, and over a warp's 32 slots
SHAPES = [(9, 5, 10), (6, 10, 16), (4, 15, 8), (7, 1, 3), (3, 33, 5)]
SPECIAL = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, -1.5,
           2.5, 1e-30, -1e-30, 3.0e38, -3.0e38, 0.7]
WORDS = np.array([[1, 2], [3, 4], [5, 6]], np.uint32)


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, tracers and recorders, and the port's
    QoS controller, start and end empty, with retention off; JAX's
    telemetry is back at its process default after."""
    for tel in (ptel, jtel):
        tel.set_enabled(True)
        tel.reset()
    pqos.reset()
    ptel.get_tracer().set_tracing(False)
    yield
    ptel.get_tracer().set_tracing(False)
    ptel.set_enabled(True)
    pqos.reset()
    for tel in (ptel, jtel):
        tel.reset()
    jtel.set_enabled(_JAX_TELEMETRY_DEFAULT)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _inputs(dtype, t, k, d, seed):
    """The addends (every pair of ``SPECIAL`` where they fit, then normal
    draws; NaN and +Inf in rows behind masked slots), a keep mask drawn
    at 0.6, a positional ``[t, k]`` block (about a fifth of the slots
    masked, target 0 with none valid) and both output gradients (-0.0 and
    NaN among them)."""
    g = torch.Generator().manual_seed(seed)
    n = t * (1 + k)
    a = torch.randn((n, d), generator=g)
    b = torch.randn((n, d), generator=g)
    s = torch.tensor(SPECIAL)
    pairs = torch.cartesian_prod(s, s)
    m = min(pairs.shape[0], n * d)
    a.view(-1)[:m], b.view(-1)[:m] = pairs[:m, 0], pairs[:m, 1]
    mask = torch.rand((t, k), generator=g) < 0.8
    mask[0] = False
    pos = t + torch.arange(t * k, dtype=torch.int32).view(t, k)
    nbr = torch.where(mask, pos, torch.zeros_like(pos))
    hidden = pos[~mask].long()
    a[hidden] = float("nan")
    b[hidden[::2]] = float("inf")
    keep = torch.empty((n, d)).bernoulli_(0.6, generator=g)
    gm = torch.randn((t, d), generator=g)
    gs = torch.randn((t, d), generator=g)
    gm[-1, :2] = torch.tensor([-0.0, float("nan")])[:d]
    gs[-1, :2] = torch.tensor([-0.0, 0.0])[:d]
    return (a.to(dtype), b.to(dtype), keep.to(dtype), nbr, mask,
            gm.to(dtype), gs.to(dtype))


def _chain(a, b, keep, p, nbr, mask):
    """The two Functions the fused one replaces, as ``GraphSAGE`` chains
    them: ``SageAct``, then ``SageMean`` over its output."""
    return sm.SageMean.apply(sa.SageAct.apply(a, b, keep, p), nbr, mask)


@pytest.mark.parametrize("p", [0.5, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_is_the_chain_bitwise(shape, dtype, p):
    """The mean, the self rows and the code equal ``sage_act`` then
    ``sage_mean`` over the positional rows; a target with no valid slot
    reads +0, and the rows behind masked slots reach nothing."""
    a, b, keep, nbr, mask, _, _ = _inputs(dtype, *shape, seed=sum(shape))
    t = mask.shape[0]
    mean, x_self, code = sam.sage_act_mean(a, b, keep, p, mask)
    y, want_code = sa.sage_act(a, b, keep, p)
    assert mean.dtype == x_self.dtype == dtype and code.dtype == torch.uint8
    assert torch.equal(_bits(mean), _bits(sm.sage_mean(y, nbr, mask)))
    assert torch.equal(_bits(x_self), _bits(y[:t]))
    assert torch.equal(code, want_code)
    assert torch.equal(_bits(mean[0]), _bits(torch.zeros_like(mean[0])))
    hidden = t + torch.arange(mask.numel()).view(mask.shape)[~mask]
    a0, b0 = a.clone(), b.clone()
    a0[hidden], b0[hidden] = 0, 0
    again, _, _ = sam.sage_act_mean(a0, b0, keep, p, mask)
    assert torch.equal(_bits(again), _bits(mean))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_function_is_the_chain_bitwise(shape, dtype):
    """``SageActMean``'s outputs and both addends' gradients equal the
    chain's, -0.0 gradients included; the backward's plain version gives
    the same gradient from the code."""
    a, b, keep, nbr, mask, gm, gs = _inputs(dtype, *shape, seed=7)
    got, want = [], []
    for fused, out in ((True, got), (False, want)):
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        outs = (sam.SageActMean.apply(ar, br, keep, 0.5, mask) if fused
                else _chain(ar, br, keep, 0.5, nbr, mask))
        out.extend(outs + torch.autograd.grad(outs, (ar, br), (gm, gs)))
    for name, x, w in zip(("mean", "x_self", "grad a", "grad b"), got, want):
        assert x.dtype == w.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(_bits(x), _bits(w)), name
    _, _, code = sam.sage_act_mean(a, b, keep, 0.5, mask)
    dx = sam.sage_act_mean_backward(gm, gs, code, mask, 0.5)
    assert torch.equal(_bits(dx), _bits(want[2]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("used", ["mean", "self"])
def test_function_takes_one_output_gradient(dtype, used):
    """Where only the mean or only the self rows reach the loss, the other
    gradient arrives as ``None`` and reads as zeros, as ``SageMean``'s
    backward reads it."""
    a, b, keep, nbr, mask, gm, gs = _inputs(dtype, 6, 10, 16, seed=8)
    pick, g = (0, gm) if used == "mean" else (1, gs)
    grads = []
    for fused in (True, False):
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        outs = (sam.SageActMean.apply(ar, br, keep, 0.5, mask) if fused
                else _chain(ar, br, keep, 0.5, nbr, mask))
        grads.append(torch.autograd.grad(outs[pick], (ar, br), g))
    for x, w in zip(*grads):
        assert torch.equal(_bits(x), _bits(w))


def test_function_saves_the_code_and_mask_alone():
    a, b, keep, _, mask, _, _ = _inputs(torch.float32, 6, 10, 16, seed=9)
    mean, _ = sam.SageActMean.apply(a.requires_grad_(), b, keep, 0.5, mask)
    saved = mean.grad_fn.saved_tensors
    assert [s.dtype for s in saved] == [torch.uint8, torch.bool]
    assert saved[0].shape == a.shape and saved[1] is mask


def test_cpu_tensors_launch_no_kernel():
    a, b, keep, _, mask, gm, gs = _inputs(torch.float32, 6, 10, 16, seed=10)
    fns = (sam.sage_act_mean, sam.sage_act_mean_backward)
    before = [fn.launches for fn in fns]
    outs = sam.SageActMean.apply(a.requires_grad_(), b, keep, 0.5, mask)
    torch.autograd.backward(outs, (gm, gs))
    assert [fn.launches for fn in fns] == before


def test_backward_needs_a_gradient():
    _, _, _, _, mask, _, _ = _inputs(torch.float32, 6, 10, 16, seed=11)
    code = torch.zeros((66, 16), dtype=torch.uint8)
    with pytest.raises(KernelArgumentError):
        sam.sage_act_mean_backward(None, None, code, mask, 0.5)


def _topo(seed=1, n=500, e=6000):
    indptr, indices = qt.synthetic_csr(n, e, seed=seed)
    return qt.CSRTopo(indptr=indptr, indices=indices)


def _positional(blocks, n_id):
    """Whether every block is laid out as the no-dedup pipelines lay it
    out: ``T + b*k + j`` where valid, the hop's frontier ``T * (1 + k)``
    long."""
    n = n_id.shape[0]
    for blk in blocks:  # outermost first: the frontier shrinks
        t, k = blk.mask.shape
        pos = t + torch.arange(t * k, dtype=torch.int32).view(t, k)
        if n != t * (1 + k) or not torch.equal(blk.nbr_local[blk.mask],
                                               pos[blk.mask]):
            return False
        n = t
    return True


@pytest.mark.parametrize("producer", ["pwindow", "pallas", "xla",
                                      "weighted", "overlay"])
def test_no_dedup_pipelines_declare_positional(producer):
    """B1's pipeline entry, the generic no-dedup loop (uniform and
    weighted) and the overlay pipeline set ``positional`` on every block,
    and their blocks are laid out so."""
    topo = _topo()
    kw = dict(gather_mode="xla" if producer in ("weighted", "overlay")
              else producer)
    if producer == "weighted":
        kw["edge_weights"] = np.random.default_rng(1).random(
            topo.indices.shape[0]).astype(np.float32)
    if producer == "overlay":
        topo = StreamingGraph(topo)
    batch = qt.GraphSageSampler(topo, [5, 4, 3], device="cpu",
                                dedup="none", **kw).sample(
        np.arange(0, 500, 9), key_words=WORDS)
    assert [blk.positional for blk in batch.layers] == [True] * 3
    assert _positional(batch.layers, batch.n_id)


@pytest.mark.parametrize("producer", ["hop", "hop capped", "host", "dist"])
def test_other_samplers_declare_no_layout(producer):
    """``dedup="hop"`` (reindexed, capped or not), the native host
    sampler and ``DistGraphSampler`` leave ``positional`` unset."""
    topo = _topo()
    seeds = np.arange(0, 500, 9)
    if producer == "dist":
        mesh = qt.make_mesh(("data",), devices=[torch.device("cpu")] * 2)
        out = DistGraphSampler(topo, mesh, [5, 4, 3]).sample(
            seeds[:48].reshape(2, 24), key_words=np.stack([WORDS] * 2, 1))
        blocks = out[3]
    elif producer == "host":
        blocks = qt.GraphSageSampler(topo, [5, 4, 3], device="cpu",
                                     mode="CPU").sample(seeds).layers
    else:
        caps = [200, 400, 800] if producer == "hop capped" else None
        blocks = qt.GraphSageSampler(topo, [5, 4, 3], device="cpu",
                                     dedup="hop", frontier_caps=caps
                                     ).sample(seeds, key_words=WORDS).layers
    assert len(blocks) == 3
    assert not any(blk.positional for blk in blocks)


def _nodes(y):
    """Every autograd node's class name behind ``y``."""
    seen, todo, names = set(), [y.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("case", ["positional", "hop", "undeclared",
                                  "edge features"])
def test_graph_sage_fuses_declared_blocks_alone(monkeypatch, case):
    """A three-layer GraphSAGE in training, dropout 0.5, with the
    activation's route open: blocks that declare the positional layout
    take ``SageActMean`` at both hidden layers; ``dedup="hop"`` blocks,
    positional blocks whose producer did not declare them, and edge
    features take ``SageAct`` and the mean apart.  Each route's logits and
    gradients are the unpatched chain's bit for bit."""
    topo = _topo(2)
    sampler = qt.GraphSageSampler(
        topo, [5, 4, 3], device="cpu", dedup="hop" if case == "hop"
        else "none", return_eid=case == "edge features")
    batch = sampler.sample(np.arange(0, 500, 9), key_words=WORDS)
    blocks = batch.layers
    if case == "undeclared":
        blocks = tuple(blk._replace(positional=False) for blk in blocks)
    table = None
    if case == "edge features":
        table = torch.randn((topo.indices.shape[0], 3),
                            generator=torch.Generator().manual_seed(5))
    feat = torch.randn((int(batch.n_id.shape[0]), 12),
                       generator=torch.Generator().manual_seed(6))
    torch.manual_seed(7)
    old = qt.GraphSAGE(12, 16, 5, num_layers=3, dropout=0.5, device="cpu",
                       edge_dim=3 if table is not None else 0)
    new = copy.deepcopy(old)
    y_old = old(feat, blocks, table, torch.Generator().manual_seed(11))
    monkeypatch.setattr(sage_mod, "_act_kernel_takes", lambda t: True)
    y_new = new(feat, blocks, table, torch.Generator().manual_seed(11))
    names = _nodes(y_new)
    fused = case == "positional"
    assert names.count("SageActMeanBackward") == (2 if fused else 0)
    assert names.count("SageActBackward") == (0 if fused else 2)
    # layer 0's mean takes no gradient (the feature rows need none)
    assert names.count("SageMeanBackward") == (0 if fused else 2)
    assert torch.equal(_bits(y_new), _bits(y_old))
    dy = torch.randn(y_old.shape, generator=torch.Generator().manual_seed(4))
    g_old = torch.autograd.grad(y_old, list(old.parameters()), dy)
    g_new = torch.autograd.grad(y_new, list(new.parameters()), dy)
    for (name, _), a, b in zip(old.named_parameters(), g_old, g_new):
        assert torch.equal(a, b), name


def test_graph_sage_checks_the_rows_of_a_declared_block(monkeypatch):
    """A declared block whose addends have other than ``T * (1 + k)``
    rows (a padded frontier) takes ``SageAct``: the choice reads the
    rows, not the flag alone."""
    mask = torch.ones((4, 3), dtype=torch.bool)
    blk = qt.LayerBlock(nbr_local=torch.zeros((4, 3), dtype=torch.int32),
                        mask=mask, num_targets=torch.tensor(4),
                        positional=True)
    assert sage_mod._fuses(blk, torch.zeros((16, 2)), None)
    assert not sage_mod._fuses(blk, torch.zeros((17, 2)), None)
    assert not sage_mod._fuses(blk, torch.zeros((16, 2)), torch.zeros(1))
    assert not sage_mod._fuses(blk._replace(positional=False),
                               torch.zeros((16, 2)), None)
