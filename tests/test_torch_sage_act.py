"""GraphSAGE's hidden-layer activation (``ops/cuda/sage_act.py``) on the
CPU: the plain versions the kernels are held to on the card, the autograd
Function that binds them, and ``GraphSAGE``'s fused route against the op
chain it replaces (the add, ``F.relu``, ``_dropout``'s product and
division, and autograd's backward of them), bit for bit.

The fused route runs on the card only; here ``sage._act_kernel_takes`` is
patched to take CPU tensors, so that the route runs through the plain
versions.  The kernels themselves are held to the plain versions and to the
chain on the card by ``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from quiver_tpu import telemetry as jtel

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.models import sage as sage_mod
from quiver_tpu_torch.ops.cuda import sage_act as sa
from quiver_tpu_torch.resilience import qos as pqos

_JAX_TELEMETRY_DEFAULT = jtel.enabled()
DTYPES = [torch.float32, torch.bfloat16]
PS = [0.5, 0.3, 0.1]
SPECIAL = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, -1.5,
           2.5, 1e-30, -1e-30, 3.0e38, -3.0e38, 0.7]


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


def _inputs(dtype, seed, h=7):
    """Addends holding every pair of ``SPECIAL`` values, then normal
    draws of both signs; a 0/1 keep mask drawn at 1 - 0.4."""
    g = torch.Generator().manual_seed(seed)
    s = torch.tensor(SPECIAL)
    pairs = torch.cartesian_prod(s, s)
    n = pairs.shape[0] + 3 * h
    n += -n % h
    a = torch.randn(n, generator=g)
    b = torch.randn(n, generator=g)
    a[:pairs.shape[0]], b[:pairs.shape[0]] = pairs[:, 0], pairs[:, 1]
    keep = torch.empty(n).bernoulli_(0.6, generator=g)
    return (a.view(-1, h).to(dtype), b.view(-1, h).to(dtype),
            keep.view(-1, h).to(dtype))


def _chain(a, b, keep, p):
    """The activation as ``GraphSAGE`` ran it before the kernel."""
    return F.relu(a + b) * keep / (1.0 - p)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_is_the_chain_bitwise(dtype, p):
    a, b, keep = _inputs(dtype, 1)
    y, code = sa.sage_act(a, b, keep, p)
    want = _chain(a, b, keep, p)
    assert y.dtype == dtype and code.dtype == torch.uint8
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(sa.SageAct.apply(a, b, keep, p)), _bits(want))
    r = F.relu(a + b)
    assert torch.equal(code & 1, (~(r <= 0)).to(torch.uint8))
    assert torch.equal(code >> 1, (keep != 0).to(torch.uint8))
    # NaN passes ReLU's gate; a sum at or below 0 (-0.0 too) shuts it
    nan = torch.isnan(r)
    assert bool(nan.any()) and bool((code[nan] & 1).all())
    assert not bool((code[(a + b) <= 0] & 1).any())


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gradient_is_the_chains_bitwise(dtype, p):
    """Both addends' gradients through ``SageAct`` equal autograd's of the
    chain, for ``dy`` of both signs and the special values."""
    a, b, keep = _inputs(dtype, 2)
    dy = torch.randn(a.shape, generator=torch.Generator().manual_seed(3))
    dy[0, :4] = torch.tensor([-0.0, 0.0, -1e-30, 3.0e38])
    dy = dy.to(dtype)
    assert bool((dy < 0).any()) and bool((dy > 0).any())
    got = torch.autograd.grad(
        sa.SageAct.apply(a.requires_grad_(), b.requires_grad_(), keep, p),
        (a, b), dy)
    want = torch.autograd.grad(_chain(a, b, keep, p), (a, b), dy)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(_bits(g), _bits(w))
    _, code = sa.sage_act(a.detach(), b.detach(), keep, p)
    assert torch.equal(_bits(sa.sage_act_backward(dy, code, p)),
                       _bits(want[0]))


def test_function_saves_the_code_alone():
    a, b, keep = _inputs(torch.float32, 4)
    y = sa.SageAct.apply(a.requires_grad_(), b, keep, 0.5)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.uint8
    assert saved[0].shape == a.shape


def test_scale_is_the_fp32_reciprocal():
    """The scale the kernel multiplies by: ``1 - p`` rounded to fp32, its
    reciprocal taken in fp32 (``inf`` at ``p = 1``)."""
    assert sa._scale(0.5) == 2.0 and sa._scale(0.0) == 1.0
    want = np.float32(1.0) / np.float32(0.7)
    assert sa._scale(0.3) == float(want) != 1.0 / 0.7
    assert sa._scale(1.0) == float("inf")


def test_cpu_tensors_launch_no_kernel():
    a, b, keep = _inputs(torch.float32, 5)
    before = (sa.sage_act.launches, sa.sage_act_backward.launches)
    y = sa.SageAct.apply(a.requires_grad_(), b, keep, 0.5)
    y.sum().backward()
    assert (sa.sage_act.launches, sa.sage_act_backward.launches) == before


def _batch(seed=1):
    indptr, indices = qt.synthetic_csr(500, 6000, seed=seed)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    batch = qt.GraphSageSampler(topo, [5, 4, 3], device="cpu").sample(
        np.arange(0, 500, 9), key_words=np.array([[1, 2], [3, 4], [5, 6]],
                                                  np.uint32))
    feat = torch.randn((int(batch.n_id.shape[0]), 12),
                       generator=torch.Generator().manual_seed(seed))
    return batch, feat


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


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_graph_sage_fused_route_is_the_chain_bitwise(monkeypatch, dtype):
    """A three-layer GraphSAGE in training, dropout 0.5, a seeded
    generator: the fused route (both hidden layers' activations, here each
    with the next layer's mean through ``SageActMean``, as the positional
    blocks of the default sampler allow) gives the chain's logits and
    every parameter's gradient bit for bit, and leaves the generator where
    the chain leaves it.  ``tests/test_torch_sage_act_mean.py`` holds the
    route through ``SageAct`` alone to the chain likewise."""
    batch, feat = _batch()
    torch.manual_seed(3)
    old = qt.GraphSAGE(12, 16, 5, num_layers=3, dropout=0.5, device="cpu",
                       dtype=dtype)
    new = copy.deepcopy(old)
    ga = torch.Generator().manual_seed(11)
    y_old = old(feat, batch.layers, generator=ga)
    assert "SageActBackward" not in _nodes(y_old)
    monkeypatch.setattr(sage_mod, "_act_kernel_takes", lambda t: True)
    gb = torch.Generator().manual_seed(11)
    y_new = new(feat, batch.layers, generator=gb)
    assert _nodes(y_new).count("SageActMeanBackward") == 2
    assert torch.equal(_bits(y_new), _bits(y_old))
    assert torch.equal(ga.get_state(), gb.get_state())
    dy = torch.randn(y_old.shape, generator=torch.Generator().manual_seed(4))
    g_old = torch.autograd.grad(y_old, list(old.parameters()), dy.to(y_old))
    g_new = torch.autograd.grad(y_new, list(new.parameters()), dy.to(y_new))
    for (name, _), a, b in zip(old.named_parameters(), g_old, g_new):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["eval", "no dropout"])
def test_eval_and_no_dropout_take_no_kernel(monkeypatch, case):
    """Where the kernel would take the tensors, evaluation and dropout 0
    still run the chain: no ``SageAct`` node, no launch, and the same
    logits as the unpatched model."""
    batch, feat = _batch(2)
    torch.manual_seed(5)
    model = qt.GraphSAGE(12, 16, 5, num_layers=3,
                         dropout=0.0 if case == "no dropout" else 0.5,
                         device="cpu")
    if case == "eval":
        model.eval()
    want = model(feat, batch.layers)
    monkeypatch.setattr(sage_mod, "_act_kernel_takes", lambda t: True)
    before = (sa.sage_act.launches, sa.sage_act_backward.launches)
    y = model(feat, batch.layers)
    y.sum().backward()
    assert not {"SageActBackward", "SageActMeanBackward"} & set(_nodes(y))
    assert (sa.sage_act.launches, sa.sage_act_backward.launches) == before
    assert torch.equal(y, want)


def test_cpu_training_runs_the_chain():
    """On the CPU the model in training runs the chain itself."""
    batch, feat = _batch(3)
    model = qt.GraphSAGE(12, 16, 5, num_layers=3, dropout=0.5, device="cpu")
    y = model(feat, batch.layers, generator=torch.Generator().manual_seed(1))
    names = _nodes(y)
    assert not {"SageActBackward", "SageActMeanBackward"} & set(names)
    assert names.count("ReluBackward0") == 2


def test_sage_conv_is_its_addends_sum():
    batch, feat = _batch(4)
    conv = qt.SAGEConv(12, 8, device="cpu")
    a, b = conv.addends(feat, batch.layers[0])
    assert torch.equal(conv(feat, batch.layers[0]), a + b)
