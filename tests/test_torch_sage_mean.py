"""SAGE's neighbour mean (``ops/cuda/sage_mean.py``) on the CPU: the plain
versions the kernels are held to on the card, the autograd Function that
binds them, and ``SAGEConv``/``GraphSAGE`` against the formula they ran
before the kernels (an index, a broadcast mask, a sum and a divide, with
autograd's backward)."""

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops.cuda import sage_mean as sm
from quiver_tpu_torch.sampler import LayerBlock


def _formula(x, nbr, mask):
    """The pre-kernel ``SAGEConv`` mean and self rows."""
    t, k = nbr.shape
    x_src = x.index_select(0, nbr.reshape(-1).long())
    x_src = x_src.reshape(t, k, x.shape[1])
    m = mask[..., None].to(x.dtype)
    cnt = torch.clamp_min(m.sum(dim=1), 1.0)
    return (x_src * m).sum(dim=1) / cnt, x[:t]


def _block(t, k, seed, unique=True, p=0.8):
    """A ``[t, k]`` block: the pipeline's layout (``t + b*k + j`` where
    valid, 0 where masked) or repeated rows (``unique=False``, as under
    ``dedup="hop"``); target 1 has no valid slot.  Returns the rows of x
    the block indexes, too."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((t, k), generator=g) < p
    mask[1:2] = False
    if unique:
        pos = torch.arange(t * k, dtype=torch.int32).view(t, k) + t
        return torch.where(mask, pos, torch.zeros_like(pos)), mask, t + t * k
    n = max(t, 1)
    return torch.randint(0, n, (t, k), generator=g,
                         dtype=torch.int32), mask, n


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("shape", [(40, 5, 7), (9, 1, 3), (6, 37, 4),
                                   (0, 3, 5), (4, 0, 2)])
def test_plain_mean_equals_the_formula(shape, unique):
    t, k, d = shape
    nbr, mask, n = _block(t, k, t + k, unique)
    x = torch.randn((n, d), generator=torch.Generator().manual_seed(d))
    got = sm.sage_mean(x, nbr, mask)
    want, _ = _formula(x, nbr, mask)
    assert got.shape == (t, d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_plain_mean_adds_in_slot_order():
    """fp32 sums in slot order, exactly: 1e8 + 1 - 1e8 is 0 in fp32 taken
    left to right (a pairwise sum would give 1)."""
    x = torch.tensor([[1e8], [1.0], [-1e8], [0.0]])
    nbr = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False]])
    assert sm.sage_mean_plain(x, nbr, mask).item() == 0.0


def test_bf16_rounds_the_sum_once_then_divides():
    """bf16 rows: the sum in fp32 rounded once to bf16, then divided by the
    count in bf16, within one bf16 rounding of the old formula."""
    g = torch.Generator().manual_seed(5)
    nbr, mask, n = _block(64, 7, 3)
    x = torch.randn((n, 16), generator=g).to(torch.bfloat16)
    got = sm.sage_mean(x, nbr, mask)
    assert got.dtype == torch.bfloat16
    acc = torch.zeros((64, 16))
    for j in range(7):
        acc += torch.where(mask[:, j, None], x[nbr[:, j].long()].float(), 0)
    cnt = mask.sum(1, keepdim=True).clamp_min(1).to(torch.bfloat16)
    assert torch.equal(got, acc.to(torch.bfloat16) / cnt)
    want, _ = _formula(x, nbr, mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=0)


def test_masked_slots_add_nothing_not_even_nan():
    """A masked slot's row never reaches the mean or the gradient, even a
    non-finite one (the formula multiplied it by 0 and got NaN)."""
    x = torch.tensor([[float("nan")], [2.0], [4.0]], requires_grad=True)
    nbr = torch.tensor([[1, 0], [2, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, False], [True, True]])
    mean, _ = sm.sage_aggregate(x, nbr, mask)
    assert mean.detach().tolist() == [[2.0], [3.0]]
    mean.sum().backward()
    assert x.grad.tolist() == [[0.0], [1.5], [0.5]]


def test_fully_masked_targets_give_zeros_and_no_gradient():
    nbr, mask, n = _block(12, 4, 7)
    mask[5] = False
    x = torch.randn((n, 3), requires_grad=True)
    mean, _ = sm.sage_aggregate(x, nbr, mask)
    assert not bool(mean[1].any()) and not bool(mean[5].any())
    (mean * torch.arange(12.0)[:, None]).sum().backward()
    touched = torch.zeros(n, dtype=torch.bool)
    touched[nbr[mask].long()] = True
    assert not bool(x.grad[~touched].any())
    grad = torch.zeros(12, 3)
    grad[[1, 5]] = 1.0
    g = sm.sage_mean_backward(grad, nbr, mask, n)
    assert not bool(g.any())


def test_repeated_rows_accumulate():
    """A row at several valid slots (``dedup="hop"``) takes each slot's
    share of the gradient: the backward equals autograd's of the
    formula."""
    nbr, mask, n = _block(30, 6, 11, unique=False)
    assert int(torch.bincount(nbr[mask].long()).max()) > 1
    x = torch.randn((n, 5), dtype=torch.float64)
    grad = torch.randn((30, 5), dtype=torch.float64)
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad(_formula(xr, nbr, mask)[0], xr, grad)
    got = sm.sage_mean_backward(grad, nbr, mask, n)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("unique", [True, False])
def test_gradcheck_float64(unique):
    nbr, mask, n = _block(6, 4, 2, unique)
    x = torch.randn((n, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: sm.SageMean.apply(x, nbr, mask), (x,))
    assert torch.autograd.gradcheck(
        lambda x: sm.SageMean.apply(x, nbr, mask)[0], (x,))


def test_self_rows_share_the_gradient_buffer():
    """The Function's self output is ``x[:T]``; its gradient and the
    mean's land in one ``[N, D]`` gradient, equal to the formula's (a
    slice and an ``index_add`` summed by autograd)."""
    nbr, mask, n = _block(20, 5, 4)
    x = torch.randn((n, 6), dtype=torch.float64)
    g_mean = torch.randn((20, 6), dtype=torch.float64)
    g_self = torch.randn((20, 6), dtype=torch.float64)
    xa = x.clone().requires_grad_()
    mean, x_self = sm.SageMean.apply(xa, nbr, mask)
    assert torch.equal(x_self.detach(), x[:20])
    torch.autograd.backward((mean, x_self), (g_mean, g_self))
    xb = x.clone().requires_grad_()
    torch.autograd.backward(_formula(xb, nbr, mask), (g_mean, g_self))
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)
    # the self output alone
    xc = x.clone().requires_grad_()
    (sm.SageMean.apply(xc, nbr, mask)[1] * g_self).sum().backward()
    want = torch.zeros_like(x)
    want[:20] = g_self
    assert torch.equal(xc.grad, want)
    assert torch.equal(
        sm.sage_mean_backward(g_mean, nbr, mask, n, g_self),
        xa.grad)


def test_forward_only_makes_no_function_node():
    nbr, mask, n = _block(8, 3, 1)
    x = torch.randn((n, 4))
    mean, x_self = sm.sage_aggregate(x, nbr, mask)
    assert mean.grad_fn is None and x_self.data_ptr() == x.data_ptr()
    xr = x.clone().requires_grad_()
    with torch.no_grad():
        mean, _ = sm.sage_aggregate(xr, nbr, mask)
    assert mean.grad_fn is None


def test_cpu_tensors_launch_no_kernel():
    nbr, mask, n = _block(8, 3, 1)
    x = torch.randn((n, 4), requires_grad=True)
    before = (sm.sage_mean.launches, sm.sage_mean_backward.launches)
    mean, x_self = sm.sage_aggregate(x, nbr, mask)
    (mean.sum() + x_self.sum()).backward()
    assert (sm.sage_mean.launches, sm.sage_mean_backward.launches) == before


def _conv_formula(conv, x, block, edge_feat=None):
    """``SAGEConv.forward`` as it ran before the kernels."""
    mean, x_self = _formula(x, block.nbr_local, block.mask)
    if edge_feat is not None:
        m = block.mask[..., None].to(x.dtype)
        cnt = torch.clamp_min(m.sum(dim=1), 1.0)
        mean = torch.cat([mean, (edge_feat.to(x.dtype) * m).sum(1) / cnt],
                         dim=-1)
    return conv.lin_self(x_self) + conv.lin_nbr(mean)


@pytest.mark.parametrize("edge", [False, True])
def test_sage_conv_equals_the_formula(edge):
    """Outputs and every gradient (parameters and input) within fp32
    summation-order tolerance; the ``edge_feat`` half is the formula's."""
    torch.manual_seed(0)
    nbr, mask, n = _block(32, 6, 9)
    block = LayerBlock(nbr, mask, torch.tensor(32, dtype=torch.int32))
    conv = qt.SAGEConv(10, 8, edge_dim=3 if edge else 0, device="cpu")
    efeat = torch.randn((32, 6, 3)) if edge else None
    x = torch.randn((n, 10))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = conv(xa, block, efeat)
    ga = torch.autograd.grad(ya.square().sum(), [xa, *conv.parameters()])
    yb = _conv_formula(conv, xb, block, efeat)
    gb = torch.autograd.grad(yb.square().sum(), [xb, *conv.parameters()])
    torch.testing.assert_close(ya, yb, rtol=1e-5, atol=1e-6)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_graph_sage_equals_the_formula():
    """A three-layer GraphSAGE over a sampled batch (no dropout): logits
    and every parameter's gradient within fp32 summation-order tolerance
    of the same model with the pre-kernel mean."""
    indptr, indices = qt.synthetic_csr(500, 6000, seed=1)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    batch = qt.GraphSageSampler(topo, [5, 4, 3], device="cpu").sample(
        np.arange(0, 500, 9), key_words=np.array([[1, 2], [3, 4], [5, 6]],
                                                  np.uint32))
    feat = torch.randn((int(batch.n_id.shape[0]), 12))
    torch.manual_seed(3)
    model = qt.GraphSAGE(12, 16, 5, num_layers=3, dropout=0.0, device="cpu")
    y = model(feat, batch.layers)
    grads = torch.autograd.grad(y.square().sum(), list(model.parameters()))

    def old_forward(x):
        for i, blk in enumerate(batch.layers):
            x = _conv_formula(model.convs[i], x, blk)
            if i != 2:
                x = torch.relu(x)
        return x

    y_old = old_forward(feat)
    grads_old = torch.autograd.grad(y_old.square().sum(),
                                    list(model.parameters()))
    torch.testing.assert_close(y, y_old, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, grads_old):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
