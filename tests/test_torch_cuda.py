"""Kernel tests that need the CUDA card (marker ``cuda``; they skip
without one).  Each hand-written kernel is held against its plain PyTorch
version on the same card tensors, exactly, at small and ragged shapes;
the Reddit-sized shapes run in ``chip_smoke.py``.

Run on a machine with a card (the JAX suite's conftest.py needs flax, which
such a machine may lack):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops.cuda import gather_rows as b2
from quiver_tpu_torch.ops.cuda import window_sample as b1

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _graph(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    deg = np.where(rng.random(n) < 0.2, rng.integers(100, 5000, n),
                   rng.integers(0, 30, n))
    deg[:5] = 0
    deg[9] = 1_000_003
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return qt.CSRTopo(indptr=indptr, indices=indices)


@pytest.mark.parametrize("k", [1, 10, 25, 128])
def test_window_sample_kernel_equals_plain(card, k):
    topo = _graph(k)
    ip, ix = topo.to_device(card)
    rng = np.random.default_rng(k)
    seeds = np.concatenate([np.arange(12), rng.integers(0, 3000, 3000),
                            [2999]]).astype(np.int32)
    seeds = torch.from_numpy(seeds).to(card)
    mask = torch.from_numpy(rng.random(seeds.shape[0]) < 0.7).to(card)
    for m in (mask, None):
        before = b1.window_sample.launches
        got = b1.window_sample(ip, ix, seeds, k, 0xDEADBEEF, 12345, m)
        torch.cuda.synchronize()
        assert b1.window_sample.launches == before + 1
        want = b1.window_sample_plain(ip, ix, seeds, k, 0xDEADBEEF, 12345, m)
        for name, a, b in zip(("nbrs", "mask", "counts", "eid"), got, want):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 602), (torch.bfloat16, 602), (torch.float32, 256),
    (torch.bfloat16, 3), (torch.float32, 1), (torch.bfloat16, 1)])
def test_gather_rows_kernel_equals_plain(card, dtype, width):
    g = torch.Generator(device=card).manual_seed(width)
    table = torch.randn((5000, width), generator=g, device=card).to(dtype)
    idx = torch.randint(0, 5000, (12_345,), generator=g, device=card,
                        dtype=torch.int32)
    for t in (table, table[1:]):  # an offset view shifts the alignment
        before = b2.gather_rows.launches
        got = b2.gather_rows(t, idx.clamp_max(t.shape[0] - 1))
        torch.cuda.synchronize()
        assert b2.gather_rows.launches == before + 1
        assert torch.equal(got, b2.gather_rows_plain(
            t, idx.clamp_max(t.shape[0] - 1)))
    assert b2.gather_rows(table, idx[:0]).shape == (0, width)


def test_kernels_refuse_bad_input(card):
    table = torch.zeros((10, 4), device=card)
    with pytest.raises(ValueError):
        b2.gather_rows(table[:, 1:], torch.zeros(3, dtype=torch.int32,
                                                  device=card))
    with pytest.raises(ValueError):
        b2.gather_rows(table, torch.zeros(3, dtype=torch.int64, device=card))
    ip, ix = _graph().to_device(card)
    with pytest.raises(ValueError):
        b1.window_sample(ip, ix, torch.zeros(3, dtype=torch.int64,
                                             device=card), 5, 1, 2)


def test_fused_forward_card_matches_cpu(card):
    """The whole slice on the card against the plain versions on the CPU:
    frontiers bitwise, logits within fp32 summation-order tolerance."""
    topo = _graph(3, n=2000)
    feat = np.random.default_rng(1).standard_normal(
        (2000, 24)).astype(np.float32)
    torch.manual_seed(0)
    model = qt.GraphSAGE(24, 32, 7, num_layers=2)
    kw = np.array([[1, 2], [3, 4]], np.uint32)
    ids = np.arange(0, 2000, 61)
    outs, frontiers = [], []
    for dev in ("cpu", card):
        s = qt.GraphSageSampler(topo, [10, 5], device=dev)
        f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                       device=dev).from_cpu_tensor(feat)
        srv = qt.InferenceServer(s, f, model, None)
        padded = srv._pad_ids(ids)
        frontiers.append(s.sample(padded, key_words=kw).n_id.cpu())
        outs.append(srv.fused_forward(padded, kw).cpu())
        model = model.cpu()
    assert torch.equal(frontiers[0], frontiers[1])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
