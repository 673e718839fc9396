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
from quiver_tpu_torch.ops.cuda import page_gather as b5
from quiver_tpu_torch.ops.cuda import window_sample as b1
from quiver_tpu_torch.ops.paged import plan_blocks

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


def _random_plan(card, n_frames, page_rows, B, seed, block=8):
    """A planner-made plan over random (frame, offset) rows, on the card."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, n_frames, B).astype(np.int32)
    off = rng.integers(0, page_rows, B).astype(np.int32)
    blk_pages, _, row_lp, row_off, rank = plan_blocks(frame, off, block,
                                                      block)
    plan = [torch.from_numpy(a).to(card)
            for a in (blk_pages, row_lp, row_off, rank)]
    return plan, frame, off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [16, 602, 100])
def test_page_gather_kernel_equals_plain(card, dtype, width):
    g = torch.Generator(device=card).manual_seed(width)
    frames = torch.randn((37, 64, width), generator=g, device=card).to(dtype)
    for B, block in ((1237, 8), (1, 8), (64, 16)):
        plan, frame, off = _random_plan(card, 37, 64, B, B, block)
        before = b5.page_gather.launches
        got = b5.page_gather(frames, *plan, block, block)
        torch.cuda.synchronize()
        assert b5.page_gather.launches == before + 1
        assert torch.equal(got, b5.page_gather_plain(frames, *plan, block,
                                                     block))
        want = frames[torch.from_numpy(frame).long().to(card),
                      torch.from_numpy(off).long().to(card)]
        assert torch.equal(got, want)
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    assert b5.page_gather(frames, plan[0], plan[1], plan[2], empty, 8,
                          8).shape == (0, width)


def test_page_gather_refuses_bad_input(card):
    frames = torch.zeros((4, 8, 16), device=card)
    plan, _, _ = _random_plan(card, 4, 8, 50, 0)
    for i, bad in ((0, plan[0].long()), (3, plan[3].cpu()),
                   (3, plan[3].reshape(5, 10)), (1, plan[1][::2])):
        args = list(plan)
        args[i] = bad
        with pytest.raises(ValueError):
            b5.page_gather(frames, *args, 8, 8)
    with pytest.raises(ValueError):
        b5.page_gather(frames.view(32, 16), *plan, 8, 8)
    with pytest.raises(ValueError):
        b5.page_gather(frames, *plan, 0, 8)


@pytest.mark.parametrize("mode", ["paged", "overflow", "overlay", "staged"])
def test_budgeted_feature_on_card_returns_source_rows(card, mode):
    """A budgeted feature on the card, over many batches (the pinned
    staging buffers are reused each batch): rows bitwise equal to the
    source, through B5, its fallback, the overlay or the staged merge."""
    topo = _graph(5, n=3000)
    feat = np.random.default_rng(2).standard_normal(
        (3000, 602)).astype(np.float32)
    f = qt.Feature(device_cache_size=1000 * 602 * 4, csr_topo=topo,
                   device=card).from_cpu_tensor(feat)
    assert f.cold.is_pinned()
    if mode in ("paged", "overflow"):
        f.enable_paging(pool_pages=10_000 if mode == "paged" else 8)
    if mode == "overlay":
        f.enable_cold_cache(rows=500, admit_threshold=1)
    rng = np.random.default_rng(0)
    before = b5.page_gather.launches
    for i in range(30):
        # every third batch is small enough for an 8-page pool
        ids = rng.integers(0, 3000, int(rng.integers(1, 4000)) if i % 3
                           else 8)
        rows = f[ids if i % 2 else torch.from_numpy(ids).to(card)]
        assert rows.device.type == "cuda"
        assert torch.equal(rows.cpu(), torch.from_numpy(feat[ids]))
    c = f.stats()["counters"]
    assert (b5.page_gather.launches > before) == (mode in ("paged",
                                                           "overflow"))
    if mode == "overflow":
        assert c["feature_page_fallback_total"] > 0
    if mode == "overlay":
        assert c["feature_coldcache_rows_total{result=hit}"] > 0


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
