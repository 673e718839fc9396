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
import torch.nn.functional as F

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops import fastgather
from quiver_tpu_torch.ops.cuda import element_gather as b3
from quiver_tpu_torch.ops.cuda import gather_rows as b2
from quiver_tpu_torch.ops.cuda import lane_select as b4
from quiver_tpu_torch.ops.cuda import page_gather as b5
from quiver_tpu_torch.ops.cuda import sage_act as sa
from quiver_tpu_torch.ops.cuda import sage_mean as sm
from quiver_tpu_torch.ops.cuda import threefry as tf
from quiver_tpu_torch.ops.cuda import window_sample as b1
from quiver_tpu_torch.ops.cuda.build import KernelArgumentError
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


def _b1_inputs(card, k, n_seeds=3000):
    """A skewed graph on the card and seeds with degree-0 nodes and the
    last node among them."""
    topo = _graph(k)
    ip, ix = topo.to_device(card)
    rng = np.random.default_rng(k)
    seeds = np.concatenate([np.arange(12), rng.integers(0, 3000, n_seeds),
                            [2999]]).astype(np.int32)
    return ip, ix, torch.from_numpy(seeds).to(card), rng


B1_FANOUTS = [1, 5, 10, 25, 33, 128]


@pytest.mark.parametrize("k", B1_FANOUTS)
def test_window_sample_kernel_equals_plain(card, k):
    """The literal entry: masked and unmasked seeds, a seed view that
    starts one element into its storage, all seeds masked."""
    ip, ix, seeds, rng = _b1_inputs(card, k)
    mask = torch.from_numpy(rng.random(seeds.shape[0]) < 0.7).to(card)
    for s, m in ((seeds, mask), (seeds, None), (seeds[1:], mask[1:]),
                 (seeds, torch.zeros_like(mask))):
        before = b1.window_sample.launches
        got = b1.window_sample(ip, ix, s, k, 0xDEADBEEF, 12345, m)
        torch.cuda.synchronize()
        assert b1.window_sample.launches == before + 1
        want = b1.window_sample_plain(ip, ix, s, k, 0xDEADBEEF, 12345, m)
        for name, a, b in zip(("nbrs", "mask", "counts", "eid"), got, want):
            assert torch.equal(a, b), name


def _frontier_buffers(seeds, mask, k):
    """Pipeline buffers holding ``seeds`` (masked by ``mask``) and room for
    one hop's tail, the tail filled with a sentinel."""
    t = seeds.shape[0]
    frontier = torch.full((t * (1 + k),), -7, dtype=torch.int32,
                          device=seeds.device)
    fmask = torch.zeros_like(frontier, dtype=torch.bool)
    frontier[:t] = seeds
    fmask[:t] = mask
    return frontier, fmask


@pytest.mark.parametrize("k", B1_FANOUTS)
def test_window_sample_frontier_kernel_equals_plain(card, k):
    """The pipeline entry: the frontier and mask tails, local ids, counts
    and edge ids equal the plain version's, with and without edge ids, a
    frontier that starts one element into its storage, all seeds
    masked."""
    ip, ix, seeds, rng = _b1_inputs(card, k)
    mask = torch.from_numpy(rng.random(seeds.shape[0]) < 0.7).to(card)
    cases = [(seeds, mask, True), (seeds, mask, False),
             (seeds, torch.zeros_like(mask), True)]
    for s, m, eid in cases + [(seeds[1:], mask[1:], True)]:
        bufs = [_frontier_buffers(s, m, k) for _ in range(2)]
        if s.data_ptr() != seeds.data_ptr():  # shift the buffers too
            bufs = [(torch.cat([f[:1], f])[1:], torch.cat([fm[:1], fm])[1:])
                    for f, fm in bufs]
            assert bufs[0][0].storage_offset() == 1
        t = s.shape[0]
        before = b1.window_sample.launches
        got = b1.window_sample_frontier(ip, ix, *bufs[0], t, k, 0xDEADBEEF,
                                        12345, return_eid=eid)
        torch.cuda.synchronize()
        assert b1.window_sample.launches == before + 1
        want = b1.window_sample_frontier_plain(ip, ix, *bufs[1], t, k,
                                               0xDEADBEEF, 12345,
                                               return_eid=eid)
        assert torch.equal(bufs[0][0], bufs[1][0])
        assert torch.equal(bufs[0][1], bufs[1][1])
        for name in ("nbr_local", "mask", "counts"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        if eid:
            assert torch.equal(got.eid, want.eid)
        else:
            assert got.eid is None and want.eid is None


def test_window_sample_larger_than_one_wave(card):
    """Both entries over more draws than one wave of resident threads
    holds (each thread walks many 32-draw steps)."""
    ip, ix, seeds, rng = _b1_inputs(card, 5, n_seeds=400_000)
    mask = torch.from_numpy(rng.random(seeds.shape[0]) < 0.9).to(card)
    got = b1.window_sample(ip, ix, seeds, 5, 7, 8, mask)
    want = b1.window_sample_plain(ip, ix, seeds, 5, 7, 8, mask)
    for name, a, b in zip(("nbrs", "mask", "counts", "eid"), got, want):
        assert torch.equal(a, b), name
    bufs = [_frontier_buffers(seeds, mask, 5) for _ in range(2)]
    t = seeds.shape[0]
    got = b1.window_sample_frontier(ip, ix, *bufs[0], t, 5, 7, 8)
    want = b1.window_sample_frontier_plain(ip, ix, *bufs[1], t, 5, 7, 8)
    assert torch.equal(bufs[0][0], bufs[1][0])
    assert torch.equal(bufs[0][1], bufs[1][1])
    assert torch.equal(got.nbr_local, want.nbr_local)
    assert torch.equal(got.counts, want.counts)


def test_window_sample_refuses_2_31_draws_and_short_buffers(card):
    ip, ix = _graph().to_device(card)
    seeds = torch.zeros(2048, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        b1.window_sample(ip, ix, seeds, 2**20, 1, 2)
    frontier, fmask = _frontier_buffers(seeds, seeds >= 0, 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        b1.window_sample_frontier(ip, ix, frontier, fmask, 2048, 2**20, 1, 2)
    with pytest.raises(ValueError, match="too short"):
        b1.window_sample_frontier(ip, ix, frontier, fmask, 2048, 5, 1, 2)
    with pytest.raises(ValueError, match="too short"):
        b1.window_sample_frontier(ip, ix, frontier[:-1], fmask[:-1], 2048, 4,
                                  1, 2)


def test_pwindow_pipeline_on_card_equals_cpu(card):
    """The 3-hop sampler on the card under ``"pwindow"`` launches B1 once a
    hop and returns the CPU's batch bitwise: frontier, its mask, node
    count, and every block's local ids, mask, target count and edge
    ids."""
    topo = _graph(7, n=3000)
    kw = np.array([[5, 6], [7, 8], [9, 10]], np.uint32)
    ids = np.concatenate([np.arange(0, 3000, 37), [2999, 0]])
    before = b1.window_sample.launches
    got = qt.GraphSageSampler(topo, [10, 5, 3], device=card, return_eid=True,
                              gather_mode="pwindow").sample(ids, key_words=kw)
    torch.cuda.synchronize()
    assert b1.window_sample.launches == before + 3
    want = qt.GraphSageSampler(topo, [10, 5, 3], device="cpu",
                               return_eid=True, gather_mode="pwindow"
                               ).sample(ids, key_words=kw)
    assert torch.equal(got.n_id.cpu(), want.n_id)
    assert torch.equal(got.n_id_mask.cpu(), want.n_id_mask)
    assert int(got.num_nodes) == int(want.num_nodes)
    for a, b in zip(got.layers, want.layers):
        for name in ("nbr_local", "mask", "eid"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
        assert int(a.num_targets) == int(b.num_targets)


def _b2_table(card, dtype, width, seed, n=5000):
    g = torch.Generator(device=card).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n, width), generator=g,
                             device=card, dtype=torch.int32)
    return torch.randn((n, width), generator=g, device=card).to(dtype)


def _b2_bits(t):
    """The rows as integers of their element size: bitwise comparison."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _b2_ids(card, m, n, kind, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, m)
    if kind == "zeros":
        ids[:] = 0
    elif kind == "zeros90":
        ids[rng.random(m) < 0.9] = 0
    return torch.from_numpy(ids.astype(np.int32)).to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("width", [1, 3, 100, 602, 768, 1025, 2052])
def test_gather_rows_kernel_equals_plain(card, dtype, width):
    """Both routes, whichever the rule picks, bitwise against the plain
    version: the table, its ``table[1:]`` view (which shifts the rows'
    alignment) and a one-row view; uniform ids, all 0 and 90% 0; M = 0,
    1, 257 and 12,345.  Then the entry as ``lookup_device`` calls it: a
    row order and int64 ids outside ``[0, N)``, one launch a call.
    Widths 1025 and 2052 give rows of more than the 512 units a warp of
    the grouped copy holds at once (1025 units of 4 or 2 bytes, 513 of 16
    in fp32 and int32 at 2052), so that copy takes several passes."""
    table = _b2_table(card, dtype, width, width)
    for t in (table, table[1:], table[2:3]):
        n = t.shape[0]
        for m in (0, 1, 257, 12_345):
            for kind in ("uniform", "zeros", "zeros90"):
                idx = _b2_ids(card, m, n, kind, m + width)
                want = _b2_bits(b2.gather_rows_plain(t, idx))
                for which in ("direct", "grouped"):
                    got = b2.gather_rows_route(t, idx, None, which)
                    torch.cuda.synchronize()
                    assert got.shape == (m, width)
                    assert torch.equal(_b2_bits(got), want), (which, n, m,
                                                              kind)
        g = torch.Generator(device=card).manual_seed(n)
        order = torch.randperm(n, generator=g, device=card).to(torch.int32)
        idx = torch.from_numpy(np.random.default_rng(n).integers(
            -50, n + 50, 4097)).to(card)
        want = _b2_bits(b2.gather_rows_plain(t, idx, order))
        before = b2.gather_rows.launches
        got = b2.gather_rows(t, idx, order)
        torch.cuda.synchronize()
        assert b2.gather_rows.launches == before + 1
        assert torch.equal(_b2_bits(got), want)
        for which in ("direct", "grouped"):
            got = b2.gather_rows_route(t, idx, order, which)
            assert torch.equal(_b2_bits(got), want), which
    assert b2.gather_rows(table, torch.zeros(0, dtype=torch.int64,
                                             device=card)).shape == (0, width)


def test_kernels_refuse_bad_input(card):
    table = torch.zeros((10, 4), device=card)
    with pytest.raises(ValueError):
        b2.gather_rows(table[:, 1:], torch.zeros(3, dtype=torch.int32,
                                                  device=card))
    with pytest.raises(ValueError):
        b2.gather_rows(table, torch.zeros(3, dtype=torch.int16, device=card))
    with pytest.raises(ValueError):
        b2.gather_rows(table, torch.zeros((3, 1), dtype=torch.int32,
                                          device=card))
    with pytest.raises(ValueError):  # an order must be int32 [N]
        b2.gather_rows(table, torch.zeros(3, dtype=torch.int32, device=card),
                       torch.arange(10, device=card))
    with pytest.raises(ValueError):
        b2.gather_rows_route(table, torch.zeros(3, dtype=torch.int32,
                                                device=card), None, "sorted")
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


def _registry_counters() -> dict:
    """The port registry's counters (their one source), switched on."""
    from quiver_tpu_torch import telemetry

    telemetry.set_enabled(True)
    return dict(telemetry.snapshot()["counters"])


def _registry_counters_added(before: dict) -> dict:
    from quiver_tpu_torch import telemetry

    now = telemetry.snapshot()["counters"]
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if v != before.get(k, 0.0)}


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
    counted = _registry_counters()
    for i in range(30):
        # every third batch is small enough for an 8-page pool
        ids = rng.integers(0, 3000, int(rng.integers(1, 4000)) if i % 3
                           else 8)
        rows = f[ids if i % 2 else torch.from_numpy(ids).to(card)]
        assert rows.device.type == "cuda"
        assert torch.equal(rows.cpu(), torch.from_numpy(feat[ids]))
    c = _registry_counters_added(counted)
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
    model = qt.GraphSAGE(24, 32, 7, num_layers=2, device="cpu")
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


def _table(card, dtype, n, seed):
    """A 1-D card table; fp32 ones hold -0.0 every 7th entry."""
    g = torch.Generator(device=card).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                             device=card, dtype=torch.int32)
    t = torch.randn((n,), generator=g, device=card)
    t[::7] = -0.0
    return t


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _ids(card, m, n, seed, ends=()):
    """``m`` int32 ids in ``[0, n)`` with ``ends`` at the front, and the
    same ids as a view that starts one element into its storage (not
    16-byte aligned)."""
    g = torch.Generator(device=card).manual_seed(seed)
    base = torch.randint(0, n, (m + 1,), generator=g, device=card,
                         dtype=torch.int32)
    ends = torch.tensor(ends, dtype=torch.int32, device=card)[:m]
    base[1:1 + ends.shape[0]] = ends
    idx = base[1:].clone()
    assert base[1:].data_ptr() % 16 == 4
    return idx, base[1:]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 1000, 4097, 901_120])
def test_element_gather_kernel_equals_plain(card, dtype, m):
    n = 3000 * 128
    t2d = _table(card, dtype, n, m).view(-1, 128)
    idx, shifted = _ids(card, m, n, m + 1, (0, n - 1, -7, n + 1000))
    for i in (idx, shifted, idx.reshape(-1, 1) if m > 1 else idx):
        before = b3.element_gather.launches
        got = b3.element_gather(t2d, i)
        torch.cuda.synchronize()
        assert b3.element_gather.launches == before + 1
        assert got.shape == i.shape
        assert torch.equal(_bits(got), _bits(b3.element_gather_plain(t2d, i)))
    if dtype == torch.float32:  # -0.0 comes back as +0.0
        flat = t2d.reshape(-1)[idx.long().clamp(0, n - 1)]
        neg = (flat == 0) & torch.signbit(flat)
        assert neg.any() or m < 1000
        assert (_bits(got)[neg] == 0).all()
    assert b3.element_gather(t2d, idx[:0]).shape == (0,)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 4097, 180_224])
def test_element_gather_pair_kernel_equals_plain(card, dtype, m):
    """B3's pair entry: ``(flat[clamp(i)], flat[clamp(i + 1)])`` in one
    launch, bitwise equal to two plain reads, for aligned and shifted ids,
    ids at the table's last elements and beyond, -0.0 in fp32 tables."""
    n = 3000 * 128
    t2d = _table(card, dtype, n, m + 5).view(-1, 128)
    idx, shifted = _ids(card, m, n, m + 6,
                        (n - 1, n - 2, -7, n + 1000, 2**31 - 1))
    for i in (idx, shifted):
        before = b3.element_gather.launches
        lo, hi = b3.element_gather_pair(t2d, i)
        torch.cuda.synchronize()
        assert b3.element_gather.launches == before + 1
        assert lo.shape == hi.shape == i.shape
        want_lo, want_hi = b3.element_gather_pair_plain(t2d, i)
        assert torch.equal(_bits(lo), _bits(want_lo))
        assert torch.equal(_bits(hi), _bits(want_hi))
        assert torch.equal(_bits(lo), _bits(b3.element_gather(t2d, i)))
    if dtype == torch.float32 and m > 1000:
        flat = t2d.reshape(-1)[idx.long().clamp(0, n - 1)]
        assert (flat == 0).logical_and(torch.signbit(flat)).any()
        assert not (_bits(lo) == _bits(torch.tensor(-0.0))).any()
    empty = b3.element_gather_pair(t2d, idx[:0])
    assert empty[0].shape == empty[1].shape == (0,)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 1000, 4097, 180_224])
def test_lane_select_kernel_equals_plain(card, dtype, m):
    rows = _table(card, dtype, m * 128, m).view(m, 128)
    lanes, shifted = _ids(card, m, 128, m + 2, (0, 127, -1, 128))
    for lane in (lanes, shifted):
        before = b4.lane_select.launches
        got = b4.lane_select(rows, lane)
        torch.cuda.synchronize()
        assert b4.lane_select.launches == before + 1
        assert torch.equal(_bits(got), _bits(b4.lane_select_plain(rows,
                                                                   lane)))
    if m >= 4:
        assert got[2] == 0 and got[3] == 0
    assert b4.lane_select(rows[:0], lanes[:0]).shape == (0,)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 4097, 901_120])
def test_lane_select_rows_kernel_equals_plain(card, dtype, m):
    """B4's fused entry reads ``table2d[row, lane]`` without gathering the
    rows: bitwise equal to the plain row gather and lane select, for
    shifted ids, lanes outside ``[0, 128)`` (0) and rows outside the table
    (clamped on the card; the plain version needs them in range)."""
    R = 3000
    t2d = _table(card, dtype, R * 128, m + 3).view(R, 128)
    row, row_s = _ids(card, m, R, m + 4, (0, R - 1, -3, R + 9))
    lane, lane_s = _ids(card, m, 128, m + 5, (127, -1, 128, 0))
    for r, l in ((row, lane), (row_s, lane_s), (row, lane_s)):
        before = b4.lane_select.launches
        got = b4.lane_select_rows(t2d, r, l)
        torch.cuda.synchronize()
        assert b4.lane_select.launches == before + 1
        want = b4.lane_select_plain(
            t2d.index_select(0, r.clamp(0, R - 1)), l)
        assert torch.equal(_bits(got), _bits(want))
    if m >= 4:
        assert got[1] == 0 and got[2] == 0
    assert b4.lane_select_rows(t2d, row[:0], lane[:0]).shape == (0,)


@pytest.mark.parametrize("m", [5, 4097, 70_001, 4_194_307])
def test_b3_b4_walks_equal_plain(card, m):
    """The walk, aligned or not, through one step or many a thread (4M ids
    outrun one wave of resident threads), gives the plain versions' bits
    in B3's two entries and B4's fused entry."""
    n = 2000 * 128
    t2d = _table(card, torch.float32, n, m).view(-1, 128)
    idx, shifted = _ids(card, m, n, m, (n - 1, -2, n + 3))
    for i in (idx, shifted):
        want = _bits(b3.element_gather_plain(t2d, i))
        assert torch.equal(_bits(b3.element_gather(t2d, i)), want)
        lo, hi = b3.element_gather_pair(t2d, i)
        assert torch.equal(_bits(lo), want)
        assert torch.equal(_bits(hi), _bits(b3.element_gather_plain(
            t2d, i.long() + 1)))
        row, lane = i.clamp(0, n - 1) >> 7, i.clamp(0, n - 1) & 127
        got = b4.lane_select_rows(t2d, row, lane)
        assert torch.equal(_bits(got), want)
    torch.cuda.synchronize()


def test_fused_element_gather_allocates_no_rows(card):
    """``fastgather.element_gather(fused=True)`` at products' hop-3 draw
    count allocates far less than the ``[M, 128]`` rows (``M * 512``
    bytes) the two-step path writes."""
    t2d = _table(card, torch.int32, 4000 * 128, 1).view(-1, 128)
    m = 901_120
    idx = torch.randint(0, t2d.numel(), (m,), device=card, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fastgather.element_gather(t2d, idx, fused=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < m * 512 / 16, peak
    assert torch.equal(got, t2d.reshape(-1)[idx.long()])


def test_b3_b4_refuse_bad_input(card):
    t = torch.zeros((4, 128), device=card)
    i = torch.zeros(5, dtype=torch.int32, device=card)
    for bad in (t.double(), t[:, ::2], t.half()):
        with pytest.raises(ValueError):
            b3.element_gather(bad, i)
    with pytest.raises(ValueError):
        b3.element_gather(t, i.long())
    with pytest.raises(ValueError):
        b4.lane_select(t, i[:4].long())
    with pytest.raises(ValueError):
        b4.lane_select(t[:, :64].contiguous(), i[:4])
    with pytest.raises(ValueError):
        b4.lane_select(t, i)  # one lane per row
    with pytest.raises(ValueError):
        b3.element_gather_pair(t.double(), i)
    with pytest.raises(ValueError):
        b4.lane_select_rows(t, i, i[:4])
    with pytest.raises(ValueError):
        b4.lane_select_rows(t[:, :64].contiguous(), i, i)


@pytest.mark.parametrize("mode", ["pallas", "lanes_fused", "lanes"])
def test_gather_modes_on_card_equal_cpu(card, mode):
    """The 3-hop sampler on the card in each element-gather mode returns
    the CPU's frontier and blocks bitwise, through B3 (two launches a hop:
    the paired indptr read and the draws) or B4 (three)."""
    topo = _graph(7, n=3000)
    kw = np.array([[5, 6], [7, 8], [9, 10]], np.uint32)
    ids = np.arange(0, 3000, 37)
    counters = {"pallas": (b3.element_gather, 6),
                "lanes_fused": (b4.lane_select, 9)}
    fn, per_sample = counters.get(mode, (None, 0))
    before = fn.launches if fn else 0
    got = qt.GraphSageSampler(topo, [10, 5, 3], device=card,
                              gather_mode=mode).sample(ids, key_words=kw)
    torch.cuda.synchronize()
    if fn:
        assert fn.launches == before + per_sample
    want = qt.GraphSageSampler(topo, [10, 5, 3], device="cpu",
                               gather_mode="xla").sample(ids, key_words=kw)
    assert torch.equal(got.n_id.cpu(), want.n_id)
    for a, b in zip(got.layers, want.layers):
        assert torch.equal(a.nbr_local.cpu(), b.nbr_local)
        assert torch.equal(a.mask.cpu(), b.mask)


def test_fastgather_on_card_equals_cpu(card):
    t = _table(card, torch.float32, 1000, 3)
    idx = torch.randint(0, 1000, (37, 11), device=card, dtype=torch.int32)
    want = fastgather.element_gather(fastgather.prepare_table(t.cpu()),
                                     idx.cpu())
    for fused in (False, True):
        got = fastgather.element_gather(fastgather.prepare_table(t), idx,
                                        fused=fused)
        assert torch.equal(_bits(got.cpu()), _bits(want))


def test_prefetch_then_read_on_card(card):
    """A budgeted feature on the card: prefetch batch i+1, read batch i,
    then claim i+1, over many batches (the pinned staging buffers are
    reused while a prefetched copy may be in flight): rows bitwise equal
    to the source."""
    topo = _graph(5, n=3000)
    feat = np.random.default_rng(3).standard_normal(
        (3000, 100)).astype(np.float32)
    f = qt.Feature(device_cache_size=600 * 100 * 4, csr_topo=topo,
                   device=card).from_cpu_tensor(feat)
    rng = np.random.default_rng(1)
    counted = _registry_counters()
    try:
        nxt = rng.integers(0, 3000, 5000).astype(np.int32)
        for i in range(20):
            cur, nxt = nxt, rng.integers(0, 3000, int(rng.integers(1, 9000))
                                         ).astype(np.int32)
            f.prefetch(torch.from_numpy(nxt).to(card))
            rows = f[cur]
            assert torch.equal(rows.cpu(), torch.from_numpy(feat[cur]))
        assert torch.equal(f[nxt].cpu(), torch.from_numpy(feat[nxt]))
        c = _registry_counters_added(counted)
        assert c["feature_prefetch_total{result=hit}"] == 20
    finally:
        f.close()


def test_fused_train_step_card_matches_cpu(card):
    """Two fused steps (B3 sampling, B2 lookup, autograd, Adam) on the card
    against the plain versions on the CPU: losses and parameters within
    fp32 summation-order tolerance."""
    topo = _graph(4, n=2000)
    feat = np.random.default_rng(2).standard_normal(
        (2000, 24)).astype(np.float32)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, 7, 2000))
    torch.manual_seed(0)
    base = qt.GraphSAGE(24, 32, 7, num_layers=3, dropout=0.0,
                        device="cpu")
    kws = [np.array([[1, i], [2, i], [3, i]], np.uint32) for i in range(2)]
    ids = np.arange(0, 2000, 7)
    out = []
    for dev in ("cpu", card):
        model = qt.GraphSAGE(24, 32, 7, num_layers=3, dropout=0.0,
                             device=dev)
        model.load_state_dict(base.state_dict())
        s = qt.GraphSageSampler(topo, [6, 4, 3], device=dev,
                                gather_mode="pallas")
        f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                       device=dev).from_cpu_tensor(feat)
        step = qt.make_fused_train_step(
            s, f, model, torch.optim.Adam(model.parameters(), lr=3e-3))
        lab = labels[ids].to(dev)
        ones = torch.ones(len(ids), dtype=torch.bool, device=dev)
        losses = [float(step(ids, lab, ones, kw)) for kw in kws]
        out.append((losses, {k: v.cpu() for k, v in
                             model.state_dict().items()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for k in out[0][1]:
        torch.testing.assert_close(out[1][1][k], out[0][1][k], rtol=0,
                                   atol=2e-5)


def _same_batch(a, b):
    """Two SampledBatches equal bit for bit (on any devices)."""
    for x, y in ((a.n_id, b.n_id), (a.n_id_mask, b.n_id_mask),
                 (a.num_nodes, b.num_nodes), (a.drops, b.drops)):
        assert torch.equal(x.cpu(), y.cpu())
    for la, lb in zip(a.layers, b.layers):
        for x, y in ((la.nbr_local, lb.nbr_local), (la.mask, lb.mask),
                     (la.num_targets, lb.num_targets)):
            assert torch.equal(x.cpu(), y.cpu())


def test_reindex_on_card_equals_cpu(card):
    """The dedup of a hop with duplicate and masked seeds on the card,
    against the CPU's."""
    from quiver_tpu_torch.ops.reindex import reindex

    rng = np.random.default_rng(0)
    B, k = 5000, 9
    seeds = rng.integers(0, 20_000, B).astype(np.int32)
    seeds[4000:] = seeds[0]
    nbrs = np.where(rng.random((B, k)) < 0.3, rng.choice(seeds, (B, k)),
                    rng.integers(0, 20_000, (B, k)))
    mask = rng.random((B, k)) < 0.8
    nbrs = np.where(mask, nbrs, -1).astype(np.int32)
    smask = rng.random(B) < 0.9
    args = [torch.from_numpy(a) for a in (seeds, nbrs, mask, smask)]
    want = reindex(*args)
    got = reindex(*[a.to(card) for a in args])
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("mode", ["pallas", "pwindow", "blocked:3"])
def test_weighted_hop_on_card_equals_xla(card, mode):
    """A weighted hop on the card in ``mode`` (B3 for the bounds, totals,
    the 24 CDF rounds and the draws in each mode) against ``"xla"`` on
    the card."""
    from quiver_tpu_torch.ops.sample import (row_cumsum_weights,
                                             sample_neighbors_weighted)

    topo = _graph(11)
    ip, ix = topo.to_device(card)
    w = np.random.default_rng(2).random(topo.edge_count, dtype=np.float32)
    cw = qt.ops.fastgather.pad_table_128(torch.from_numpy(
        row_cumsum_weights(topo.indptr, w)).to(card))
    rng = np.random.default_rng(3)
    seeds = torch.from_numpy(np.concatenate([np.arange(12), rng.integers(
        0, 3000, 4000), [2999]]).astype(np.int32)).to(card)
    smask = torch.from_numpy(rng.random(seeds.shape[0]) < 0.8).to(card)
    before = b3.element_gather.launches
    got = sample_neighbors_weighted(ip, ix, cw, seeds, 10, (7, 8), smask,
                                    mode)
    torch.cuda.synchronize()
    assert b3.element_gather.launches - before == 1 + 1 + 24 + 1
    want = sample_neighbors_weighted(ip, ix, cw, seeds, 10, (7, 8), smask,
                                     "xla")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_hop_and_blocked_pipelines_on_card_equal_xla(card, weighted):
    """Three ``"hop"`` hops with a cap that drops, under ``"auto"`` (B1's
    literal entry, one launch a uniform hop) and ``"blocked:3"`` (B3: two
    launches a uniform hop, 27 a weighted one), against ``"xla"`` on the
    card and on the CPU."""
    topo = _graph(13)
    w = (np.random.default_rng(4).random(topo.edge_count, dtype=np.float32)
         if weighted else None)
    kw = np.array([[5, 6], [7, 8], [9, 10]], np.uint32)
    ids = np.concatenate([np.arange(0, 3000, 23), np.full(30, 5)])
    batches = {}
    for dev, mode in ((card, "auto"), (card, "blocked:3"), (card, "xla"),
                      ("cpu", "xla")):
        s = qt.GraphSageSampler(topo, [10, 5, 3], device=dev,
                                gather_mode=mode, dedup="hop",
                                frontier_caps=[None, 1000, 4000],
                                edge_weights=w)
        before = b1.window_sample.launches
        before_b3 = b3.element_gather.launches
        batches[(str(dev), mode)] = s.sample(ids, key_words=kw)
        torch.cuda.synchronize()
        if mode == "auto":
            assert (b1.window_sample.launches - before
                    == (0 if weighted else 3))
        if mode == "blocked:3":
            assert (b3.element_gather.launches - before_b3
                    == 3 * (27 if weighted else 2))
    want = batches[("cpu", "xla")]
    assert int(want.drops.sum()) > 0
    for key, got in batches.items():
        _same_batch(got, want)


def _mag_graph(n_paper=3000, n_author=2000, n_inst=60, seed=0):
    """A MAG-schema hetero graph (employs at 0.36 an author: most authors
    have no institution)."""
    rng = np.random.default_rng(seed)

    def csr(n_src, n_dst, avg):
        deg = rng.poisson(avg, n_dst)
        indptr = np.zeros(n_dst + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        return qt.CSRTopo(indptr=indptr, indices=rng.integers(
            0, n_src, int(indptr[-1])).astype(np.int32))

    counts = {"paper": n_paper, "author": n_author, "institution": n_inst}
    return qt.HeteroCSRTopo({
        ("paper", "cites", "paper"): csr(n_paper, n_paper, 10.66),
        ("author", "writes", "paper"): csr(n_author, n_paper, 3.17),
        ("institution", "employs", "author"): csr(n_inst, n_author, 0.36)},
        counts), counts


def _same_hetero(a, b):
    for t in a.n_id:
        assert torch.equal(a.n_id[t].cpu(), b.n_id[t].cpu()), t
        assert torch.equal(a.n_id_mask[t].cpu(), b.n_id_mask[t].cpu()), t
    for la, lb in zip(a.layers, b.layers, strict=True):
        for x, y in zip(la, lb, strict=True):
            assert x.relation == y.relation
            for f in ("nbr_local", "mask", "num_targets"):
                assert torch.equal(getattr(x, f).cpu(),
                                   getattr(y, f).cpu()), (x.relation, f)


def test_hetero_sampler_on_card_equals_xla(card):
    """The hetero sampler under ``"pwindow"`` (B1's literal entry once a
    sampled block) against ``"xla"`` on the card and against the CPU, bit
    for bit, with duplicate seeds."""
    topo, _ = _mag_graph()
    seeds = np.concatenate([np.arange(0, 3000, 7), [5, 5, 5]])
    s = qt.HeteroGraphSageSampler(topo, [25, 15], device=card)
    kw = s.draw_key_words(len(seeds))
    before = b1.window_sample.launches
    got = s.sample(seeds, key_words=kw)
    torch.cuda.synchronize()
    assert b1.window_sample.launches - before == s.num_blocks(len(seeds))
    for mode, dev in (("xla", card), ("pwindow", "cpu")):
        _same_hetero(got, qt.HeteroGraphSageSampler(
            topo, [25, 15], device=dev, gather_mode=mode).sample(
                seeds, key_words=kw))


def test_rgat_card_matches_cpu(card):
    """R-GAT on the card (B1 sampling, B2 lookup, autograd, Adam) against
    the plain versions on the CPU: logits within fp32 summation-order
    tolerance, then losses and parameters after two steps (dropout 0)."""
    topo, counts = _mag_graph(seed=1)
    dims = {"paper": 24, "author": 16, "institution": 8}
    rng = np.random.default_rng(2)
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}
    labels = torch.from_numpy(rng.integers(0, 7, counts["paper"]))
    ids = np.arange(0, 3000, 11)
    torch.manual_seed(0)
    out = []
    for dev in ("cpu", card):
        s = qt.HeteroGraphSageSampler(topo, [6, 4], device=dev)
        hf = qt.HeteroFeature.from_cpu_tensors(feats, device=dev)
        model = qt.RGAT(dims, 32, 7, 2, s.layer_relations(), heads=4,
                        dropout=0.0, device="cpu")
        if out:
            model.load_state_dict(out[0][2])
        base = {k: v.clone() for k, v in model.state_dict().items()}
        model = model.to(dev)
        step = qt.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        kws = [np.full((s.num_blocks(len(ids)), 2), i, np.uint32)
               for i in (1, 2)]
        batch = s.sample(ids, key_words=kws[0])
        model.eval()
        logits = model(hf.lookup(batch), batch).detach().cpu()
        lab = labels[ids].to(dev)
        ones = torch.ones(len(ids), dtype=torch.bool, device=dev)
        losses = []
        for kw in kws:
            batch = s.sample(ids, key_words=kw)
            losses.append(float(step(hf.lookup(batch), batch, lab, ones)))
        out.append((logits, losses, base,
                    {k: v.cpu() for k, v in model.state_dict().items()}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)
    for k in out[0][3]:
        torch.testing.assert_close(out[1][3][k], out[0][3][k], rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("family", ["sage", "gcn", "gat"])
def test_full_graph_inference_card_matches_cpu(card, family):
    """Exact inference on the card against the CPU, chunked: fp32 within
    ``rtol=atol=1e-5`` (``index_add_`` order differs on the card)."""
    topo = _graph(5, n=2000)
    x = np.random.default_rng(4).standard_normal((2000, 24)).astype(
        np.float32)
    torch.manual_seed(0)
    model = {"sage": lambda: qt.GraphSAGE(24, 32, 7, num_layers=3,
                                           device="cpu"),
             "gcn": lambda: qt.GCN(24, 32, 7, num_layers=3, device="cpu"),
             "gat": lambda: qt.GAT(24, 16, 7, num_layers=3, heads=4,
                                   device="cpu")}[family]()
    want = qt.full_graph_inference(model, None, x, topo.indptr,
                                   topo.indices, edge_chunk=300_000,
                                   device="cpu")
    got = qt.full_graph_inference(model.to(card), None, x, topo.indptr,
                                  topo.indices, edge_chunk=300_000)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# -- slice 9: the host sampler and the paths built on it ------------------

def _same_batch_on(a, b):
    """Two ``SampledBatch``es equal bitwise, whatever their devices."""
    assert torch.equal(a.n_id.cpu(), b.n_id.cpu())
    assert torch.equal(a.n_id_mask.cpu(), b.n_id_mask.cpu())
    assert int(a.num_nodes) == int(b.num_nodes)
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.nbr_local.cpu(), lb.nbr_local.cpu())
        assert torch.equal(la.mask.cpu(), lb.mask.cpu())
        assert int(la.num_targets) == int(lb.num_targets)


@pytest.mark.parametrize("budget", ["third", "zero", "all"])
def test_uva_card_matches_cpu(card, budget):
    """UVA on the card (the hot tier through B1's literal entry under
    ``"auto"``) equals UVA on the CPU (B1's plain version) for the same
    words and host seeds; B1 launches once a hop."""
    topo = _graph(6, n=3000)
    e = topo.edge_count
    b = {"third": e * 4 // 3, "zero": 0, "all": e * 4}[budget]
    kw = np.random.default_rng(2).integers(0, 2**32, (3, 3), dtype=np.uint32)
    ids = np.concatenate([np.arange(12), np.arange(2900, 3000)])
    out = []
    for dev in ("cpu", card):
        s = qt.GraphSageSampler(topo, [10, 5, 3], device=dev, mode="UVA",
                                uva_budget=b)
        before = b1.window_sample.launches
        out.append(s.sample(ids, key_words=kw))
        if dev == card:
            assert b1.window_sample.launches == before + 3
            assert out[-1].n_id.device.type == "cuda"
    _same_batch_on(out[1], out[0])


def test_cpu_mode_card_matches_cpu(card):
    """``mode="CPU"`` copies the host sampler's batch to the card: equal
    to the same calls with ``device="cpu"``."""
    topo = _graph(7, n=3000)
    a = qt.GraphSageSampler(topo, [10, 5], device=card, mode="CPU")
    c = qt.GraphSageSampler(topo, [10, 5], device="cpu", mode="CPU")
    for i in range(3):
        ids = np.arange(i, 3000, 37)
        ga, gc = a.sample(ids), c.sample(ids)
        assert ga.n_id.device.type == "cuda"
        _same_batch_on(ga, gc)


def test_cpu_lane_answer_equals_direct_forward(card):
    """A CPU-lane request on the card: the answer equals the model on its
    batch (B2 for the rows), and the CPU's answer on the same batch within
    fp32 tolerance."""
    import queue

    topo = _graph(8, n=2000)
    feat = np.random.default_rng(1).standard_normal(
        (2000, 24)).astype(np.float32)
    torch.manual_seed(0)
    model = qt.GraphSAGE(24, 32, 7, num_layers=2, device="cpu")
    model_cpu = qt.GraphSAGE(24, 32, 7, num_layers=2, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    model_cpu.eval()  # the server puts its model in eval mode
    f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                   device=card).from_cpu_tensor(feat)
    fc = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                    device="cpu").from_cpu_tensor(feat)
    cpu = qt.GraphSageSampler(topo, [10, 5], device=card, mode="CPU")
    dev = qt.GraphSageSampler(topo, [10, 5], device=card)
    results = queue.Queue()
    rb = qt.RequestBatcher([queue.Queue()], mode="CPU")
    hs = qt.HybridSampler(cpu, rb.cpu_batched_queue, num_workers=1)
    srv = qt.InferenceServer_Debug(dev, f, model, rb.device_batched_queue,
                                   cpu_sampled_queue=hs.sampled_queue,
                                   result_queue=results)
    hs.start()
    srv.start()
    ids = np.arange(5, 2000, 97)
    before = b2.gather_rows.launches
    rb._route(qt.ServingRequest(ids=ids, client=0, seq=0))
    req, out = results.get(timeout=120)
    assert hs.stop() == [] and srv.stop() == []
    assert not isinstance(out, Exception), out
    assert b2.gather_rows.launches > before
    (_, _, batch), = srv.cpu_log
    with torch.inference_mode():
        direct = model(f[batch.n_id], batch.layers)[: len(ids)].cpu()
        on_cpu = model_cpu(fc[batch.n_id.cpu()], tuple(
            type(l)(*(t.cpu() if torch.is_tensor(t) else t for t in l))
            for l in batch.layers))[: len(ids)]
    assert torch.equal(torch.from_numpy(out), direct)
    torch.testing.assert_close(direct, on_cpu, rtol=1e-5, atol=1e-5)


def _card_server(card, **kw):
    """A small whole-table server on the card (the failover route
    ``cpu_sampler`` samples on the host and puts its batch on the card)."""
    import queue

    topo = _graph(9, n=2000)
    feat = np.random.default_rng(2).standard_normal(
        (2000, 24)).astype(np.float32)
    torch.manual_seed(0)
    model = qt.GraphSAGE(24, 32, 7, num_layers=2, device=card)
    f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                   device=card).from_cpu_tensor(feat)
    dev = qt.GraphSageSampler(topo, [10, 5], device=card)
    srv = qt.InferenceServer_Debug(dev, f, model, queue.Queue(),
                                   max_coalesce=1, **kw)
    srv.BUCKETS = (8, 16, 32, 64)
    return srv, f, model


def test_failover_answer_on_card(card):
    """A failed device pass (chaos) fails over through the host sampler:
    the answer is the CPU lane's forward of the sampled batch (B2 on the
    card), counted as a failover, with no B1 launch."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.resilience import ChaosPlan, chaos

    telemetry.reset()
    srv, f, model = _card_server(card)
    cpu = qt.GraphSageSampler(srv.sampler.csr_topo, [10, 5], device=card,
                              mode="CPU")
    srv.cpu_sampler = cpu
    ids = np.arange(3, 2000, 151)
    srv.start()
    try:
        b1_before = b1.window_sample.launches
        b2_before = b2.gather_rows.launches
        with chaos.active(ChaosPlan().fail("serving.device_lane")):
            srv.device_q.put(qt.ServingRequest(ids=ids, client=0, seq=0))
            req, out = srv.result_queue.get(timeout=120)
    finally:
        assert srv.stop() == []
    assert not isinstance(out, Exception), out
    assert b1.window_sample.launches == b1_before
    assert b2.gather_rows.launches == b2_before + 1
    (_, _, batch), = srv.failover_log
    assert batch.n_id.device.type == "cuda"
    with torch.inference_mode():
        direct = model(f[batch.n_id], batch.layers)[: len(ids)].cpu()
    assert torch.equal(torch.from_numpy(out), direct)
    c = telemetry.snapshot()["counters"]
    assert c["serving_failover_total{direction=device_to_cpu}"] == 1
    telemetry.reset()


def test_launch_error_is_not_failed_over(card, monkeypatch):
    """A kernel that fails to launch is answered as the error itself: the
    breaker does not count it, no failover serves around it, and stop()
    raises it."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.ops.cuda import build

    telemetry.reset()
    srv, _, _ = _card_server(card)
    srv.cpu_sampler = qt.GraphSageSampler(srv.sampler.csr_topo, [10, 5],
                                          device=card, mode="CPU")

    def broken(*a, **k):
        raise build.KernelError("window_sample launch: CUDA error 700")

    monkeypatch.setattr(b1, "_launch", broken)
    srv.start()
    srv.device_q.put(qt.ServingRequest(ids=np.arange(9), client=0, seq=0))
    req, out = srv.result_queue.get(timeout=120)
    with pytest.raises(build.KernelError):
        srv.stop()
    assert isinstance(out, build.KernelError)
    assert srv._breakers["device"].state == "closed"
    assert not srv.failover_log
    c = telemetry.snapshot()["counters"]
    assert "serving_failover_total{direction=device_to_cpu}" not in c
    telemetry.reset()


def test_wrapper_refusal_is_not_failed_over(card, monkeypatch):
    """B1's wrapper refusing its arguments on the card (every fanout out
    of range) is answered as that refusal: no breaker counts it, the host
    sampler does not serve the request, and stop() raises it."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.ops.cuda import build

    telemetry.reset()
    srv, _, _ = _card_server(card)
    srv.cpu_sampler = qt.GraphSageSampler(srv.sampler.csr_topo, [10, 5],
                                          device=card, mode="CPU")
    monkeypatch.setattr(b1, "_MAX_K", 1)
    launches = b1.window_sample.launches
    srv.start()
    srv.device_q.put(qt.ServingRequest(ids=np.arange(9), client=0, seq=0))
    req, out = srv.result_queue.get(timeout=120)
    with pytest.raises(build.KernelArgumentError):
        srv.stop()
    assert isinstance(out, build.KernelArgumentError)
    assert b1.window_sample.launches == launches
    assert srv._breakers["device"].status()["failures"] == 0
    assert not srv.failover_log
    c = telemetry.snapshot()["counters"]
    assert "serving_failover_total{direction=device_to_cpu}" not in c
    telemetry.reset()


def test_profile_rows_on_card(card):
    """With the profile on, the fused forward and the kernels it launches
    are recorded with ``device: true`` and device seconds from events."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.telemetry import profile

    telemetry.reset()
    srv, _, _ = _card_server(card)
    srv.warmup()
    assert profile.enable()
    try:
        srv._run_bucketed(np.arange(40))
    finally:
        profile.disable()
    rows = {(r["subsystem"], r["key"]): r for r in profile.top_programs(50)}
    for key in (("kernel", "'window_sample_frontier'"),
                ("kernel", "'gather_rows'"), ("serving", "('fused', 64)")):
        assert rows[key]["device"] is True, key
        assert rows[key]["device_s"] > 0, key
    assert rows[("kernel", "'window_sample_frontier'")]["calls"] == 2
    telemetry.reset()


def test_span_block_covers_device_time(card):
    """``trace_scope(block=)`` waits for the card's stream: its span covers
    the device time of a B2 call queued behind a spin (CUDA events), where
    a span without ``block`` covers only the launches."""
    from quiver_tpu_torch.utils import trace

    table = torch.randn(200_000, 256, device=card)
    idx = torch.randint(0, 200_000, (400_000,), device=card)
    b2.gather_rows(table, idx)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    trace.set_enabled(True)
    trace.reset_trace()
    try:
        with trace.trace_scope("blocked", block=table):
            start.record()
            torch.cuda._sleep(20_000_000)
            b2.gather_rows(table, idx)
            end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end)
        with trace.trace_scope("unblocked"):
            torch.cuda._sleep(20_000_000)
            b2.gather_rows(table, idx)
        torch.cuda.synchronize()
        summary = trace.trace_summary()
    finally:
        trace.set_enabled(False)
    assert summary["blocked"]["total_s"] * 1e3 >= device_ms
    assert summary["unblocked"]["total_s"] * 1e3 < 0.5 * device_ms


def _stream_graph(card, with_ts=True):
    """A skewed graph as a streaming graph with inserts (onto a hub and
    onto degree-0 rows), base and delta deletions, and timestamps."""
    from quiver_tpu_torch.stream import StreamingGraph

    topo = _graph(7)
    rng = np.random.default_rng(7)
    ts = rng.integers(0, 1000, topo.edge_count) if with_ts else None
    g = StreamingGraph(topo, edge_ts=ts, delta_capacity=4096, device=card)
    src = np.concatenate([rng.integers(0, 3000, 900), np.full(60, 9),
                          np.arange(5)])
    dst = rng.integers(0, 3000, len(src))
    g.add_edges(src, dst, ts=rng.integers(0, 1000, len(src))
                if with_ts else None)
    rows = np.repeat(np.arange(3000), topo.degree)
    pick = rng.choice(topo.edge_count, 400, replace=False)
    g.remove_edges(rows[pick], topo.indices[pick])
    g.remove_edges(src[:30], dst[:30])
    return g


@pytest.mark.parametrize("windowed", [False, True])
def test_overlay_hop_through_b3_equals_plain(card, windowed):
    """The overlay hop under ``"pwindow"`` reads every element through B3
    (five launches a hop, seven windowed) and equals its plain version
    (``"xla"``) on the card, with deltas, tombstones and a window."""
    from quiver_tpu_torch.ops.sample import sample_neighbors_overlay

    g = _stream_graph(card)
    s = g.snapshot(card)
    rng = np.random.default_rng(11)
    seeds = torch.from_numpy(np.concatenate(
        [[9, 0, 1, 2999], rng.integers(0, 3000, 4000)]).astype(
            np.int32)).to(card)
    mask = torch.from_numpy(rng.random(len(seeds)) < 0.9).to(card)
    window = (100, 800) if windowed else None
    for k in (5, 25):
        args = (s.indptr, s.indices, s.tomb, s.d_indptr, s.d_indices,
                seeds, k, 0x1234567, 0x89ABCDEF, mask, s.base_ts, s.d_ts,
                window)
        b3.element_gather.launches = 0
        got = sample_neighbors_overlay(*args, "pwindow")
        assert b3.element_gather.launches == (7 if windowed else 5)
        want = sample_neighbors_overlay(*args, "xla")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert (got.eid[got.mask] >= s.epad).any()


def test_zero_delta_overlay_pipeline_equals_b1(card):
    """With no deltas and no tombstones the overlay pipeline (B3) equals
    the frozen ``"pwindow"`` pipeline (B1) on the same key words."""
    from quiver_tpu_torch.stream import StreamingGraph

    topo = _graph(8)
    g = StreamingGraph(topo, device=card)
    stream = qt.GraphSageSampler(g, [25, 10], device=card)
    frozen = qt.GraphSageSampler(topo, [25, 10], device=card, dedup="none")
    seeds = torch.from_numpy(np.random.default_rng(8).integers(
        0, 3000, 512).astype(np.int32)).to(card)
    kw = np.random.default_rng(9).integers(0, 2**32, (2, 2), np.uint32)
    b1.window_sample.launches = 0
    want = frozen.pipeline(seeds, kw)
    assert b1.window_sample.launches == 2
    b3.element_gather.launches = 0
    got = stream.pipeline(seeds, kw)
    assert b3.element_gather.launches == 10
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for la, lb in zip(got[3], want[3]):
        assert torch.equal(la.nbr_local, lb.nbr_local)
        assert torch.equal(la.mask, lb.mask)
        assert int(la.num_targets) == int(lb.num_targets)


# -- slice 12: sharding across devices, on one card ------------------------
def _shard_mesh(card, n, axis="shard"):
    return qt.make_mesh((axis,), devices=[card] * n)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_mesh_feature_on_card_equals_table(card, n_shards, dtype):
    """MeshFeature's per-shard B2 gathers and max combine on the card:
    bitwise the table's rows, B2 launched once a shard, a small pool
    falling back exactly."""
    from quiver_tpu_torch.mesh import MeshFeature

    rng = np.random.default_rng(n_shards)
    src = torch.from_numpy(rng.standard_normal((5003, 24)).astype(
        np.float32) * 100).to(dtype)
    mf = MeshFeature(src, n_shards=n_shards, mesh=_shard_mesh(card,
                                                            n_shards))
    ids = rng.integers(0, 5003, 4097)
    b2.gather_rows.launches = 0
    got = mf[ids]
    assert got.device.type == "cuda"
    assert b2.gather_rows.launches == n_shards
    assert torch.equal(got.cpu().view(torch.int16 if dtype == torch.bfloat16
                                      else dtype),
                       src[torch.from_numpy(ids)].view(
                           torch.int16 if dtype == torch.bfloat16
                           else dtype))
    small = MeshFeature(src, n_shards=2, mesh=_shard_mesh(card, 2),
                        page_rows=8, pool_pages=1)
    assert torch.equal(small[ids].cpu(), src[torch.from_numpy(ids)])
    assert small.fallbacks == 1


@pytest.mark.parametrize("mode", ["pallas", "blocked", "pwindow"])
def test_mesh_sampler_on_card_equals_single_device(card, mode):
    """Every read through B3 (5 launches a hop a shard): the sharded hop
    equals the single-device overlay hop's plain version bitwise."""
    from quiver_tpu_torch.mesh import MeshSampler
    from quiver_tpu_torch.ops.sample import sample_neighbors_overlay

    topo = _graph(3)
    ms = MeshSampler(topo.indptr, topo.indices, n_shards=4,
                     mesh=_shard_mesh(card, 4), gather_mode=mode)
    seeds = torch.from_numpy(np.random.default_rng(4).integers(
        0, 3000, 2048)).to(card)
    b3.element_gather.launches = 0  # both entries count here
    got = ms.sample(seeds, 10, (0x1234, 0xBEEF))
    assert b3.element_gather.launches == 5 * 4
    ip = torch.from_numpy(topo.indptr.astype(np.int32)).to(card)
    ix = torch.from_numpy(topo.indices).to(card)
    zeros = torch.zeros(3001, dtype=torch.int32, device=card)
    want = sample_neighbors_overlay(
        ip, ix, torch.zeros_like(ix), zeros, zeros[:8], seeds, 10, 0x1234,
        0xBEEF)
    for f in ("nbrs", "mask", "counts", "eid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_dist_structures_on_card(card):
    """DistFeature, RingFeature and HierFeature over shards that repeat
    the card: every row bitwise the table's, B2 launched, no overflow."""
    from quiver_tpu_torch.utils.mesh import Mesh

    rng = np.random.default_rng(5)
    full = rng.standard_normal((4000, 40)).astype(np.float32)
    mesh = qt.make_mesh(("data",), devices=[card] * 4)
    info = qt.PartitionInfo(host=0, hosts=4,
                            global2host=rng.integers(0, 4, 4000))
    ids = rng.integers(0, 4000, (4, 1024))
    b2.gather_rows.launches = 0
    df = qt.DistFeature.from_global_feature(full, mesh, info)
    assert np.array_equal(df.lookup(ids).cpu().numpy(), full[ids])
    assert b2.gather_rows.launches == 8 and df.overflow_stats().sum() == 0
    rf = qt.RingFeature(full, mesh)
    assert np.array_equal(rf.lookup(ids).cpu().numpy(), full[ids])
    hm = Mesh(np.array([card] * 4, dtype=object).reshape(2, 2),
              ("dcn", "ici"))
    hf = qt.HierFeature.from_global_feature(full, hm, hot_count=1000)
    hids = ids.reshape(2, 2, 1024)
    assert np.array_equal(hf.lookup(hids).cpu().numpy(), full[hids])
    assert hf.traffic_stats()["drops"].sum() == 0


def test_dist_sampler_on_card_blocked_equals_xla(card):
    """DistGraphSampler's per-shard hops through B3 (``"blocked"``) draw
    exactly what plain indexing draws, at exact caps with no drops."""
    topo = _graph(6)
    mesh = qt.make_mesh(("data",), devices=[card] * 4)
    seeds = np.random.default_rng(6).integers(0, 3000, (4, 256))
    kw = np.random.default_rng(7).integers(0, 2**32, (2, 4, 2),
                                           dtype=np.uint64)
    b3.element_gather.launches = 0
    got = qt.DistGraphSampler(topo, mesh, [10, 5]).sample(seeds,
                                                         key_words=kw)
    assert b3.element_gather.launches == 2 * 4 * 2  # bounds, draws
    xla = qt.DistGraphSampler(topo, mesh, [10, 5], gather_mode="xla")
    want = xla.sample(seeds, key_words=kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for pb, wb in zip(got[3], want[3]):
        assert torch.equal(pb.nbr_local, wb.nbr_local)
        assert torch.equal(pb.mask, wb.mask)
    assert xla.overflow_stats().sum() == 0


def test_ici_shard_and_mmap_features_on_card(card, tmp_path):
    """``ici_shard`` over a mesh that repeats the card, and ``from_mmap``'s
    hot rows through B2: bitwise the table's."""
    rng = np.random.default_rng(8)
    full = rng.standard_normal((3000, 20)).astype(np.float32)
    mesh = qt.make_mesh(("data",), devices=[card] * 3)
    f = qt.Feature(device_cache_size=1000, cache_unit="rows",
                   cache_policy="ici_shard", mesh=mesh).from_cpu_tensor(full)
    ids = rng.integers(0, 3000, 2000)
    b2.gather_rows.launches = 0
    got = f.lookup_device(torch.from_numpy(ids).to(card))
    assert b2.gather_rows.launches == 3
    assert np.array_equal(got.cpu().numpy(), full[ids])
    path = str(tmp_path / "t.npy")
    np.save(path, full)
    mf = qt.Feature.from_mmap(path, device_cache_size=1000 * 20 * 4)
    assert np.array_equal(mf[ids].cpu().numpy(), full[ids])


def test_bf16_graphsage_on_card(card):
    """``GraphSAGE(dtype=torch.bfloat16)`` on the card: bf16 logits,
    fp32 parameters, within the bf16 tolerance of the fp32 model."""
    topo = _graph(9)
    s = qt.GraphSageSampler(topo, [10, 5])
    b = s.sample(np.arange(256))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3000, 32)).astype(np.float32)).to(card)[b.n_id.long()]
    m = qt.GraphSAGE(32, 16, 7, num_layers=2, dropout=0.0)
    mb = qt.GraphSAGE(32, 16, 7, num_layers=2, dropout=0.0,
                      dtype=torch.bfloat16)
    mb.load_state_dict(m.state_dict())
    with torch.no_grad():
        a, c = m(x, b.layers), mb(x.to(torch.bfloat16), b.layers)
    assert c.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mb.parameters())
    assert (a - c.float()).abs().max() <= 2**-5 * a.abs().max()


@pytest.mark.parametrize("shape", [(1,), (7,), (2048, 25), (1024, 15),
                                   (16_384, 10), (180_224, 5), (12_345,),
                                   (3, 5, 2)])
def test_threefry_uniform_kernel_equals_plain(card, shape):
    """The threefry kernel's bits are its plain version's (JAX's
    ``jax.random.uniform``), at the hops' shapes and ragged ones; one
    launch a call, none for an empty shape."""
    from quiver_tpu_torch.utils import rng

    for key in (rng.key(0), rng.key(2**31 - 1), rng.split(rng.key(5), 3)[2],
                np.array([0xFFFFFFFF, 0x80000000], np.uint32)):
        before = tf.threefry_uniform.launches
        got = tf.threefry_uniform(key, shape, card)
        torch.cuda.synchronize()
        assert tf.threefry_uniform.launches == before + 1
        want = tf.threefry_uniform_plain(key, shape, card)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool(((got >= 0) & (got < 1)).all())
    before = tf.threefry_uniform.launches
    assert tf.threefry_uniform(rng.key(1), (0, 4), card).shape == (0, 4)
    assert tf.threefry_uniform.launches == before


# jax.random.uniform(jax.random.PRNGKey(s), shape) as JAX 0.9 gives them
# (jax_threefry_partitionable on), float bits as uint32
THREEFRY_GOLDEN = {
    (0, (8,)): (0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550, 0x3F11E43A,
                0x3E2979A0, 0x3E9ED1D4, 0x3F3081CC),
    (2**31 - 1, (3, 5)): (0x3E488268, 0x3E9348A8, 0x3EA9298C, 0x3EC4D054,
                          0x3F3602AC, 0x3F45E7B4, 0x3C13B880, 0x3DE25AC0,
                          0x3F5F4090, 0x3F63B12C, 0x3E1E6358, 0x3F108968,
                          0x3F598E84, 0x3EA7A740, 0x3E4B9508),
}


@pytest.mark.parametrize("seed,shape", list(THREEFRY_GOLDEN))
def test_threefry_uniform_kernel_keeps_jax_bits(card, seed, shape):
    """The threefry kernel over the shared cipher (``threefry.cuh``)
    writes JAX's own bits, recorded from JAX, not from the plain
    version."""
    from quiver_tpu_torch.utils import rng

    got = tf.threefry_uniform(rng.key(seed), shape, card)
    torch.cuda.synchronize()
    want = np.array(THREEFRY_GOLDEN[seed, shape], np.uint32).view(np.int32)
    assert torch.equal(got.view(torch.int32).reshape(-1).cpu(),
                       torch.from_numpy(want))


# B1's keyed instance at the main path's hop shapes: Reddit's two hops,
# products' three, a MAG240M block (papers at hop 2), and k = 1
KEYED_B1_SHAPES = [(2048, 25), (53_248, 10), (1024, 15), (16_384, 10),
                   (180_224, 5), (26_624, 15), (4096, 1)]


@pytest.mark.parametrize("B,k", KEYED_B1_SHAPES)
def test_keyed_window_sample_kernel_equals_plain(card, B, k):
    """B1's threefry instance, both entries, bitwise its plain version
    (``"xla"`` reads and ``threefry_uniform_plain``, no kernel) over a
    frontier with masked seeds and one without; each launch counted once
    in ``launches`` and once in ``launches_key``, and no threefry kernel
    launched."""
    from quiver_tpu_torch.utils import rng

    topo = _graph(k)
    ip, ix = topo.to_device(card)
    g = np.random.default_rng(B + k)
    seeds = torch.from_numpy(np.concatenate([
        np.arange(12), g.integers(0, 3000, B - 13), [2999]]).astype(
            np.int32)).to(card)
    mask = torch.from_numpy(g.random(B) < 0.7).to(card)
    k0, k1 = (int(w) for w in rng.split(rng.key(B), 2)[1])
    tf_before = tf.threefry_uniform.launches
    for m in (mask, None):
        before = (b1.window_sample.launches, b1.window_sample.launches_key)
        got = b1.window_sample(ip, ix, seeds, k, k0, k1, m, sample_rng="key")
        torch.cuda.synchronize()
        assert (b1.window_sample.launches,
                b1.window_sample.launches_key) == (before[0] + 1,
                                                   before[1] + 1)
        want = b1.window_sample_plain(ip, ix, seeds, k, k0, k1, m, "key")
        for name, a, b in zip(("nbrs", "mask", "counts", "eid"), got, want):
            assert torch.equal(a, b), name
    bufs = [_frontier_buffers(seeds, mask, k) for _ in range(2)]
    before = b1.window_sample.launches_key
    got = b1.window_sample_frontier(ip, ix, *bufs[0], B, k, k0, k1,
                                    return_eid=True, sample_rng="key")
    torch.cuda.synchronize()
    assert b1.window_sample.launches_key == before + 1
    want = b1.window_sample_frontier_plain(ip, ix, *bufs[1], B, k, k0, k1,
                                           return_eid=True, sample_rng="key")
    assert torch.equal(bufs[0][0], bufs[1][0])
    assert torch.equal(bufs[0][1], bufs[1][1])
    for name in ("nbr_local", "mask", "counts", "eid"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert tf.threefry_uniform.launches == tf_before
    # the hash instance on the same inputs draws other neighbours
    hashed = b1.window_sample(ip, ix, seeds, k, k0, k1, mask)
    assert not torch.equal(hashed.eid, want.eid)


def test_keyed_window_sample_refuses_a_bad_rng(card):
    ip, ix, seeds, _ = _b1_inputs(card, 3)
    with pytest.raises(b1.KernelArgumentError, match="sample_rng"):
        b1.window_sample(ip, ix, seeds, 3, 1, 2, sample_rng="auto")
    frontier, fmask = _frontier_buffers(seeds, seeds >= 0, 3)
    with pytest.raises(b1.KernelArgumentError, match="sample_rng"):
        b1.window_sample_frontier(ip, ix, frontier, fmask, seeds.shape[0], 3,
                                  1, 2, sample_rng="threefry")


def test_threefry_uniform_refuses_bad_input(card):
    with pytest.raises(tf.KernelArgumentError):
        tf.threefry_uniform([1, 2, 3], (4,), card)
    with pytest.raises(tf.KernelArgumentError):
        tf.threefry_uniform([1, 2], (-1, 4), card)
    with pytest.raises(tf.KernelArgumentError):
        tf.threefry_uniform([1, 2**32], (4,), card)


@pytest.mark.parametrize("mode", ["auto", "pallas", "blocked", "xla"])
@pytest.mark.parametrize("dedup", ["none", "hop"])
def test_keyed_sampler_on_card_equals_cpu(card, mode, dedup):
    """``sample_rng="key"`` on the card, the batch bitwise the CPU's
    (``"auto"`` is ``"blocked"`` under the key).  A ``"blocked"`` hop is
    one launch of B1's keyed instance (its pipeline entry under
    ``dedup="none"``, its literal entry under ``"hop"``), with no threefry
    and no B3 launch; ``"pallas"`` and ``"xla"`` hops launch the threefry
    kernel once a hop and never B1."""
    from quiver_tpu_torch.utils import rng

    topo = _graph(8, n=3000)
    ids = np.arange(0, 3000, 41)
    s = qt.GraphSageSampler(topo, [10, 5, 3], device=card,
                            gather_mode=mode, sample_rng="key", dedup=dedup)
    assert s.gather_mode == ("blocked" if mode == "auto" else mode)
    fused = s.gather_mode == "blocked"
    before = (tf.threefry_uniform.launches, b1.window_sample.launches,
              b1.window_sample.launches_key, b3.element_gather.launches)
    got = s.sample(ids, key=rng.key(4))
    torch.cuda.synchronize()
    ran = (tf.threefry_uniform.launches, b1.window_sample.launches,
           b1.window_sample.launches_key, b3.element_gather.launches)
    ran = tuple(a - b for a, b in zip(ran, before))
    if fused:
        assert ran == (0, 3, 3, 0)
    else:
        assert ran[:3] == (3, 0, 0)
        assert (ran[3] > 0) == (mode == "pallas")
    want = qt.GraphSageSampler(topo, [10, 5, 3], device="cpu",
                               gather_mode="xla", sample_rng="key",
                               dedup=dedup).sample(ids, key=rng.key(4))
    assert torch.equal(got.n_id.cpu(), want.n_id)
    assert torch.equal(got.n_id_mask.cpu(), want.n_id_mask)
    for a, b in zip(got.layers, want.layers):
        assert torch.equal(a.nbr_local.cpu(), b.nbr_local)
        assert torch.equal(a.mask.cpu(), b.mask)
    hashed = qt.GraphSageSampler(topo, [10, 5, 3], device=card)
    before = tf.threefry_uniform.launches
    hashed.sample(ids, key=rng.key(4))
    assert tf.threefry_uniform.launches == before


# SAGEConv's neighbour mean: products' three layers (targets, k, width) and
# Reddit's first, whose 2,408-byte fp32 rows take 8-byte units; then k over
# one warp's 32 slots, k = 1 and an odd bf16 width (2-byte units)
SAGE_MEAN_SHAPES = [(180_224, 5, 100), (16_384, 10, 256), (1_024, 15, 256),
                    (2_048, 25, 602), (300, 70, 9), (513, 1, 33)]


def _sage_block(card, t, k, seed, unique=True):
    """A ``[t, k]`` block as the pipeline lays it out (``t + b*k + j``
    where valid, 0 where masked; about 13% masked, a few targets with no
    valid slot) or, with ``unique=False``, valid slots drawn from the
    block's rows with repeats (as under ``dedup="hop"``)."""
    g = torch.Generator(device=card).manual_seed(seed)
    mask = torch.rand((t, k), generator=g, device=card) < 0.87
    mask[::97] = False
    n = t + t * k
    if unique:
        pos = torch.arange(t * k, device=card, dtype=torch.int32).view(t, k)
        nbr = torch.where(mask, pos + t, torch.zeros_like(pos))
    else:
        n = max(t // 3, 1)
        nbr = torch.randint(0, n, (t, k), generator=g, device=card,
                            dtype=torch.int32)
    return nbr, mask, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SAGE_MEAN_SHAPES)
def test_sage_mean_kernel_equals_plain(card, dtype, shape):
    """The forward kernel bitwise its plain version, on ``x`` and on the
    ``x[1:]`` view (another alignment of the rows); one launch a call."""
    t, k, d = shape
    nbr, mask, n = _sage_block(card, t, k, t + k)
    g = torch.Generator(device=card).manual_seed(d)
    x = torch.randn((n + 1, d), generator=g, device=card).to(dtype)
    bits = _b2_bits
    for rows in (x[:n], x[1:]):
        want = sm.sage_mean_plain(rows, nbr, mask)
        before = sm.sage_mean.launches
        got = sm.sage_mean(rows, nbr, mask)
        torch.cuda.synchronize()
        assert sm.sage_mean.launches == before + 1
        assert got.shape == (t, d) and got.dtype == dtype
        assert torch.equal(bits(got), bits(want))
    assert not bool(got[::97].any())  # no valid slot: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SAGE_MEAN_SHAPES)
def test_sage_mean_backward_kernel_equals_plain(card, dtype, shape):
    """The backward kernel bitwise its plain version where each row takes
    one valid slot (the pipeline's layout), with and without the self
    rows' gradient.  Where rows repeat, the atomics add in another order,
    each add rounding: every row within ``2 (c + 1) u S`` of the exact sum
    (fp64), for ``c`` adds into the row, ``S`` the sum of their
    magnitudes and ``u`` the dtype's unit roundoff."""
    t, k, d = shape
    g = torch.Generator(device=card).manual_seed(d + 1)
    grad = torch.randn((t, d), generator=g, device=card).to(dtype)
    gself = torch.randn((t, d), generator=g, device=card).to(dtype)
    for unique in (True, False):
        nbr, mask, n = _sage_block(card, t, k, t + k, unique)
        for self_rows in ((None,) if t > n else (None, gself)):
            want = sm.sage_mean_backward_plain(grad, nbr, mask, n, self_rows)
            before = sm.sage_mean_backward.launches
            got = sm.sage_mean_backward(grad, nbr, mask, n, self_rows)
            torch.cuda.synchronize()
            assert sm.sage_mean_backward.launches == before + 1
            assert got.shape == (n, d) and got.dtype == dtype
            if unique:
                assert torch.equal(_b2_bits(got), _b2_bits(want))
                continue
            exact = sm.sage_mean_backward_plain(grad.double(), nbr, mask, n)
            mag = sm.sage_mean_backward_plain(grad.double().abs(), nbr,
                                              mask, n)
            adds = torch.bincount(nbr[mask].long(), minlength=n)
            u = 2.0**-24 if dtype == torch.float32 else 2.0**-8
            bound = 2 * (adds[:, None] + 1) * u * mag
            for rows in (got, want):
                assert bool(((rows.double() - exact).abs() <= bound).all())


def _products_launches(card, dropout):
    """A three-layer GraphSAGE fused step on the card (small graph,
    widths 24 -> 32 -> 32 -> 7) at ``dropout``: the four hand-written
    kernels' launches added by each of 4 calls, and the kernels a replayed
    step's profile holds (taken up to 8 times, until it holds the count
    the model runs: the profiler may drop device events from a capture)."""
    topo = _graph(4, n=2000)
    feat = np.random.default_rng(2).standard_normal(
        (2000, 24)).astype(np.float32)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, 7, 2000))
    torch.manual_seed(0)
    model = qt.GraphSAGE(24, 32, 7, num_layers=3, dropout=dropout,
                         device=card)
    s = qt.GraphSageSampler(topo, [6, 4, 3], device=card)
    f = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                   device=card).from_cpu_tensor(feat)
    step = qt.make_fused_train_step(
        s, f, model, torch.optim.Adam(model.parameters(), lr=3e-3))
    ids = np.arange(0, 2000, 7)
    lab = labels[ids].to(card)
    ones = torch.ones(len(ids), dtype=torch.bool, device=card)
    fns = (sm.sage_mean, sm.sage_mean_backward, sa.sage_act,
           sa.sage_act_backward)
    added = []
    for i in range(4):
        before = tuple(fn.launches for fn in fns)
        step(ids, lab, ones, np.array([[1, i], [2, i], [3, i]], np.uint32))
        added.append(tuple(fn.launches - b for fn, b in zip(fns, before)))
    torch.cuda.synchronize()
    assert (step.train.captures, step.train.eager_calls) == (1, 0)
    want = (3, 2) + ((2, 2) if dropout else (0, 0))
    for i in range(8):
        kernels = _replayed_kernels(
            lambda: step(ids, lab, ones,
                         np.array([[1, i], [2, i], [3, i]], np.uint32)))
        if kernels == want:
            break
    return added, kernels


def test_sage_conv_launches_per_products_step(card):
    """A three-layer GraphSAGE fused step on the card launches the forward
    kernel once a layer and the backward twice (layer 0's input, B2's rows,
    takes no gradient) in each pass of the model: the first call's warm-up
    pass and its capture of the step's CUDA graphs; the later calls replay
    them and launch none.  A replayed step's profile holds both kernels as
    many times a step.  Without dropout the activation kernels run
    nowhere."""
    added, kernels = _products_launches(card, 0.0)
    assert added == [(6, 4, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)]
    assert kernels == (3, 2, 0, 0)


def test_sage_act_launches_per_products_step(card):
    """With dropout 0.5 each hidden layer's activation is one
    ``sage_act`` launch forward and one ``sage_act_backward`` in each of
    the first call's two passes, none in a replay; a replayed step's
    profile holds 2 and 2 of their kernels."""
    added, kernels = _products_launches(card, 0.5)
    assert added == [(6, 4, 4, 4), (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)]
    assert kernels == (3, 2, 2, 2)


def _replayed_kernels(run):
    """The ``sage_mean_fwd``, ``sage_mean_bwd``, ``sage_act_fwd`` and
    ``sage_act_bwd`` kernels the card ran in ``run()`` under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return tuple(sum(k in n for n in names)
                 for k in ("sage_mean_fwd", "sage_mean_bwd", "sage_act_fwd",
                           "sage_act_bwd"))


def _products_step_objects(card, topo, feat, base):
    """A sampler, whole-table feature, GraphSAGE at ``base``'s weights and
    Adam on the card, at products' widths."""
    model = qt.GraphSAGE(100, 256, 47, num_layers=3, dropout=0.5,
                         device=card)
    model.load_state_dict(base.state_dict())
    sampler = qt.GraphSageSampler(topo, [15, 10, 5], device=card)
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device=card).from_cpu_tensor(feat)
    return sampler, feature, model, torch.optim.Adam(model.parameters(),
                                                     lr=3e-3)


@pytest.fixture(params=[False, True], ids=["spans_off", "spans_on"])
def retained(request):
    """The process tracer retaining span events, or not, with telemetry
    on; both put back after."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.telemetry import spans

    tracer = telemetry.get_tracer()
    was = (telemetry.enabled(), tracer.tracing)
    telemetry.set_enabled(True)
    tracer.set_tracing(request.param)
    tracer.reset()
    assert spans._HOT is request.param
    yield request.param
    tracer.reset()
    tracer.set_tracing(was[1])
    telemetry.set_enabled(was[0])


def test_graphed_fused_step_is_bitwise_the_eager_step(card, monkeypatch,
                                                      retained):
    """The fused step on the card (forward and backward replayed from CUDA
    graphs) against the eager step (``make_train_step`` over the same
    sampler's pipeline and lookup) from the same weights, dropout seed and
    feeds, at products' widths (100 -> 256 -> 256 -> 47, fanouts
    [15, 10, 5], batch 1,024) on a small graph: every loss, the first
    gradients and the parameters after every step are bitwise equal (so
    are the dropout masks), and the returned losses are distinct tensors.
    The 5 steps run through one capture, 2 replays a step.  Then two
    batches of 512 (eager) and one of 1,024 (replayed) stay bitwise the
    eager step's.  All of it with span events retained and not; retained,
    each of the 8 fused steps records one ``train.step``."""
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.parallel.train import make_train_step

    n = 20_000
    indptr, indices = qt.synthetic_csr(n, 400_000, seed=5)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((n, 100)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 47, n)).to(card)
    torch.manual_seed(0)
    base = qt.GraphSAGE(100, 256, 47, num_layers=3, dropout=0.5,
                        device=card)
    gs, gf, gm, go = _products_step_objects(card, topo, feat, base)
    es, ef, em, eo = _products_step_objects(card, topo, feat, base)
    graphed = qt.make_fused_train_step(gs, gf, gm, go, seed=7)
    eager = make_train_step(em, eo, seed=7)
    replays = [0]
    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        replays[0] += 1
        return replay(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)

    def both(size, i):
        ids = rng.choice(n, size, replace=False).astype(np.int64)
        lab = labels[torch.from_numpy(ids).to(card)]
        ones = torch.ones(size, dtype=torch.bool, device=card)
        kw = rng.integers(0, 2**32, (3, 2), dtype=np.uint32)
        lg = graphed(ids, lab, ones, kw)
        n_id, _, _, blocks, _ = es.pipeline(es.seed_tensor(ids), kw,
                                            weighted=False)
        le = eager(ef.lookup_device(n_id), blocks, lab, ones)
        assert torch.equal(lg, le), f"step {i}: loss {lg} != {le}"
        for (name, p), q in zip(gm.named_parameters(), em.parameters()):
            assert torch.equal(p, q), f"step {i}: {name} differs"
        return lg

    losses = []
    for i in range(5):
        losses.append(both(1024, i))
        if i == 0:
            for (name, p), q in zip(gm.named_parameters(), em.parameters()):
                assert torch.equal(p.grad, q.grad), f"gradient of {name}"
    torch.cuda.synchronize()
    assert replays[0] == 10
    assert (graphed.train.captures, graphed.train.eager_calls) == (1, 0)
    assert len({x.data_ptr() for x in losses}) == 5
    assert len({float(x) for x in losses}) == 5
    for i, size in enumerate((512, 512, 1024)):
        both(size, 5 + i)
    assert (graphed.train.captures, graphed.train.eager_calls) == (1, 2)
    assert replays[0] == 12
    roots = [e for e in telemetry.get_tracer().events()
             if e["name"] == "train.step"]
    assert len(roots) == (8 if retained else 0)


def test_sage_mean_refuses_bad_input(card):
    x = torch.zeros((40, 8), device=card)
    nbr, mask, _ = _sage_block(card, 4, 3, 0)
    for args in ((x.double(), nbr, mask), (x.half(), nbr, mask),
                 (x[:, 1:], nbr, mask), (x[0], nbr, mask),
                 (x, nbr.to(torch.int16), mask), (x, nbr.long(), mask),
                 (x, nbr.cpu(), mask),
                 (x, nbr.t(), mask.t()), (x, nbr, mask.to(torch.uint8)),
                 (x, nbr, mask[:, :2].contiguous()),
                 (torch.zeros((0, 8), device=card), nbr, mask)):
        with pytest.raises(KernelArgumentError):
            sm.sage_mean(*args)
    g = torch.zeros((4, 8), device=card)
    for args, kw in (((g.double(), nbr, mask, 40), {}),
                     ((g[:, 1:], nbr, mask, 40), {}),
                     ((g[:3], nbr, mask, 40), {}),
                     ((g, nbr, mask, -1), {}),
                     ((g, nbr, mask, 40), {"grad_self": g[:2]}),
                     ((g, nbr, mask, 40), {"grad_self": g.bfloat16()}),
                     ((g, nbr, mask, 2), {"grad_self": g})):
        with pytest.raises(KernelArgumentError):
            sm.sage_mean_backward(*args, **kw)


# GraphSAGE's hidden-layer activation: widths 1, 3 (under a 16-byte unit),
# 100 (products' input width), 256 (its hidden width) and 257
SAGE_ACT_WIDTHS = [1, 3, 100, 256, 257]
SAGE_ACT_SPECIAL = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0,
                    -1.5, 2.5, 1e-30, -1e-30, 3.0e38, -3.0e38, 0.7]


def _sage_act_inputs(card, dtype, width, seed, offset=0):
    """``a``, ``b``, ``keep`` and ``dy`` ``[T, width]`` on the card, each a
    view ``offset`` elements into its storage: the addends hold every pair
    of the special values (NaN, +-Inf, +-0.0, negatives, tiny and huge),
    then normal draws of both signs; ``keep`` is a 0/1 draw at 0.6."""
    g = torch.Generator(device=card).manual_seed(seed)
    s = torch.tensor(SAGE_ACT_SPECIAL, device=card)
    pairs = torch.cartesian_prod(s, s)
    t = -(-(pairs.shape[0] + 600) // width)
    n = t * width

    def view(x):
        buf = torch.empty(n + offset, dtype=dtype, device=card)
        buf[offset:] = x.to(dtype)
        return buf[offset:].view(t, width)

    a = torch.randn(n, generator=g, device=card)
    b = torch.randn(n, generator=g, device=card)
    a[:pairs.shape[0]], b[:pairs.shape[0]] = pairs[:, 0], pairs[:, 1]
    keep = torch.empty(n, device=card).bernoulli_(0.6, generator=g)
    dy = torch.randn(n, generator=g, device=card)
    dy[:5] = torch.tensor([-0.0, 0.0, -1e-30, 3.0e38, float("nan")])
    return view(a), view(b), view(keep), view(dy)


def _first_difference(got, want, *inputs):
    bad = (_b2_bits(got) != _b2_bits(want)).nonzero()
    if not len(bad):
        return ""
    i = tuple(bad[0].tolist())
    return (f"{len(bad)} differ; first at {i}: got {got[i].item()!r}, want "
            f"{want[i].item()!r}, inputs "
            f"{[x[i].item() for x in inputs]}")


@pytest.mark.parametrize("p", [0.5, 0.3, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", SAGE_ACT_WIDTHS)
def test_sage_act_kernels_equal_plain_and_the_chain(card, width, dtype, p):
    """Forward and backward kernels bitwise their plain versions run on
    the card, and ``SageAct``'s gradient bitwise autograd's of the chain
    (``F.relu(a + b) * keep / (1 - p)``), on aligned tensors (16-byte
    vectors) and on views one element in (the scalar loop), the code
    aligned and one byte in; one launch a call."""
    for offset in (0, 1):
        a, b, keep, dy = _sage_act_inputs(card, dtype, width, width, offset)
        before = (sa.sage_act.launches, sa.sage_act_backward.launches)
        y, code = sa.sage_act(a, b, keep, p)
        y_p, code_p = sa.sage_act_plain(a, b, keep, p)
        torch.cuda.synchronize()
        assert y.dtype == dtype and code.dtype == torch.uint8
        assert torch.equal(_b2_bits(y), _b2_bits(y_p)), _first_difference(
            y, y_p, a, b, keep)
        assert torch.equal(code, code_p)
        codes = (code, torch.empty(code.numel() + 1, dtype=torch.uint8,
                                   device=card)[1:].view(code.shape))
        codes[1].copy_(code)
        for c in codes:
            dx = sa.sage_act_backward(dy, c, p)
            dx_p = sa.sage_act_backward_plain(dy, c, p)
            torch.cuda.synchronize()
            assert torch.equal(_b2_bits(dx), _b2_bits(dx_p)), \
                _first_difference(dx, dx_p, dy, c)
        assert (sa.sage_act.launches - before[0],
                sa.sage_act_backward.launches - before[1]) == (1, 2)
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        got = torch.autograd.grad(sa.SageAct.apply(ar, br, keep, p),
                                  (ar, br), dy)
        ac, bc = a.clone().requires_grad_(), b.clone().requires_grad_()
        want = torch.autograd.grad(F.relu(ac + bc) * keep / (1.0 - p),
                                   (ac, bc), dy)
        for g, w in zip(got, want):
            assert torch.equal(_b2_bits(g), _b2_bits(w)), _first_difference(
                g, w, a, b, keep, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sage_act_in_a_cuda_graph(card, dtype):
    """``SageAct`` forward and backward captured in a CUDA graph: each
    replay over new inputs gives the plain versions' outputs bitwise."""
    a, b, keep, dy = _sage_act_inputs(card, dtype, 256, 9)
    a.requires_grad_()
    b.requires_grad_()

    def run():
        y = sa.SageAct.apply(a, b, keep, 0.5)
        return (y,) + torch.autograd.grad(y, (a, b), dy)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for seed in (10, 11):
        na, nb, nk, nd = _sage_act_inputs(card, dtype, 256, seed)
        with torch.no_grad():
            for dst, src in ((a, na), (b, nb), (keep, nk), (dy, nd)):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        y_p, code_p = sa.sage_act_plain(na, nb, nk, 0.5)
        dx_p = sa.sage_act_backward_plain(nd, code_p, 0.5)
        for got, want in zip(outs, (y_p, dx_p, dx_p)):
            assert torch.equal(_b2_bits(got), _b2_bits(want))


def test_graphed_step_with_sage_act_is_bitwise_the_chain(card, monkeypatch):
    """The graphed fused step at products' widths (100 -> 256 -> 256 ->
    47, dropout 0.5, fanouts [15, 10, 5], batch 1,024), whose hidden layers
    run ``sage_act``, against the eager step of a model that runs the
    chain it replaced, from the same weights, dropout seed and feeds: over
    5 steps every loss, the first gradients and the parameters after every
    step are bitwise equal."""
    from quiver_tpu_torch.models import sage as sage_mod
    from quiver_tpu_torch.parallel.train import make_train_step

    kernel = [True]
    monkeypatch.setattr(sage_mod, "_act_kernel_takes",
                        lambda t: kernel[0] and t.is_cuda)
    n = 20_000
    indptr, indices = qt.synthetic_csr(n, 400_000, seed=8)
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((n, 100)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 47, n)).to(card)
    torch.manual_seed(1)
    base = qt.GraphSAGE(100, 256, 47, num_layers=3, dropout=0.5,
                        device=card)
    gs, gf, gm, go = _products_step_objects(card, topo, feat, base)
    es, ef, em, eo = _products_step_objects(card, topo, feat, base)
    graphed = qt.make_fused_train_step(gs, gf, gm, go, seed=3)
    eager = make_train_step(em, eo, seed=3)
    before = sa.sage_act.launches
    for i in range(5):
        ids = rng.choice(n, 1024, replace=False).astype(np.int64)
        lab = labels[torch.from_numpy(ids).to(card)]
        ones = torch.ones(1024, dtype=torch.bool, device=card)
        kw = rng.integers(0, 2**32, (3, 2), dtype=np.uint32)
        kernel[0] = True
        lg = graphed(ids, lab, ones, kw)
        kernel[0] = False
        n_id, _, _, blocks, _ = es.pipeline(es.seed_tensor(ids), kw,
                                            weighted=False)
        le = eager(ef.lookup_device(n_id), blocks, lab, ones)
        assert torch.equal(lg, le), f"step {i}: loss {lg} != {le}"
        if i == 0:
            for (name, p), q in zip(gm.named_parameters(), em.parameters()):
                assert torch.equal(p.grad, q.grad), f"gradient of {name}"
        for (name, p), q in zip(gm.named_parameters(), em.parameters()):
            assert torch.equal(p, q), f"step {i}: {name} differs"
    torch.cuda.synchronize()
    assert sa.sage_act.launches - before == 4  # the first call's passes
    assert (graphed.train.captures, graphed.train.eager_calls) == (1, 0)


def test_sage_act_refuses_bad_input(card):
    a = torch.zeros((40, 8), device=card)
    for args in ((a.double(), a.double(), a.double(), 0.5),
                 (a.half(), a.half(), a.half(), 0.5),
                 (a, a.bfloat16(), a, 0.5), (a, a, a[:, :4], 0.5),
                 (a, a.t(), a, 0.5), (a[:, ::2], a[:, ::2], a[:, ::2], 0.5),
                 (a, a.cpu(), a, 0.5), (a, a, a, 1.5), (a, a, a, -0.1),
                 (a, a, a, float("nan"))):
        with pytest.raises(KernelArgumentError):
            sa.sage_act(*args)
    code = torch.zeros((40, 8), dtype=torch.uint8, device=card)
    for args in ((a.double(), code, 0.5), (a, code.bool(), 0.5),
                 (a, code[:20], 0.5), (a, code.t(), 0.5),
                 (a[:, ::2], code[:, ::2], 0.5), (a, code.cpu(), 0.5),
                 (a, code, 2.0)):
        with pytest.raises(KernelArgumentError):
            sa.sage_act_backward(*args)
