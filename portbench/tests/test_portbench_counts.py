"""The yardstick's counts against shapes worked by hand, and the trace's
reduction on events made by hand."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import counts, readers, trace
from portbench.reference.sampler import Hop


def _hop(t, k, live, mask):
    mask = torch.tensor(mask, dtype=torch.bool).view(t, k)
    return Hop(t=t, k=k, live=torch.tensor(live, dtype=torch.bool), mask=mask,
               nbr_local=torch.zeros((t, k), dtype=torch.int32),
               eid=torch.where(mask, torch.arange(t * k).view(t, k), -1))


def test_sage_flops_by_hand():
    one = dict(live=2, edges=5, d_in=3, d_out=4)
    # two products of 2 x 3 x 4 at 2 FLOPs a multiply-add, 5 x 3 adds
    assert counts.sage_flops([one], backward=False) == 96 + 15
    # the first layer's backward: its weight gradients only
    assert counts.sage_flops([one], backward=True) == 2 * 96 + 15
    two = dict(live=1, edges=2, d_in=4, d_out=2)
    # the second layer (products of 1 x 4 x 2: 32 FLOPs, mean 8): forward,
    # weight and input gradients, and the mean's scatter
    assert counts.sage_flops([one, two], backward=True) == (
        2 * 96 + 15 + 3 * 32 + 2 * 8)


def test_layer_shapes():
    # 2 seeds; hop 1 at fanout 2 (seed 1's second slot empty), hop 2 at
    # fanout 1 over the 6 entries of the frontier
    h1 = _hop(2, 2, [1, 1], [1, 1, 1, 0])
    h2 = _hop(6, 1, [1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 1, 0])
    dims = [8, 4, 3]
    got = counts.layer_shapes([h1, h2], dims)
    assert got == [dict(live=5, edges=4, d_in=8, d_out=4),
                   dict(live=2, edges=3, d_in=4, d_out=3)]


def test_bytes_by_hand():
    # positions 0, 1, 7 share sector 0; 8 is sector 1
    assert counts.sector_bytes(torch.tensor([0, 1, 7, 8])) == 64
    # 2 live targets, 2 valid draws: 2 x 9 + indptr sectors {0} +
    # indices sectors {0, 2} + 2 x 9
    live = torch.tensor([0, 6])
    assert counts.b1_hop_bytes(live, torch.tensor([1, 17])) == (
        18 + 32 + 64 + 18)
    ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    # ids 3 x 4, order 2 x 4, 2 distinct rows read, 3 rows written
    assert counts.b2_bytes(ids, 8, ordered=True) == 12 + 8 + 16 + 24
    assert counts.b2_bytes(ids, 8, ordered=False) == 12 + 16 + 24


def test_padding_stays_out_of_the_bytes():
    # hop 1: targets 0 and 1 (both live) at fanout 2, target 1's second
    # slot masked; hop 2 at fanout 1 over the 6 entries, entry 5 dead
    # (the masked slot) and entry 3's slot masked
    h1 = _hop(2, 2, [1, 1], [1, 1, 1, 0])
    h2 = _hop(6, 1, [1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 1, 0])
    n_id = torch.tensor([3, 9, 40, 41, 42, 0, 7, 7, 8, 0, 9, 0])
    n_mask = torch.tensor([1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 0],
                          dtype=torch.bool)
    # hop 1: 2 live x 9, indptr of nodes 3 and 9 (positions 3, 4, 9, 10:
    # sectors 0, 1), eids 0, 1, 2 (sector 0), 3 valid slots x 9
    assert counts.b1_hop_bytes(n_id[:2][h1.live], h1.eid[h1.mask]) == (
        18 + 64 + 32 + 27)
    # hop 2: 5 live of 6 (node 0's entry dead), 4 valid slots of 6
    hop2 = counts.b1_hop_bytes(n_id[:6][h2.live], h2.eid[h2.mask])
    assert hop2 == 5 * 9 + counts.sector_bytes(
        torch.tensor([3, 9, 40, 41, 42]), torch.tensor([4, 10, 41, 42, 43])
    ) + 32 + 4 * 9
    assert counts.b1_step_bytes([h1, h2], n_id) == 18 + 64 + 32 + 27 + hop2
    # B2: the 9 live ids of 12 (7 distinct), 3 masked entries left out
    live = n_id[n_mask].to(torch.int32)
    assert counts.b2_bytes(live, 8, ordered=True) == (
        9 * 4 + 7 * 4 + 7 * 8 + 9 * 8)


def _run(layer, traced):
    return SimpleNamespace(layer=layer, traced=traced)


def test_readers():
    pk = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    traced = dict(ops={"void window_sample_kernel<false>(int)": 2e-3,
                       "b2_chunks": 1e-3}, busy_s=3e-3, window_s=4e-3,
                  gaps={})
    layer = dict(device_name="NVIDIA H100 80GB HBM3", b1_bytes=1e9,
                 b2_bytes=2e9, flops_per_step=67e9, steps=10, window_s=1.0,
                 host_dispatch_s=2e-3)
    r = _run(layer, traced)
    assert readers.roofline(r, "window_sample_kernel", "b1_bytes") == \
        pytest.approx(100 * 1e9 / pk["hbm_bytes"] / 2e-3)
    assert readers.mfu(r, "flops_per_step", "steps") == pytest.approx(1.0)
    assert readers.idle_share(r) == pytest.approx(25.0)
    assert readers.layer_ms(r, "host_dispatch_s") == pytest.approx(2.0)
    # nothing to read: nothing returned, never 0
    cpu = _run(dict(layer, device_name="cpu"), traced)
    assert readers.roofline(cpu, "b2_", "b2_bytes") is None
    assert readers.mfu(cpu, "flops_per_step", "steps") is None
    assert readers.roofline(_run(layer, None), "b2_", "b2_bytes") is None


def _ev(name, a, b, dev=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if dev else
                           DeviceType.CPU, is_user_annotation=False)


def test_trace_reduce():
    events = [
        _ev("spin_kernel", 0, 100, dev=True),      # the prime
        _ev("spin_kernel", 200, 201, dev=True),    # the window opens at 201
        _ev("portbench.step", 190, 700),
        _ev("aten::mm", 300, 350),
        _ev("b2_chunks", 210, 300, dev=True),
        _ev("gemm", 280, 320, dev=True),           # overlaps: busy 210-320
        _ev("gemm", 400, 500, dev=True),
        _ev("spin_kernel", 600, 601, dev=True),    # the window closes at 600
    ]
    got = trace.reduce(events)
    assert got["window_s"] == pytest.approx(399e-6)
    assert got["busy_s"] == pytest.approx(210e-6)
    assert got["ops"]["gemm"] == pytest.approx(140e-6)
    # gaps 201-210 and 500-600 start under the step span alone, 320-400
    # starts while the host runs aten::mm
    assert got["gaps"]["step"] == pytest.approx(109e-6)
    assert got["gaps"]["step / aten::mm"] == pytest.approx(80e-6)
    bd = trace.breakdown(got)
    assert bd["device_ops"][0][0] == "gemm"
    assert bd["idle_gaps"][0] == ["step", pytest.approx(109e-6)]
