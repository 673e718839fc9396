"""The hetero cell: its plain reference and yardstick against examples
worked by hand, and the whole cell at a tiny size through the port's CPU
path (sound runs correct; the control and planted faults not)."""

import copy
import math
import time

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt
from portbench import (build_hetero, check_hetero, core, counts, counts_hetero,
                       phases_hetero, run as prun)
from portbench.reference import hetero_sampler, rgat, sampler

NAME = "mag240m-rgat.train"
A_R_B = ("b", "r", "a")   # b sampled for a
B_S_A = ("a", "s", "b")   # a sampled for b


def _csr(indptr, indices):
    return (torch.tensor(indptr, dtype=torch.int64),
            torch.tensor(indices, dtype=torch.int32))


def test_sampler_snapshot_rule_by_hand():
    # a0 <- b2 (one in-neighbour); b0 <- a1, a0; b2 <- a1
    csr = {A_R_B: _csr([0, 1, 1], [2]), B_S_A: _csr([0, 2, 2, 3], [1, 0, 1])}
    kw = np.array([[1, 2], [3, 4], [5, 6]], dtype=np.uint32)
    got = hetero_sampler.sample(csr, ["a", "b"], "a", torch.tensor([0]),
                                [[(A_R_B, 2), (B_S_A, 2)]] * 2, kw)
    # hop 1: b's frontier is empty at the hop's start, so s is skipped and
    # takes no key words; r appends b2 and a masked slot to b's frontier
    assert [[b.relation for b in hop] for hop in got.hops] == [
        [A_R_B], [A_R_B, B_S_A]]
    (r1,), (r2, s2) = got.hops
    assert r1.hop.nbr_local.tolist() == [[0, 0]]
    assert r1.hop.mask.tolist() == [[True, False]]
    # hop 2 over the snapshot (a: 1, b: 2): r again from base 2 of b's
    # frontier, then s for b2 and the dead entry into a's, from base 1
    assert r2.hop.nbr_local.tolist() == [[2, 0]]
    assert (s2.hop.t, s2.hop.live.tolist()) == (2, [True, False])
    assert s2.hop.nbr_local.tolist() == [[1, 0], [0, 0]]
    assert s2.hop.mask.tolist() == [[True, False], [False, False]]
    assert got.n_id["a"].tolist() == [0, 1, 0, 0, 0]
    assert got.n_mask["a"].tolist() == [True, True, False, False, False]
    assert got.n_id["b"].tolist() == [2, 0, 2, 0]
    assert got.n_mask["b"].tolist() == [True, False, True, False]
    # each sampled block is sampler.hop under its own pair, in block order
    for (blk, front), (k0, k1) in zip(
            ((r1, got.n_id["a"][:1]), (r2, got.n_id["a"][:1]),
             (s2, got.n_id["b"][:2])), kw):
        mask, _, eid = sampler.hop(*csr[blk.relation], front, blk.hop.live,
                                   2, int(k0), int(k1))
        assert torch.equal(mask, blk.hop.mask)
        assert torch.equal(eid, blk.hop.eid)


def _one_block():
    """One hop of ``A_R_B`` at fanout 2 for seed a0, whose one neighbour is
    b2: slot 0 valid, slot 1 masked."""
    csr = {A_R_B: _csr([0, 1, 1], [2])}
    return hetero_sampler.sample(csr, ["a", "b"], "a", torch.tensor([0]),
                                 [[(A_R_B, 2)]], np.array([[7, 9]]))


def test_rgat_flops_by_hand():
    smp = _one_block()
    dims, hidden, classes = {"a": 3, "b": 5}, 4, 2
    # live: projections of a0 (2*3*4) and b2 (2*5*4); w_src over b's one
    # live row, w_dst over the live target and a's self transform
    # (2*16 each); scores and the weighted sum (2*4 a slot twice, 2*4 the
    # target's term); the classifier (2*4*2)
    fwd = 24 + 40 + 32 + 32 + 2 * 4 * 3 + 32 + 16
    # backward: the projections once, every other product twice, the
    # attention's products 1.5 times
    bwd = 24 + 40 + 2 * 32 + 2 * 32 + 36 + 2 * 32 + 2 * 16
    assert counts_hetero.rgat_flops(smp, dims, hidden, classes, False) == fwd
    assert counts_hetero.rgat_flops(smp, dims, hidden, classes, True) == \
        fwd + bwd
    # the dense work: b's masked row and the masked slot counted too
    whole_fwd = 24 + 80 + 64 + 32 + 2 * 4 * 5 + 32 + 16
    whole_bwd = 24 + 80 + 2 * 64 + 2 * 32 + 60 + 2 * 32 + 2 * 16
    assert counts_hetero.rgat_flops(smp, dims, hidden, classes, True,
                                    live=False) == whole_fwd + whole_bwd


def test_bytes_by_hand():
    smp = _one_block()
    (blk,), = smp.hops
    # B1: the block's live target a0 and its one valid draw
    assert counts_hetero.b1_bytes(smp) == counts.b1_hop_bytes(
        torch.tensor([0]), blk.hop.eid[blk.hop.mask])
    # B2: a0 and b2 (b's masked entry left out), 8-byte rows: each an id
    # read, a row read and a row written
    assert counts_hetero.b2_bytes(smp, 8) == 2 * (4 + 8 + 8)


def test_reference_forward_by_hand():
    """One layer, one head, widths 1: a0 attends over b's two rows."""
    one = torch.tensor([[1.0]])
    params = {"mods.proj_a.weight": one, "mods.proj_a.bias": torch.zeros(1),
              "mods.proj_b.weight": one, "mods.proj_b.bias": torch.zeros(1),
              "mods.self_0_a.weight": torch.tensor([[3.0]]),
              "mods.self_0_a.bias": torch.tensor([1.0]),
              "mods.rel_0_b__r__a.w_src.weight": one,
              "mods.rel_0_b__r__a.w_dst.weight": one,
              "mods.rel_0_b__r__a.att_src": one,
              "mods.rel_0_b__r__a.att_dst": torch.zeros(1, 1),
              "mods.classifier.weight": one,
              "mods.classifier.bias": torch.zeros(1)}
    xs = {"a": torch.tensor([[1.0]]), "b": torch.tensor([[2.0], [4.0]])}
    nbr = torch.tensor([[0, 1]], dtype=torch.int32)
    for mask, agg in (([[True, True]],
                       (2 + 4 * math.e ** 2) / (1 + math.e ** 2)),
                      ([[True, False]], 2.0), ([[False, False]], 0.0)):
        layers = [[(A_R_B, nbr, torch.tensor(mask))]]
        got = rgat.forward(params, xs, layers, "a", 1, heads=1)
        # the self transform 3 * 1 + 1, plus the attention, through ReLU
        assert got.tolist() == [[pytest.approx(4.0 + agg, rel=1e-6)]]


def test_param_names_are_the_programs():
    topo = qt.HeteroCSRTopo({A_R_B: qt.CSRTopo(indptr=np.array([0, 1, 1]),
                                               indices=np.array([2]))},
                            {"a": 2, "b": 3})
    s = qt.HeteroGraphSageSampler(topo, [2, 2], seed_type="a", device="cpu")
    model = qt.RGAT({"a": 3, "b": 5}, 8, 2, 2, s.layer_relations(),
                    device="cpu")
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert dict(rgat.param_shapes({"a": 3, "b": 5}, 8, 4, 2,
                                  s.layer_relations())) == want


def cell() -> core.Cell:
    """The hetero cell at a size the CPU runs in seconds."""
    cfg = copy.deepcopy(core.load_json(core.HERE / "configs"
                                       / "mag240m-rgat.json"))
    cfg.update(paper_nodes=400, author_nodes=300, institution_nodes=50,
               cites_edges=2400, writes_edges=900, employs_edges=100,
               feature_dim=12, train_nodes=200)
    cfg["model"]["hidden"] = 16
    cfg["sampling"].update(batch=16, fanouts=[4, 3])
    mix = dict(core.load_json(core.HERE / "traffic" / "train-hetero.json"))
    mix.update(warmup_steps=1, trace_steps=2)
    return core.Cell(name=NAME, cfg=cfg, mix=mix,
                     limits=core.load_json(core.HERE / "limits"
                                           / f"{NAME}.json"),
                     chips=1, end_to_end=[], per_layer=[])


def tiny_run(seed=5):
    return prun.run_cell(cell(), seed, 0.3, False, "cpu", time.perf_counter())


def test_the_cell_is_in_the_benchmark():
    bench = core.benchmark(core.HERE.parent)
    c = core.find_cell(core.HERE.parent, NAME)
    assert c.mix["kind"] == "train_hetero" and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"setup_s",
                                                 "train_seeds_per_s"}
    names = {m["name"] for m in c.per_layer}
    assert len(names) == 9 and all(n.endswith(".train-hetero")
                                   for n in names)
    for n in names:
        assert prun.reader(n) is not None
    conf = {x["name"]: x for x in bench["configs"]}["mag240m-rgat"]
    for key in conf["reduced"]:
        assert c.cfg[key] < c.cfg["published"][key]


def test_inputs_hold_the_configured_counts():
    c = cell()
    inp = build_hetero.make_inputs(c.cfg, 3, torch.device("cpu"))
    for rel, (ip, ix) in inp.csr.items():
        assert int(ip[-1]) == ix.numel() == c.cfg[f"{rel[1]}_edges"]
        assert ip.numel() == c.cfg[f"{rel[2]}_nodes"] + 1
        assert int(ix.max()) < c.cfg[f"{rel[0]}_nodes"]
    deg = torch.diff(inp.csr[("paper", "cites", "paper")][0])
    assert int(deg.min()) >= 1   # average 6: floored at 1
    deg = torch.diff(inp.csr[("institution", "employs", "author")][0])
    assert int(deg.min()) == 0   # average 1/3: no floor
    assert inp.train_ids.numel() == c.cfg["train_nodes"]
    again = build_hetero.make_inputs(c.cfg, 3, torch.device("cpu"))
    for t in c.cfg["node_types"]:
        x = inp.table(t)
        assert x.shape == (c.cfg[f"{t}_nodes"], c.cfg["feature_dim"])
        assert torch.equal(x, inp.table(t))
        assert torch.equal(x, again.table(t))


def test_cell_is_correct():
    r = tiny_run()
    assert r.correct, r.checks
    assert set(r.checks) == set(r.cell.limits)
    assert r.attempted > 0 and r.failed == 0
    assert r.e2e["setup_s"] > 0 and r.e2e["train_seeds_per_s"] > 0


@pytest.mark.parametrize("what", ["control", "half"])
def test_control_and_fault_are_not_correct(what):
    r = tiny_run()
    k = r.keep
    kw = dict(tf32=True) if what == "control" else dict(fault="half")
    other = check_hetero.reference_train(k["inp"], r.cell.cfg,
                                         k["rec"]["feeds"],
                                         k["dropout_seed"], r.device, **kw)
    got = check_hetero.train_readings(other, k["ref"], exact=False)
    assert any(got[n] > lim for n, lim in r.cell.limits.items() if n in got)


def _altered_rows(orig):
    def lookup_device(self, n_id):
        rows = {t: x.clone() for t, x in orig(self, n_id).items()}
        rows["author"][1] += 1.0
        return rows
    return lookup_device


@pytest.mark.parametrize("fault", ["state unchanged", "a row altered"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    if fault == "state unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        monkeypatch.setattr(qt.HeteroFeature, "lookup_device",
                            _altered_rows(qt.HeteroFeature.lookup_device))
    assert not tiny_run().correct


def test_phases_of_a_tiny_cell():
    r = tiny_run()
    got = phases_hetero.of(r)
    assert "device" not in got  # no card here
    h = got["host"]
    assert h["steps"] == r.cell.mix["trace_steps"]
    assert set(h["self_s"]) == {"train.step", "train.sample", "train.lookup",
                                "train.forward", "train.backward",
                                "train.optimizer"}
    for p in ("sample", "lookup", "forward", "backward", "optimizer"):
        assert prun.reader(f"{p}_device_ms.train-hetero")(r) is None
    assert phases_hetero.of(r) is got
