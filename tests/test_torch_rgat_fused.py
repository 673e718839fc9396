"""R-GAT through the port's fused step on the CPU:
``make_fused_train_step(HeteroGraphSageSampler, HeteroFeature, RGAT, Adam)``.

- Against the plain reference of ``portbench/reference/`` (its hetero
  sampler and ``rgat.py``, nothing of the port): every batch's ids
  exactly, the losses, the first gradients and the parameters after 3
  Adam steps within fp32 tolerances that the reference's own TF32
  rounding of its matmuls exceeds.
- Bitwise the eager ``make_train_step`` on the same batches.
- Each node type's rows go to its own static input of the graphs, also
  where two types' frontiers have the same shape.
- The step records the ``train.*`` spans, and the sampler's pipeline the
  two hetero counters.
"""

import types

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt
from portbench.reference import hetero_sampler as ref_sampler
from portbench.reference import rgat as ref_rgat
from portbench.reference import sage as ref_sage
from quiver_tpu_torch import telemetry
from quiver_tpu_torch.parallel.train import GraphedStep, make_train_step

COUNTS = {"paper": 300, "author": 200, "institution": 40}
DIMS = {"paper": 12, "author": 8, "institution": 6}
CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")
EMPLOYS = ("institution", "employs", "author")
HIDDEN, HEADS, CLASSES, B, LR = 16, 4, 5, 24, 1e-3
SIZES = [4, 3]
PHASES = ["train.sample", "train.lookup", "train.forward", "train.backward",
          "train.optimizer"]
# Program against reference on the CPU (measured: loss 7.7e-8, gradients
# 4.8e-7 of a leaf's largest, parameters 2.7e-5 after 3 steps, the last
# where Adam scales w_dst's and att_dst's rounding-noise gradients); the
# reference's TF32 rounding reads 1.4e-5, 2.3e-2 and 2.0e-3.
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-6, 1e-5, 2e-4


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    tracer = telemetry.get_tracer()
    was = (telemetry.enabled(), tracer.tracing)
    telemetry.set_enabled(True)
    tracer.set_tracing(False)
    telemetry.reset()
    yield
    tracer.reset()
    tracer.set_tracing(was[1])
    telemetry.set_enabled(was[0])
    telemetry.reset()


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)

    def edges(n_src, n_dst, avg):
        deg = rng.poisson(avg, n_dst)
        dst = np.repeat(np.arange(n_dst), deg)
        return np.stack([rng.integers(0, n_src, len(dst)), dst])

    ei = {CITES: edges(300, 300, 6), WRITES: edges(200, 300, 3),
          EMPLOYS: edges(40, 200, 0.36)}
    feats = {t: rng.standard_normal((n, DIMS[t])).astype(np.float32)
             for t, n in COUNTS.items()}
    labels = torch.from_numpy(rng.integers(0, CLASSES, COUNTS["paper"]))
    return ei, feats, labels


def _objects(graph, sizes=SIZES, dims=DIMS, dropout=0.5, seed=0):
    ei, feats, _ = graph
    topo = qt.HeteroCSRTopo.from_edge_index_dict(ei, COUNTS)
    sampler = qt.HeteroGraphSageSampler(topo, sizes, seed_type="paper",
                                        device="cpu", gather_mode="pwindow",
                                        sample_rng="hash")
    tables = {t: feats[t] if dims[t] == DIMS[t] else np.random.default_rng(
        1).standard_normal((COUNTS[t], dims[t])).astype(np.float32)
        for t in COUNTS}
    feature = qt.HeteroFeature.from_cpu_tensors(
        tables, device_cache_size="1G", device="cpu")
    torch.manual_seed(seed)
    model = qt.RGAT(dims, HIDDEN, CLASSES, len(sizes),
                    sampler.layer_relations(), heads=HEADS, dropout=dropout,
                    device="cpu")
    return sampler, feature, model, torch.optim.Adam(model.parameters(),
                                                     lr=LR)


def _feeds(graph, sampler, n, seed=3):
    _, _, labels = graph
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.choice(COUNTS["paper"], B, replace=False)
        kw = rng.integers(0, 2**32, (sampler.num_blocks(B), 2),
                          dtype=np.uint32)
        out.append((ids, labels[ids], torch.ones(B, dtype=torch.bool), kw))
    return out


def _reference(graph, sampler, w0, feeds, dropout, tf32=False):
    """The plain reference over ``feeds`` from the weights ``w0``, its
    dropout drawn from the step's seed: each batch, loss, the first
    gradients and the parameters after the last step."""
    ei, feats, _ = graph
    csr = {rel: (torch.from_numpy(np.asarray(c.indptr)),
                 torch.from_numpy(np.asarray(c.indices)))
           for rel, c in sampler.topo.relations.items()}
    sizes = [list(h.items()) for h in sampler.hop_sizes]
    params = {n: w.clone() for n, w in w0.items()}
    opt = ref_sage.Adam(params, LR)
    gen = torch.Generator().manual_seed(7)
    out = dict(batches=[], losses=[], grads=None)
    for ids, lab, mask, kw in feeds:
        smp = ref_sampler.sample(csr, list(COUNTS), "paper",
                                 torch.from_numpy(ids), sizes, kw)
        xs = {t: torch.from_numpy(feats[t])[smp.n_id[t].long()]
              for t in COUNTS}
        layers = [[(b.relation, b.hop.nbr_local, b.hop.mask) for b in hop]
                  for hop in reversed(smp.hops)]
        loss, grads = ref_rgat.train_step(params, opt, xs, layers, "paper",
                                          lab, mask, HEADS, gen, dropout,
                                          tf32)
        out["batches"].append(smp)
        out["losses"].append(loss)
        out["grads"] = out["grads"] or grads
    out["params"] = params
    return out


def _gaps(losses, grads, params, ref):
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    grad = max(float((grads[n] - g).abs().max() / g.abs().max())
               for n, g in ref["grads"].items() if g.abs().max() > 0)
    param = max(float((params[n] - p).abs().max())
                for n, p in ref["params"].items())
    return loss, grad, param


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fused_step_matches_the_reference(graph, dropout):
    sampler, feature, model, opt = _objects(graph, dropout=dropout)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = {n for n, _ in ref_rgat.param_shapes(
        DIMS, HIDDEN, HEADS, CLASSES, sampler.layer_relations())}
    assert names == set(w0)
    step = qt.make_fused_train_step(sampler, feature, model, opt, seed=7)
    batches, pipe = [], sampler.pipeline

    def recorded(*a, **k):
        out = pipe(*a, **k)
        batches.append(out[3])
        return out

    sampler.pipeline = recorded
    feeds = _feeds(graph, sampler, 3)
    losses, grads = [], None
    for f in feeds:
        losses.append(float(step(*f)))
        grads = grads or {n: p.grad.clone()
                          for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    ref = _reference(graph, sampler, w0, feeds, dropout)
    for pb, rb in zip(batches, ref["batches"], strict=True):
        for t in COUNTS:
            assert torch.equal(pb.n_id[t], rb.n_id[t]), t
            assert torch.equal(pb.n_id_mask[t], rb.n_mask[t]), t
        for pl, rl in zip(pb.layers, reversed(rb.hops), strict=True):
            for a, b in zip(pl, rl, strict=True):
                assert a.relation == b.relation
                assert torch.equal(a.nbr_local, b.hop.nbr_local)
                assert torch.equal(a.mask, b.hop.mask)
    loss, grad, param = _gaps(losses, grads, params, ref)
    assert loss <= LOSS_RTOL and grad <= GRAD_RTOL and param <= PARAM_ATOL
    # the tolerances are tighter than TF32's rounding of the matmuls
    ctl = _reference(graph, sampler, w0, feeds, dropout, tf32=True)
    loss, grad, param = _gaps(ctl["losses"], ctl["grads"], ctl["params"],
                              ref)
    assert grad > GRAD_RTOL and param > PARAM_ATOL


def test_fused_step_is_bitwise_the_eager_step(graph):
    """Every loss, the first gradients and the parameters after each step
    equal ``make_train_step``'s over the same pipeline and lookup."""
    fs, ff, fm, fo = _objects(graph)
    es, ef, em, eo = _objects(graph)
    fused = qt.make_fused_train_step(fs, ff, fm, fo, seed=7)
    eager = make_train_step(em, eo, seed=7)
    for i, (ids, lab, mask, kw) in enumerate(_feeds(graph, fs, 4)):
        lf = fused(ids, lab, mask, kw)
        n_id, _, _, batch, _ = es.pipeline(es.seed_tensor(ids), kw)
        le = eager(ef.lookup_device(n_id), batch, lab, mask)
        assert torch.equal(lf, le), i
        for (name, p), q in zip(fm.named_parameters(), em.parameters()):
            if i == 0:
                assert torch.equal(p.grad, q.grad), name
            assert torch.equal(p, q), (i, name)
    assert isinstance(fused.train, GraphedStep)
    assert (fused.train.captures, fused.train.eager_calls) == (0, 4)


def test_fused_step_takes_the_batch_key(graph):
    """``key=`` splits as the homogeneous step does and samples the
    words ``words_of_key`` gives, one pair a block; the words the sampler
    draws have the same shape."""
    s1, f1, m1, o1 = _objects(graph)
    s2, f2, m2, o2 = _objects(graph)
    by_key = qt.make_fused_train_step(s1, f1, m1, o1, seed=7)
    by_words = qt.make_fused_train_step(s2, f2, m2, o2, seed=7)
    ids, lab, mask, _ = _feeds(graph, s1, 1)[0]
    key = qt.utils.rng.key(11)
    words = s2.words_of_key(qt.utils.rng.split(key)[0])
    assert words.shape == (s2.num_blocks(B), 2)
    assert np.array_equal(words, s2.words_of_key(qt.utils.rng.split(key)[0],
                                                 s2.num_blocks(B)))
    assert torch.equal(by_key(ids, lab, mask, key=key),
                       by_words(ids, lab, mask, words))
    assert s1.draw_key_words().shape == (s1.num_blocks(B), 2)


def test_whole_table_check(graph):
    _, feats, _ = graph
    sampler, feature, model, opt = _objects(graph)
    n = sum(COUNTS.values())
    assert (feature.cache_count, feature.node_count) == (n, n)
    part = qt.HeteroFeature.from_cpu_tensors(
        feats, device_cache_size=feats["author"][:50].nbytes, device="cpu")
    assert part.cache_count < part.node_count == n
    with pytest.raises(ValueError, match="whole feature table"):
        qt.make_fused_train_step(sampler, part, model, opt)


def test_equal_frontiers_get_their_own_rows(graph):
    """Papers and authors with frontiers of one shape (9 * B rows each at
    these fanouts, both 8 wide): the lookup under ``_rows_into`` of the
    graphs' ``rows_buffer`` writes each type into its own static input,
    in the order the step flattens its tensors, with the rows a plain
    lookup gives."""
    sizes = [{CITES: 2, WRITES: 3}, {CITES: 2, WRITES: 2, EMPLOYS: 2}]
    dims = dict(DIMS, paper=8)
    sampler, feature, model, opt = _objects(graph, sizes, dims)
    ids, _, _, kw = _feeds(graph, sampler, 1)[0]
    n_id, _, _, batch, _ = sampler.pipeline(sampler.seed_tensor(ids), kw)
    assert n_id["paper"].shape == n_id["author"].shape == (9 * B,)
    train = GraphedStep(model, opt)
    assert train.rows_buffer((9 * B, 8), torch.float32) is None
    static = [torch.full((n.shape[0], dims[t]), float("nan"))
              for t, n in n_id.items()]
    train._graphs = types.SimpleNamespace(inputs=static)
    with feature._rows_into(train.rows_buffer):
        rows = feature.lookup_device(n_id)
    want = feature.lookup(batch)
    for i, t in enumerate(COUNTS):
        assert rows[t] is static[i], t
        assert torch.equal(rows[t], want[t]), t
    # no buffer outside the block, and a homogeneous lookup's default
    assert feature.lookup_device(n_id)["paper"] is not static[0]
    assert train.rows_buffer((9 * B, 8), torch.float32) is static[0]
    assert train.rows_buffer((9 * B, 8), torch.float64) is None


def test_step_records_spans_and_counters(graph):
    sampler, feature, model, opt = _objects(graph)
    step = qt.make_fused_train_step(sampler, feature, model, opt)
    telemetry.get_tracer().set_tracing(True)
    feeds = _feeds(graph, sampler, 2)
    for f in feeds:
        step(*f)
    evs = sorted(telemetry.get_tracer().events(), key=lambda e: e["ts_us"])
    roots = [e for e in evs if e["name"] == "train.step"]
    assert len(roots) == 2
    for root in roots:
        kids = [e for e in evs if e["root"] == root["root"]
                and e["name"] != "train.step"]
        assert [e["name"] for e in kids] == PHASES
        assert all(e["parent"] == "train.step" for e in kids)
    hops, lens = sampler.plan(B)
    c = telemetry.snapshot()["counters"]
    blocks = {}
    for blk in (b for hop in hops for b in hop):
        key = "__".join(blk.relation)
        blocks[key] = blocks.get(key, 0) + 2
    assert blocks == {"paper__cites__paper": 4, "author__writes__paper": 4,
                      "institution__employs__author": 2}
    for rel, n in blocks.items():
        assert c[f"hetero_blocks_total{{relation={rel}}}"] == n
    for t, n in lens.items():
        assert c[f"hetero_frontier_rows_total{{node_type={t}}}"] == 2 * n
