"""The fused training step's CUDA graphs, as far as the CPU can hold them.

- On the CPU the fused step's ``GraphedStep`` runs its eager step and
  captures nothing: its losses are bitwise those of ``make_train_step``
  over the same sampler's pipeline and lookup, from the same weights,
  dropout seed and feeds, and each loss it returns is a tensor of its
  own.
- ``gather_rows(out=)`` writes the rows into ``out`` and returns it;
  ``Feature._rows_into`` has this thread's ``lookup_device`` write into
  the buffer it is given, and no other thread's.
- ``GraphedStep.rows_buffer`` hands out the graphs' static rows once
  they exist, and nothing before.

The graphs themselves run on the card only: ``tests/test_torch_cuda.py::
test_graphed_fused_step_is_bitwise_the_eager_step`` holds the replayed
step bitwise against the eager one there.
"""

import threading

import numpy as np
import pytest
import torch

from quiver_tpu import telemetry as jtel

import quiver_tpu_torch as qt
from quiver_tpu_torch import telemetry as ptel
from quiver_tpu_torch.ops.cuda.gather_rows import gather_rows
from quiver_tpu_torch.parallel.train import (GraphedStep, _Graphs,
                                             make_train_step)
from quiver_tpu_torch.resilience import qos as pqos

N, D, HIDDEN, CLASSES, B = 600, 8, 16, 4, 32
SIZES = [4, 3, 2]

_JAX_TELEMETRY_DEFAULT = jtel.enabled()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' registries, tracers, recorders and timelines, and the
    port's QoS controller, start and end empty, with retention off; JAX's
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


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, 6_000, seed=3)
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int64)
    return indptr, indices, feat, labels


def _objects(data, base):
    indptr, indices, feat, _ = data
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    sampler = qt.GraphSageSampler(topo, SIZES, device="cpu",
                                  gather_mode="pallas")
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    model = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=len(SIZES),
                         dropout=0.5, device="cpu")
    model.load_state_dict(base.state_dict())
    return sampler, feature, model, torch.optim.Adam(model.parameters(),
                                                     lr=3e-3)


@pytest.mark.parametrize("traced", [False, True])
def test_fused_step_on_cpu_is_the_eager_step(data, traced):
    """Five fused steps on the CPU against ``make_train_step`` over the
    same sampler's pipeline and lookup: bitwise the same losses and
    parameters, with the spans retained and not; each loss its own
    tensor, unchanged by the later steps.  The fused step's
    ``GraphedStep`` captured nothing and ran all five eagerly."""
    torch.manual_seed(0)
    base = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=len(SIZES),
                        dropout=0.5, device="cpu")
    fs, ff, fm, fo = _objects(data, base)
    es, ef, em, eo = _objects(data, base)
    fused = qt.make_fused_train_step(fs, ff, fm, fo, seed=7)
    eager = make_train_step(em, eo, seed=7)
    ptel.get_tracer().set_tracing(traced)
    rng = np.random.default_rng(11)
    got, want = [], []
    for _ in range(5):
        ids = rng.integers(0, N, B)
        lab = torch.from_numpy(data[3][ids])
        ones = torch.ones(B, dtype=torch.bool)
        kw = rng.integers(0, 2**32, (len(SIZES), 2), dtype=np.uint32)
        got.append(fused(ids, lab, ones, kw))
        n_id, _, _, blocks, _ = es.pipeline(es.seed_tensor(ids), kw,
                                            weighted=False)
        want.append(eager(ef.lookup_device(n_id), blocks, lab, ones))
    assert [x.item() for x in got] == [x.item() for x in want]
    assert len({x.data_ptr() for x in got}) == len(got)
    assert (fused.train.captures, fused.train.eager_calls) == (0, 5)
    for p, q in zip(fm.parameters(), em.parameters()):
        assert torch.equal(p, q)


def test_gather_rows_writes_into_out():
    table = torch.arange(40, dtype=torch.float32).view(10, 4)
    idx = torch.tensor([3, -1, 12, 0], dtype=torch.int64)
    order = torch.tensor([9, 8, 7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.int32)
    out = torch.full((4, 4), -1.0)
    got = gather_rows(table, idx, order, out=out)
    assert got is out
    assert torch.equal(out, gather_rows(table, idx, order))


def test_rows_into_writes_this_threads_lookup_only(data):
    """Inside ``_rows_into`` this thread's lookup returns the buffer the
    allocator gives (with the rows ``lookup_device`` returns outside it);
    another thread's lookup, and a ``None`` from the allocator, get a
    tensor of their own; outside the block nothing is written."""
    _, _, feat, _ = data
    topo = qt.CSRTopo(indptr=data[0], indices=data[1])
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device="cpu").from_cpu_tensor(feat)
    ids = torch.tensor([5, 0, 599, 17], dtype=torch.int64)
    want = feature.lookup_device(ids)
    buf = torch.zeros((4, D))
    asked = []

    def alloc(shape, dtype):
        asked.append((shape, dtype))
        return buf

    other = {}
    with feature._rows_into(alloc):
        got = feature.lookup_device(ids)
        t = threading.Thread(
            target=lambda: other.update(rows=feature.lookup_device(ids)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert got is buf and torch.equal(buf, want)
    assert asked == [((4, D), torch.float32)]
    assert other["rows"] is not buf and torch.equal(other["rows"], want)
    with feature._rows_into(lambda shape, dtype: None):
        assert feature.lookup_device(ids) is not buf
    buf.zero_()
    assert torch.equal(feature.lookup_device(ids), want)
    assert not bool(buf.any())


def test_rows_buffer_is_the_static_rows_once_captured():
    """Before the capture ``rows_buffer`` gives nothing (the lookup makes
    its own rows, which the capture copies); after it, the graphs' static
    rows for their shape and dtype, and nothing for any other."""
    model = qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=len(SIZES),
                         device="cpu")
    step = GraphedStep(model, torch.optim.Adam(model.parameters()), seed=3)
    assert step.rows_buffer((100, D), torch.float32) is None
    rows = torch.empty((100, D))
    step._graphs = _Graphs(None, [rows], None, None, None, [], None)
    assert step.rows_buffer((100, D), torch.float32) is rows
    assert step.rows_buffer((50, D), torch.float32) is None
    assert step.rows_buffer((100, D), torch.bfloat16) is None
    assert (step.captures, step.eager_calls) == (0, 0)
