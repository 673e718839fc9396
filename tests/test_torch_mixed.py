"""Port parity: the mixed device + CPU sampler (``quiver_tpu_torch/
mixed.py``).

Every task of the job is yielded exactly once per epoch in each mode,
with its seeds in the batch's first slots; the feedback rule
``_decide_cpu_share`` returns JAX's share for the same injected mean task
times; ``RangeSampleJob`` shuffles as JAX's does.
"""

import warnings

import numpy as np
import pytest

from quiver_tpu import telemetry
from quiver_tpu.mixed import MixedGraphSageSampler as JaxMixed
from quiver_tpu.mixed import RangeSampleJob as JaxJob
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.mixed import RangeSampleJob

N, SIZES, BATCH = 800, [4, 3], 64


@pytest.fixture(autouse=True)
def _jax_registry_emptied():
    """The JAX calls here record metrics in the JAX package's registry when
    its telemetry is on; each test empties the registry after it, so no
    metric recorded here (or left by an earlier file) reaches a later file
    on the same worker (ROADMAP "Open items")."""
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def graph():
    indptr, indices = qt.synthetic_csr(N, 9_000, seed=12)
    return indptr, indices


def _epoch(mixed, job):
    """Seeds of every yielded batch, by task, and the sources seen."""
    seen, sources = [], set()
    for batch, src in mixed:
        seen.append(tuple(batch.n_id[: batch.batch_size].tolist()))
        sources.add(src)
        assert batch.n_id.device.type == "cpu"
    tasks = [tuple(job[i].tolist()) for i in range(len(job))]
    assert sorted(seen) == sorted(tasks)
    return sources


@pytest.mark.parametrize("mode,workers,want", [
    ("TPU_CPU_MIXED", 2, {"tpu", "cpu"}),
    ("GPU_CPU_MIXED", 3, {"tpu", "cpu"}),
    ("TPU_ONLY", 2, {"tpu"}),
    ("CPU_ONLY", 2, {"cpu"}),
])
def test_every_task_once_per_epoch(graph, mode, workers, want):
    indptr, indices = graph
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    job = RangeSampleJob(np.arange(N - 30), BATCH, seed=1)
    mixed = qt.MixedGraphSageSampler(topo, SIZES, job, device="cpu",
                                     mode=mode, num_workers=workers)
    for _ in range(2):
        assert _epoch(mixed, job) == want
    if "MIXED" in mode:
        assert mixed.avg_tpu_time > 0 and mixed.avg_cpu_time > 0


def test_no_workers(graph):
    indptr, indices = graph
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    job = RangeSampleJob(np.arange(200), BATCH)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mixed = qt.MixedGraphSageSampler(topo, SIZES, job, device="cpu",
                                         num_workers=0)
    assert mixed.mode == "TPU_ONLY" and "num_workers=0" in str(w[0].message)
    assert _epoch(mixed, job) == {"tpu"}
    with pytest.raises(ValueError, match="num_workers"):
        qt.MixedGraphSageSampler(topo, SIZES, job, device="cpu",
                                 mode="CPU_ONLY", num_workers=0)
    with pytest.raises(ValueError, match="mode"):
        qt.MixedGraphSageSampler(topo, SIZES, job, device="cpu",
                                 mode="GPU_ALONE")


@pytest.mark.parametrize("mode", ["TPU_CPU_MIXED", "TPU_ONLY", "CPU_ONLY"])
def test_decide_cpu_share_matches_jax(graph, mode):
    indptr, indices = graph
    jt = JaxTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    for workers in (1, 4):
        jm = JaxMixed(jt, SIZES, JaxJob(np.arange(10), 5), mode=mode,
                      num_workers=workers)
        pm = qt.MixedGraphSageSampler(pt, SIZES, RangeSampleJob(
            np.arange(10), 5), device="cpu", mode=mode, num_workers=workers)
        assert pm.mode == jm.mode
        for times in ((None, None), (0.01, None), (0.01, 0.05),
                      (0.2, 0.01), (1e-12, 3.0), (0.004, 0.004)):
            jm.avg_tpu_time, jm.avg_cpu_time = times
            pm.avg_tpu_time, pm.avg_cpu_time = times
            for n in (0, 1, 2, 3, 9, 40, 1000):
                assert pm._decide_cpu_share(n) == jm._decide_cpu_share(n), (
                    workers, times, n)


def test_range_job_shuffles_as_jax():
    jj, pj = JaxJob(np.arange(1000), 96, seed=5), RangeSampleJob(
        np.arange(1000), 96, seed=5)
    assert len(pj) == len(jj) == 11
    for _ in range(3):
        jj.shuffle()
        pj.shuffle()
        for i in range(len(pj)):
            np.testing.assert_array_equal(pj[i], jj[i])
