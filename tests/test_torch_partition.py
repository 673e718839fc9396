"""Port parity: offline feature partitioning (``quiver_tpu_torch/
partition.py``).

For the same probabilities (numpy, or the port's ``sample_prob`` tensors)
every partition, cache order, unaccessed set and partition book equals
the JAX package's, and the files written under ``result_path`` hold the
same arrays under the same names.
"""

import os

import numpy as np
import pytest
import torch

from quiver_tpu import partition as jp

import quiver_tpu_torch as qt
from quiver_tpu_torch import partition as pp

N = 500


@pytest.fixture(scope="module", autouse=True)
def _jax_registry_left_empty():
    """The JAX code this file runs sets gauges and counters in the JAX
    package's registry: empty it when the file ends and set JAX's
    telemetry switch back, so nothing reaches a later file on this
    worker."""
    from quiver_tpu import telemetry as jax_telemetry

    on = jax_telemetry.enabled()
    yield
    jax_telemetry.reset()
    jax_telemetry.set_enabled(on)


def _probs(seed, n_parts):
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n_parts):
        v = np.zeros(N)
        lo = p * N // (n_parts + 1)
        v[lo: lo + N // 2] = rng.uniform(0.1, 1.0, min(N // 2, N - lo))
        out.append(v)
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_parts,chunks", [(2, 32), (3, 7), (4, 1)])
def test_partition_arrays_match_jax(n_parts, chunks):
    probs = _probs(n_parts, n_parts)
    _same(pp.partition_without_replication(probs, chunk_num=chunks),
          jp.partition_without_replication(probs, chunk_num=chunks))
    ids = np.arange(0, N, 3)
    _same(pp.partition_without_replication(probs, ids, chunks),
          jp.partition_without_replication(probs, ids, chunks))
    _same(pp.select_nodes(probs), jp.select_nodes(probs))
    _same(pp.select_nodes(probs, ids), jp.select_nodes(probs, ids))
    got = pp.partition_feature_without_replication(probs, chunks)
    want = jp.partition_feature_without_replication(probs, chunks)
    _same(got[0], want[0])
    _same(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # tensors (what the port's sample_prob returns) give the same answer
    _same(pp.partition_without_replication(
        [torch.from_numpy(p).float() for p in probs], chunk_num=chunks),
        jp.partition_without_replication(
            [p.astype(np.float32) for p in probs], chunk_num=chunks))


def test_partition_files_match_jax(tmp_path):
    probs = _probs(9, 3)
    feat = np.random.default_rng(1).standard_normal((N, 6)).astype(
        np.float32)
    want = jp.quiver_partition_feature(feat, probs, str(tmp_path / "jax"))
    got = qt.quiver_partition_feature(feat, probs, str(tmp_path / "port"))
    _same(got[0], want[0])
    _same(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 1 + 3 * 3
    for rel in files:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / rel),
                                      np.load(tmp_path / "jax" / rel))
    for p in range(3):
        _same(qt.load_quiver_feature_partition(p, str(tmp_path / "port")),
              jp.load_quiver_feature_partition(p, str(tmp_path / "jax")))


def test_probs_from_the_ports_sampler():
    """``sample_prob`` of two train halves partitions like JAX's numpy
    call on the same vectors."""
    indptr, indices = qt.synthetic_csr(N, 5_000, seed=3)
    s = qt.GraphSageSampler(qt.CSRTopo(indptr=indptr, indices=indices),
                            [4, 2], device="cpu")
    halves = np.array_split(np.random.default_rng(2).permutation(N), 2)
    probs = [s.sample_prob(h, N) for h in halves]
    _same(qt.partition_without_replication(probs),
          jp.partition_without_replication([p.numpy() for p in probs]))
