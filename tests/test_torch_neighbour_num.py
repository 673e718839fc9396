"""Port parity: ``generate_neighbour_num`` (``quiver_tpu_torch/
neighbour_num.py``).

``mode="sampled"`` runs the native host sampler and is bitwise equal to
the JAX package's.  ``mode="expected"`` runs the reverse degree recurrence
in float32 and truncates it to int64; the port sums with ``index_add_``,
JAX with ``segment_sum``, in orders that may differ in the last bit.  The
rule held here: every node's count equals JAX's, except that a node may
differ by 1 where JAX's float lies within ``1e-5`` relative of an integer
(truncation there turns on the last bit).  The floats themselves agree
within ``rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

from quiver_tpu.neighbour_num import (_get_expected_counts_jit,
                                      generate_neighbour_num as jax_nn)
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.neighbour_num import expected_counts

N = 900


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


@pytest.fixture(scope="module")
def topos():
    indptr, indices = qt.synthetic_csr(N, 11_000, seed=14)
    return (JaxTopo(indptr=indptr, indices=indices),
            qt.CSRTopo(indptr=indptr, indices=indices))


def assert_counts_match(got, want, want_float):
    """The stated rule: equal, or off by 1 where JAX's float is within
    1e-5 relative of an integer."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    near = (np.abs(want_float - np.round(want_float))
            <= 1e-5 * np.maximum(np.abs(want_float), 1.0))
    bad = (diff > 1) | ((diff == 1) & ~near)
    assert not bad.any(), np.nonzero(bad)[0][:10]


@pytest.mark.parametrize("sizes", [[5, 3], [10, 5, 2]])
def test_sampled_matches_jax(topos, sizes):
    jt, pt = topos
    want = jax_nn(jt, sizes, mode="sampled", seed=3)
    got = qt.generate_neighbour_num(pt, sizes, mode="sampled", seed=3)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", [[5, 3], [10, 5, 2], [25, 10]])
def test_expected_matches_jax(topos, sizes, tmp_path):
    jt, pt = topos
    path = tmp_path / "nn.npy"
    want = jax_nn(jt, sizes, mode="expected")
    got = qt.generate_neighbour_num(pt, sizes, device="cpu", path=str(path))
    assert got.dtype == np.int64 and got.shape == (N,)
    np.testing.assert_array_equal(np.load(path), got)
    ip, ix = jt.to_device()
    g_jax = np.asarray(_get_expected_counts_jit()(
        ip[: N + 1], ix[: jt.edge_count], n=N, sizes=tuple(sizes)))
    ip_t, ix_t = pt.to_device("cpu")
    g_port = expected_counts(ip_t[: N + 1], ix_t[: pt.edge_count], N,
                             sizes).numpy()
    np.testing.assert_allclose(g_port, g_jax, rtol=1e-5, atol=0)
    assert_counts_match(got, want, g_jax)
    np.testing.assert_array_equal(want, g_jax.astype(np.int64))


def test_rule_allows_only_rounding_neighbours():
    """The rule's own edges: 1 off at an integer passes, 1 off elsewhere or
    2 off fails."""
    f = np.array([3.0, 7.4, 5.0000001, 9.0])
    want = f.astype(np.int64)
    assert_counts_match(np.array([2, 7, 4, 9]), want, f)
    for got in (np.array([3, 8, 5, 9]), np.array([3, 7, 5, 11])):
        with pytest.raises(AssertionError):
            assert_counts_match(got, want, f)


def test_expected_on_a_path_graph():
    """A path 0 - 1 - 2 - 3 with fanouts [2, 2]: hop 1 takes min(2, deg)
    neighbours, hop 2 each of those a mean of min(2, deg) more."""
    indptr = np.array([0, 1, 3, 5, 6])
    indices = np.array([1, 0, 2, 1, 3, 2])
    topo = qt.CSRTopo(indptr=indptr, indices=indices)
    got = qt.generate_neighbour_num(topo, [2, 2], device="cpu")
    # node 0: 1 neighbour (deg 2) -> 1 * (1 + 2) = 3
    # node 1: 2 neighbours (deg 1, 2) -> 2 * (1 + 1.5) = 5
    np.testing.assert_array_equal(got, [3, 5, 5, 3])
    with pytest.raises(ValueError, match="mode"):
        qt.generate_neighbour_num(topo, [2], mode="other", device="cpu")
    assert torch.is_tensor(expected_counts(
        *(t[:s] for t, s in zip(topo.to_device("cpu"), (5, 6))), 4, [2]))
