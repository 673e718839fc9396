"""Port parity, kernel B2's entry: ``gather_rows(table, idx, order)``
clamps the ids, maps them through the feature order and copies the rows
in one call, which is what ``Feature.lookup_device`` runs.  On the CPU the
entry is its plain version; here it is held against JAX's
``Feature.lookup_device`` on the same numpy inputs, bitwise, with int32
and int64 ids and ids outside ``[0, N)``.  The route rule is checked at
the main path's shapes.  The kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops.cuda import gather_rows as b2

N, D = 1500, 24


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
def csr():
    return qt.synthetic_csr(N, 18_000, seed=3)


@pytest.fixture(scope="module")
def feat():
    return np.random.default_rng(4).standard_normal((N, D)).astype(
        np.float32)


def _features(csr, feat, ordered, dtype):
    """JAX's and the port's whole-table features over the same table, in
    degree order when ``ordered``."""
    indptr, indices = csr
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jf = JaxFeature(device_cache_size=N, cache_unit="rows", dtype=jdt,
                    csr_topo=JaxTopo(indptr=indptr, indices=indices)
                    if ordered else None).from_cpu_tensor(feat)
    pf = qt.Feature(device_cache_size=N, cache_unit="rows", dtype=dtype,
                    csr_topo=qt.CSRTopo(indptr=indptr, indices=indices)
                    if ordered else None, device="cpu").from_cpu_tensor(feat)
    assert (pf._order_dev is None) == (not ordered)
    return jf, pf


def _ids(seed, m=700):
    """Ids with the ends of the table and ids outside it on both sides."""
    ids = np.random.default_rng(seed).integers(-40, N + 40, m)
    ids[:6] = [0, N - 1, -1, N, -(2**31), 2**31 - 1]
    return ids


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_ordered_entry_matches_jax_lookup_device(csr, feat, dtype, id_dtype):
    """With a feature order, JAX clips the ids and maps them
    (``take(order, idx, mode="clip")``); the entry's plain version and
    the port's ``lookup_device`` give the same rows bit for bit."""
    jf, pf = _features(csr, feat, True, dtype)
    ids = _ids(1)
    want = _f32(jf.lookup_device(jnp.asarray(ids, jnp.int32)))
    t = torch.from_numpy(ids).to(id_dtype)
    before = b2.gather_rows.launches
    np.testing.assert_array_equal(
        _f32(b2.gather_rows(pf.hot, t, pf._order_dev)), want)
    np.testing.assert_array_equal(_f32(pf.lookup_device(t)), want)
    np.testing.assert_array_equal(
        _f32(b2.gather_rows_plain(pf.hot, t, pf._order_dev)), want)
    assert b2.gather_rows.launches == before  # the CPU launches nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_unordered_entry_matches_jax_lookup_device(csr, feat, dtype,
                                                   id_dtype):
    """Without an order the port clips where JAX's ``jnp.take`` fills
    out-of-range rows (ROADMAP §C): in-range ids give JAX's rows, and
    out-of-range ids give JAX's rows of the clipped ids."""
    jf, pf = _features(csr, feat, False, dtype)
    ids = _ids(2)
    t = torch.from_numpy(ids).to(id_dtype)
    got = _f32(pf.lookup_device(t))
    np.testing.assert_array_equal(got, _f32(b2.gather_rows(pf.hot, t)))
    np.testing.assert_array_equal(got, _f32(jf.lookup_device(jnp.asarray(
        np.clip(ids, 0, N - 1), jnp.int32))))
    inside = (ids >= 0) & (ids < N)
    np.testing.assert_array_equal(got[inside], _f32(jf.lookup_device(
        jnp.asarray(ids[inside], jnp.int32))))


@pytest.mark.parametrize("ordered", [True, False])
def test_lookup_device_equals_the_separate_takes(csr, feat, ordered):
    """One call of the entry gives what the clamp, the order take and the
    row gather gave as three steps."""
    _, pf = _features(csr, feat, ordered, torch.float32)
    t = torch.from_numpy(_ids(3))
    pos = t.clamp(0, N - 1)
    if ordered:
        pos = pf._order_dev[pos]
    assert torch.equal(pf.lookup_device(t), pf.hot.index_select(0, pos))


@pytest.mark.parametrize("case", ["empty", "one_row", "all_equal",
                                  "all_below", "all_above", "one_id"])
@pytest.mark.parametrize("with_order", [True, False])
def test_plain_entry_edge_cases(case, with_order):
    """``M = 0``, ``N = 1``, every id equal, every id below or above the
    table, a single id: the entry equals ``index_select`` of the clamped,
    mapped ids, for int32 and int64 ids alike."""
    rng = np.random.default_rng(7)
    n = 1 if case == "one_row" else 40
    table = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    order = (torch.from_numpy(rng.permutation(n).astype(np.int32))
             if with_order else None)
    ids = {"empty": np.zeros(0, np.int64),
           "one_row": rng.integers(-3, 4, 30),
           "all_equal": np.full(50, 17),
           "all_below": np.full(9, -5),
           "all_above": np.full(9, n + 5),
           "one_id": np.array([n // 2])}[case]
    pos = np.clip(ids, 0, n - 1)
    if order is not None:
        pos = order.numpy()[pos]
    want = table.numpy()[pos]
    for id_dtype in (torch.int32, torch.int64):
        got = b2.gather_rows(table, torch.from_numpy(ids).to(id_dtype), order)
        assert got.shape == (len(ids), 5)
        np.testing.assert_array_equal(got.numpy(), want)


# the main path's lookups: (ids, table rows, row bytes) -> route
MAIN_PATH_SHAPES = {
    "reddit_fp32": ((585_728, 232_965, 602 * 4), "grouped"),
    "reddit_bf16": ((585_728, 232_965, 602 * 2), "grouped"),
    "products": ((1_081_344, 2_449_029, 100 * 4), "direct"),
    "mag_paper": ((425_984, 2_000_000, 768 * 4), "direct"),
    "mag_author": ((424_960, 2_000_000, 768 * 4), "direct"),
    "mag_institution": ((384_000, 25_721, 768 * 4), "direct"),
}


@pytest.mark.parametrize("name", sorted(MAIN_PATH_SHAPES))
def test_route_at_main_path_shapes(name):
    shape, want = MAIN_PATH_SHAPES[name]
    assert b2.route(*shape) == want


# the shapes at the rule's edges timed on the H100 (b2_sweep.py, PERF.md),
# each moved on its own from Reddit's fp32 lookup -> the faster route
MEASURED_EDGES = {
    "ids_0.63_a_row": ((146_432, 232_965, 2408), "direct"),
    "ids_0.9_a_row": ((209_668, 232_965, 2408), "direct"),
    "ids_1.26_a_row": ((292_864, 232_965, 2408), "grouped"),
    "ids_1.5_a_row": ((349_447, 232_965, 2408), "grouped"),
    "rows_472_bytes": ((585_728, 232_965, 472), "direct"),
    "rows_600_bytes": ((585_728, 232_965, 600), "direct"),
    "rows_808_bytes": ((585_728, 232_965, 808), "grouped"),
    "rows_1204_bytes": ((585_728, 232_965, 1204), "grouped"),
    "rows_3072_bytes": ((585_728, 232_965, 3072), "grouped"),
    "table_72_mb": ((75_000, 30_000, 2408), "direct"),
    "table_96_mb": ((100_000, 40_000, 2408), "direct"),
    "table_193_mb": ((200_000, 80_000, 2408), "grouped"),
}


def test_route_rule_bounds():
    """The grouped route needs a table more than twice the L2, at least
    1.25 ids a row and rows of 808 bytes or more: at the shapes timed on
    each side of those edges the rule picks the route that was faster
    there (at 96 MB by 0.8%); no ids, or ids and rows past int32, go
    direct."""
    for name, (shape, want) in MEASURED_EDGES.items():
        assert b2.route(*shape) == want, name
    assert b2.route(0, 232_965, 2408) == "direct"
    assert b2.route(2**31, 2**31 - 1, 2408) == "direct"
