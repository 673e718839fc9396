"""Port parity: the lane-select element gather (``ops/fastgather.py``) and
the plain versions of kernels B3 (``element_gather`` and its pair entry)
and B4 (``lane_select`` and its fused entry ``lane_select_rows``) against
the JAX package on the same numpy inputs.

Outputs must be bitwise equal; fp32 outputs are compared as bit patterns,
over tables that hold ``-0.0``.  JAX's lane sums add zeros to the selected
element, which turns ``-0.0`` into ``+0.0``; the port gives the same bits.
The Pallas ``pallas_element_gather`` is not run here (its interpret mode
takes minutes on a CPU); JAX's own ``tests/test_fastgather.py`` holds it
to ``jnp.take``, and this file holds B3's plain version to ``jnp.take``
and to JAX's lane gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import fastgather as jfg
from quiver_tpu.ops.pallas.element_gather_kernel import BLK
from quiver_tpu.ops.pallas.element_gather_kernel import \
    lane_select as jax_lane_select

from quiver_tpu_torch.ops import fastgather as pfg
from quiver_tpu_torch.ops.cuda import element_gather as b3
from quiver_tpu_torch.ops.cuda import lane_select as b4

NEG0 = np.float32(-0.0).view(np.int32)


def bits(a) -> np.ndarray:
    """Bit patterns of a 4-byte array (numpy, JAX or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def table_of(dtype: str, n: int, seed: int) -> np.ndarray:
    """A 1-D table; fp32 ones hold -0.0 every 7th entry, +0.0 every 11th."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, n, dtype=np.int32)
    t = rng.standard_normal(n).astype(np.float32)
    t[::7] = -0.0
    t[::11] = 0.0
    return t


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", [(1000,), (37, 11)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_element_gather_matches_jax(dtype, shape, fused):
    """Counts that are not a multiple of 1,024, 1-D and 2-D ids.  JAX's
    ``fused=True`` runs a Pallas kernel that does not lower on the CPU;
    JAX defines both forms to give the same result, so both port forms are
    held to JAX's ``fused=False``."""
    table = table_of(dtype, 300, seed=len(shape))
    idx = np.random.default_rng(1).integers(0, 300, shape).astype(np.int32)
    idx.reshape(-1)[:3] = [0, 299, 0]
    want = jfg.element_gather(jfg.prepare_table(jnp.asarray(table)),
                              jnp.asarray(idx))
    got = pfg.element_gather(pfg.prepare_table(torch.from_numpy(table)),
                             torch.from_numpy(idx), fused=fused)
    assert got.shape == shape and got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(bits(got), bits(want))
    if dtype == "float32":
        hit = table[idx] == 0
        assert (bits(got)[hit] == 0).all() and (bits(table[idx]) == NEG0).any()


@pytest.mark.parametrize("fill", [None, 7])
@pytest.mark.parametrize("n", [300, 256])
def test_prepare_and_pad_match_jax(n, fill):
    for dtype in ("int32", "float32"):
        t = table_of(dtype, n, seed=n)
        want = np.asarray(jfg.pad_table_128(jnp.asarray(t), fill=fill))
        got_np = pfg.pad_table_128(t, fill=fill)
        got_t = pfg.pad_table_128(torch.from_numpy(t), fill=fill)
        assert isinstance(got_np, np.ndarray)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_array_equal(bits(got_np), bits(want))
        np.testing.assert_array_equal(bits(got_t), bits(want))
        assert got_np.shape[0] % 128 == 0
        np.testing.assert_array_equal(
            bits(pfg.prepare_table(torch.from_numpy(t))),
            bits(jfg.prepare_table(jnp.asarray(t))))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_lane_select_plain_matches_pallas_interpret(dtype):
    """B4's plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    rows = table_of(dtype, BLK * 2 * 128, seed=4).reshape(BLK * 2, 128)
    lanes = rng.integers(0, 128, BLK * 2).astype(np.int32)
    want = jax_lane_select(jnp.asarray(rows), jnp.asarray(lanes),
                           interpret=True)
    got = b4.lane_select(torch.from_numpy(rows), torch.from_numpy(lanes))
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(
        got.numpy(), rows[np.arange(BLK * 2), lanes])
    # a lane outside [0, 128) selects 0, as the one-hot sum does
    bad = torch.tensor([-1, 128, 5], dtype=torch.int32)
    out = b4.lane_select_plain(torch.from_numpy(rows[:3]), bad)
    assert out.tolist()[:2] == [0, 0] and out[2] == out.new_tensor(
        rows[2, 5] + 0)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_element_gather_plain_matches_take(dtype):
    """B3's plain version: values of ``jnp.take`` on the flat table
    (which returns -0.0 as it is), bits of JAX's lane gather, and ids
    outside the table clamped to its ends."""
    table = table_of(dtype, 256 * 128, seed=5)
    t2d = table.reshape(-1, 128)
    idx = np.random.default_rng(6).integers(0, table.shape[0],
                                            (37, 11)).astype(np.int32)
    got = b3.element_gather(torch.from_numpy(t2d), torch.from_numpy(idx))
    assert got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.take(jnp.asarray(table),
                                                      jnp.asarray(idx))))
    lanes = jfg.element_gather(jnp.asarray(t2d), jnp.asarray(idx))
    np.testing.assert_array_equal(bits(got), bits(lanes))
    ends = torch.tensor([-5, 0, table.shape[0] - 1, table.shape[0] + 9],
                        dtype=torch.int32)
    np.testing.assert_array_equal(
        bits(b3.element_gather(torch.from_numpy(t2d), ends)),
        bits(table[[0, 0, -1, -1]] + np.float32(0) if dtype == "float32"
             else table[[0, 0, -1, -1]]))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_element_gather_pair_plain_matches_take(dtype):
    """B3's pair entry on the CPU: ``(flat[clip(idx)], flat[clip(idx +
    1)])`` against two ``jnp.take(..., mode="clip")`` calls, with ids at
    both ends of the table and beyond (``idx + 1`` taken in 64 bits), and
    the bits of JAX's lane gather for the float ``+0.0``."""
    table = table_of(dtype, 64 * 128, seed=7)
    t2d = table.reshape(-1, 128)
    n = table.shape[0]
    idx = np.random.default_rng(8).integers(0, n, (45, 7)).astype(np.int32)
    idx.reshape(-1)[:6] = [0, n - 2, n - 1, n, n + 40, -3]
    lo, hi = b3.element_gather_pair(torch.from_numpy(t2d),
                                    torch.from_numpy(idx))
    assert lo.shape == hi.shape == idx.shape
    jt = jnp.asarray(table)
    for got, ids in ((lo, idx), (hi, idx.astype(np.int64) + 1)):
        want = jnp.take(jt, jnp.asarray(np.clip(ids, -5, n + 50)
                                        .astype(np.int32)), mode="clip")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        lanes = jfg.element_gather(jnp.asarray(t2d), jnp.asarray(
            np.clip(ids, 0, n - 1).astype(np.int32)))
        np.testing.assert_array_equal(bits(got), bits(lanes))
    assert lo.reshape(-1)[2] == hi.reshape(-1)[1] == hi.reshape(-1)[2]
    int_max = torch.tensor([2**31 - 1], dtype=torch.int32)
    assert b3.element_gather_pair(torch.from_numpy(t2d), int_max)[1].item() \
        == pytest.approx(float(table[-1] + 0))


@pytest.mark.parametrize("m", [1000, 2 * BLK])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_fused_element_gather_matches_pallas_interpret(dtype, m):
    """``fastgather.element_gather(fused=True)``, B4's fused entry
    (``lane_select_rows``), against JAX's fused form: the ``jnp.take`` row
    gather into the Pallas ``lane_select`` in interpret mode, padded to its
    1,024-row block as JAX pads it.  Bit patterns over a table holding
    -0.0."""
    table = table_of(dtype, 40 * 128, seed=9)
    t2d = jnp.asarray(table.reshape(-1, 128))
    idx = np.random.default_rng(m).integers(0, table.shape[0],
                                            m).astype(np.int32)
    idx[:2] = [0, table.shape[0] - 1]
    row, lane = idx >> 7, idx & 127
    pad = (-m) % BLK
    rows = jnp.take(t2d, jnp.asarray(np.pad(row, (0, pad))), axis=0)
    want = jax_lane_select(rows, jnp.asarray(np.pad(lane, (0, pad))),
                           interpret=True)[:m]
    got = pfg.element_gather(pfg.prepare_table(torch.from_numpy(table)),
                             torch.from_numpy(idx), fused=True)
    np.testing.assert_array_equal(bits(got), bits(want))
    if dtype == "float32":
        assert (bits(table[idx]) == NEG0).any()
        assert not (bits(got) == NEG0).any()


def test_lane_select_rows_plain():
    """B4's fused entry on the CPU is the row gather and B4's plain
    version: a lane outside ``[0, 128)`` selects 0, and a row outside the
    table raises (the kernel clamps it instead)."""
    t2d = torch.from_numpy(table_of("float32", 8 * 128, seed=10)
                           .reshape(8, 128))
    row = torch.tensor([0, 7, 3, 3], dtype=torch.int32)
    lane = torch.tensor([5, 127, -1, 128], dtype=torch.int32)
    got = b4.lane_select_rows(t2d, row, lane)
    want = b4.lane_select_plain(t2d.index_select(0, row), lane)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert got.tolist() == [t2d[0, 5].item() + 0, t2d[7, 127].item() + 0,
                            0.0, 0.0]
    with pytest.raises(IndexError):
        b4.lane_select_rows(t2d, torch.tensor([8], dtype=torch.int32),
                            lane[:1])


def test_wrappers_refuse_other_devices():
    t = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    i = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        b3.element_gather(t, i)
    with pytest.raises(ValueError):
        b4.lane_select(t, i)
    with pytest.raises(ValueError):
        b3.element_gather_pair(t, i)
    with pytest.raises(ValueError):
        b4.lane_select_rows(t, i, i)
