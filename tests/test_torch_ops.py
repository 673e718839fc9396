"""Port parity, ops level: topology, the counter hash, one sampling hop
(kernel B1's plain version) and the row gather (kernel B2's plain version)
against the JAX package on the same numpy inputs.

Integer outputs and gathered rows must be bitwise equal.  The JAX
references run the ``gather_mode="xla", sample_rng="hash"`` route, which
the JAX suite holds bitwise equal to the Pallas ``pwindow`` kernel
(tests/test_gather_modes.py); one module-scoped case runs ``pwindow``
itself, in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import _hash_uniform as jax_hash_uniform
from quiver_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from quiver_tpu.ops.sample import to_ragged as jax_to_ragged
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils import synthetic as jax_synthetic
from quiver_tpu.utils import topology as jax_topology

import quiver_tpu_torch as qt
from quiver_tpu_torch.ops import sample as port_sample
from quiver_tpu_torch.ops.cuda import gather_rows as b2
from quiver_tpu_torch.ops.cuda import window_sample as b1

HOP_FIELDS = ("nbrs", "mask", "counts", "eid")


def _skewed_csr(seed=0, n=2000):
    """Degrees from 0 to far above any fanout, plus one very long row so
    the fp32 stratum bounds run at large degree."""
    rng = np.random.default_rng(seed)
    deg = np.where(rng.random(n) < 0.2, rng.integers(100, 3000, n),
                   rng.integers(0, 30, n))
    deg[:5] = 0
    deg[7] = 200_003
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _words(key):
    return tuple(int(np.asarray(w)) for w in _fold_key_words(key))


def _assert_hop_equal(j, p):
    for name in HOP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(p, name).numpy(), err_msg=name)


@pytest.fixture(scope="module")
def graph():
    indptr, indices = _skewed_csr()
    jt = jax_topology.CSRTopo(indptr=indptr, indices=indices)
    pt = qt.CSRTopo(indptr=indptr, indices=indices)
    return jt.to_device(), pt.to_device("cpu")


# -- topology and synthetic graphs ---------------------------------------

def test_to_device_padding_matches(graph):
    (jip, jix), (pip, pix) = graph
    assert pip.dtype == pix.dtype == torch.int32
    assert pip.shape[0] % 128 == 0 and pix.shape[0] % 128 == 0
    np.testing.assert_array_equal(np.asarray(jip), pip.numpy())
    np.testing.assert_array_equal(np.asarray(jix), pix.numpy())


def test_coo_to_csr_matches():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    for a, b in zip(jax_topology.coo_to_csr(src, dst, 60),
                    qt.coo_to_csr(src, dst, 60)):
        np.testing.assert_array_equal(a, b)
    jt = jax_topology.CSRTopo(edge_index=np.stack([src, dst]))
    pt = qt.CSRTopo(edge_index=np.stack([src, dst]))
    np.testing.assert_array_equal(jt.indptr, pt.indptr)
    np.testing.assert_array_equal(jt.indices, pt.indices)
    np.testing.assert_array_equal(jt.eid, pt.eid)


def test_reindex_feature_matches():
    indptr, indices = jax_synthetic.synthetic_csr(500, 6000, seed=2)
    feat = np.random.default_rng(0).random((500, 4)).astype(np.float32)
    for ratio in (0.0, 0.3, 1.0):
        jf, jo = jax_topology.reindex_feature(
            jax_topology.CSRTopo(indptr=indptr, indices=indices), feat, ratio)
        pf, po = qt.reindex_feature(
            qt.CSRTopo(indptr=indptr, indices=indices), feat, ratio)
        np.testing.assert_array_equal(jo, po)
        np.testing.assert_array_equal(jf, pf)


@pytest.mark.parametrize("sz", [0, 4096, 3.0, "200M", "1.5GB", "64K", "77"])
def test_parse_size_matches(sz):
    assert qt.parse_size(sz) == jax_topology.parse_size(sz)


def test_synthetic_csr_matches():
    for a, b in zip(jax_synthetic.synthetic_csr(1000, 20000, seed=4),
                    qt.synthetic_csr(1000, 20000, seed=4)):
        np.testing.assert_array_equal(a, b)


# -- the counter hash ----------------------------------------------------

def test_mul32_keeps_low_bits():
    """int64 products of two 32-bit words overflow the sign; the split
    multiply must still give the low 32 bits."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 10_000, dtype=np.uint64)
    x[:3] = [0, 1, 2**32 - 1]
    for c in (port_sample.HASH_PHI, port_sample.HASH_MUL1,
              port_sample.HASH_MUL2, 2**32 - 1):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = port_sample._mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_hash_uniform_bitwise(impl):
    key = make_key(11, impl=impl)
    k0, k1 = _words(key)
    want = np.asarray(jax_hash_uniform(key, (37, 13)))
    got = port_sample._hash_uniform(k0, k1, (37, 13)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- one sampling hop ----------------------------------------------------

@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("k", [1, 7, 25])
def test_hop_bitwise_equal(graph, impl, k):
    """Zero-degree seeds, deg <= k, deg > k (up to 200k), masked seeds and
    the last rows of the table, against ``sample_rng="hash"``."""
    (jip, jix), (pip, pix) = graph
    rng = np.random.default_rng(k)
    n = jip.shape[0]
    seeds = np.concatenate([np.arange(10), rng.integers(0, 2000, 150),
                            [1999, 1998, 7]]).astype(np.int32)
    smask = rng.random(len(seeds)) < 0.8
    smask[[0, 7, -1]] = True
    key = make_key(5 + k, impl=impl)
    want = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), k, key,
                                seed_mask=jnp.asarray(smask),
                                gather_mode="xla", sample_rng="hash")
    got = qt.sample_neighbors(pip, pix, torch.from_numpy(seeds), k,
                              np.array(_words(key), np.uint32),
                              seed_mask=torch.from_numpy(smask),
                              device="cpu")
    _assert_hop_equal(want, got)
    assert n == pip.shape[0]


def test_hop_without_mask_and_ragged(graph):
    (jip, jix), (pip, pix) = graph
    seeds = np.arange(0, 2000, 37, dtype=np.int32)
    key = make_key(21)
    want = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), 10, key,
                                gather_mode="xla", sample_rng="hash")
    got = qt.sample_neighbors(pip, pix, torch.from_numpy(seeds), 10,
                              _words(key), device="cpu")
    _assert_hop_equal(want, got)
    jflat, jcounts = jax_to_ragged(want)
    pflat, pcounts = qt.to_ragged(got)
    np.testing.assert_array_equal(np.asarray(jflat), pflat.numpy())
    np.testing.assert_array_equal(np.asarray(jcounts), pcounts.numpy())


def test_window_at_table_end():
    """A seed whose window ends at the last real edge, next to the
    128-padding."""
    deg = np.array([0, 5, 300, 130], np.int64)
    indptr = np.zeros(5, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = np.arange(int(indptr[-1]), dtype=np.int32) * 3 + 1
    jip, jix = jax_topology.CSRTopo(indptr=indptr,
                                    indices=indices).to_device()
    pip, pix = qt.CSRTopo(indptr=indptr, indices=indices).to_device("cpu")
    seeds = np.array([3, 2, 1, 0, 3], np.int32)
    key = make_key(8)
    for k in (4, 10):
        want = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), k, key,
                                    gather_mode="xla", sample_rng="hash")
        got = qt.sample_neighbors(pip, pix, torch.from_numpy(seeds), k,
                                  _words(key), device="cpu")
        _assert_hop_equal(want, got)


@pytest.fixture(scope="module")
def pwindow_hop(graph):
    """The one JAX ``gather_mode="pwindow"`` call of the port's tests (the
    Pallas kernel in interpret mode, ~30 s here)."""
    (jip, jix), _ = graph
    rng = np.random.default_rng(99)
    seeds = np.concatenate([np.arange(8), rng.integers(0, 2000, 56)])
    seeds = seeds.astype(np.int32)
    smask = rng.random(64) < 0.85
    key = make_key(31)
    out = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), 10, key,
                               seed_mask=jnp.asarray(smask),
                               gather_mode="pwindow", sample_rng="hash")
    return seeds, smask, key, jax.tree.map(np.asarray, out)


def test_hop_matches_pallas_window_kernel(graph, pwindow_hop):
    _, (pip, pix) = graph
    seeds, smask, key, want = pwindow_hop
    got = qt.sample_neighbors(pip, pix, torch.from_numpy(seeds), 10,
                              _words(key), seed_mask=torch.from_numpy(smask),
                              device="cpu")
    _assert_hop_equal(want, got)


def test_window_sample_cpu_route_is_plain(graph):
    """On CPU tensors the B1 wrapper runs the plain version and launches
    nothing."""
    _, (pip, pix) = graph
    seeds = torch.arange(0, 400, 3, dtype=torch.int32)
    mask = seeds % 5 != 0
    before = b1.window_sample.launches
    got = b1.window_sample(pip, pix, seeds, 9, 123, 456, mask)
    want = b1.window_sample_plain(pip, pix, seeds, 9, 123, 456, mask)
    assert b1.window_sample.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- row gather ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_matches_pallas_kernel(dtype):
    """B2 against the Pallas ``gather_rows`` (interpret mode) on the same
    table and ids; the port takes any row count, the Pallas kernel a
    multiple of its block."""
    from quiver_tpu.ops.pallas.gather_kernel import gather_rows as pallas_rows

    rng = np.random.default_rng(6)
    table = torch.from_numpy(
        rng.standard_normal((300, 602)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, 300, 256).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(pallas_rows(
        jnp.asarray(table.float().numpy()).astype(jdt), jnp.asarray(idx),
        block=128, interpret=True).astype(jnp.float32))
    before = b2.gather_rows.launches
    got = b2.gather_rows(table, torch.from_numpy(idx))
    assert b2.gather_rows.launches == before
    np.testing.assert_array_equal(got.float().numpy(), want)
    odd = b2.gather_rows(table, torch.from_numpy(idx[:77]))
    np.testing.assert_array_equal(odd.float().numpy(), want[:77])


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails or is missing raises; no library is left
    behind for a later load to pick up."""
    from quiver_tpu_torch.ops.cuda import KERNELS, build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed on window_sample"):
        build.build_all(KERNELS)
    monkeypatch.setattr(build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(OSError):
        build.build_all(KERNELS)
    assert not list(tmp_path.glob("*.so"))


def test_lib_path_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel's library name changes when the source or any local header
    it includes (directly or through another header) changes, and only
    then: a shared header edit never loads a stale library."""
    from quiver_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert [p.name for p in build._sources("k")] == ["k.cu", "a.cuh",
                                                      "b.cuh"]
    first = build._lib_path("k")
    assert build._lib_path("k") == first
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build._lib_path("k") == first
    paths = {first}
    for name in ("b.cuh", "a.cuh", "k.cu"):
        (tmp_path / name).write_text((tmp_path / name).read_text() + "//\n")
        paths.add(build._lib_path("k"))
    assert len(paths) == 4
    # the port's own kernels: both B3 and B4 hash the shared header
    monkeypatch.undo()
    for name in ("element_gather", "lane_select"):
        assert "element_gather.cuh" in [p.name for p in build._sources(name)]


@pytest.mark.parametrize("row_bytes,addr,want", [
    (602 * 4, 0, 8), (602 * 2, 0, 4), (256 * 2, 0, 16), (3 * 2, 0, 2),
    (7, 0, 1), (64, 8, 8), (64, 4, 4)])
def test_vector_bytes(row_bytes, addr, want):
    assert b2.vector_bytes(row_bytes, 256, addr) == want
