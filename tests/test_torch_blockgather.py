"""Port parity: the ``gather_mode="blocked[:U]"`` reads and hop against
the JAX package on the same numpy inputs.

JAX compacts the seeds whose window spans more than ``U`` rows into
``S = B * fallback_frac`` slots and takes its classic path for the whole
batch when more do not fit (``lax.cond``); the port reads every window
through kernel B3 (``ops/blockgather.py``).  The inputs below make JAX
take both routes (``fallback_frac`` 0.25: the compacted fallback; 0.02
with half the windows wide: the classic path), and every port output must
equal JAX's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu.ops import blockgather as jax_bg
from quiver_tpu.ops.sample import _fold_key_words
from quiver_tpu.ops.sample import sample_neighbors as jax_sample_neighbors
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt
from quiver_tpu_torch import config
from quiver_tpu_torch.ops import blockgather as bg
from quiver_tpu_torch.ops import sample as qt_sample

B, K = 64, 7


def _windows(U, frac):
    """Windows far wider than U rows for a tenth of the seeds under
    ``frac`` 0.25 (JAX's compacted fallback holds them) and for half under
    0.02 (it cannot: JAX's classic path); the table is 128-padded;
    positions lie in each window."""
    rng = np.random.default_rng(U * 100 + int(frac * 100))
    wide = rng.random(B) < (0.1 if frac > 0.1 else 0.5)
    deg = np.where(wide, rng.integers(U * 128 + 1, 1000, B),
                   rng.integers(1, 20, B)).astype(np.int32)
    deg[:3] = 0
    total = int(deg.sum())
    start = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    nfall = int(jax_bg._fit_split(jnp.asarray(start), jnp.asarray(deg), U,
                                  B, frac)[2])
    S = max(int(B * frac), 8)
    assert 0 < nfall and (nfall <= S) == (frac > 0.1), (nfall, S)
    pos = np.minimum((rng.random((B, K)) * deg[:, None]).astype(np.int32),
                     np.maximum(deg[:, None] - 1, 0))
    return rng, deg, total + (-total) % 128, start, pos


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("U", [1, 2, 3])
@pytest.mark.parametrize("frac", [0.25, 0.02])
def test_blocked_window_read_matches_jax_routes(U, frac):
    """The port's window read under ``"blocked:U"`` (kernel B3's plain
    version here) against JAX's blocked gather on its compacted-fallback
    route (0.25) and its classic route (0.02)."""
    rng, deg, n, start, pos = _windows(U, frac)
    table = rng.integers(0, 1 << 30, n).astype(np.int32)
    want = np.asarray(jax_bg.blocked_window_gather(
        jnp.asarray(table).reshape(-1, 128), jnp.asarray(start),
        jnp.asarray(deg), jnp.asarray(pos), U=U, fallback_frac=frac))
    got = qt_sample._gather(_t(table), _t(start[:, None] + pos),
                            f"blocked:{U}")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[start[:, None] + pos])


@pytest.mark.parametrize("U", [1, 2, 3])
@pytest.mark.parametrize("frac", [0.25, 0.02])
def test_blocked_cdf_search_matches_jax_routes(U, frac):
    """The weighted hop's CDF search under ``"blocked:U"`` (B3's plain
    version, 24 rounds) finds the positions JAX's blocked count finds on
    both of its routes, flat CDF steps included; JAX leaves degree-0 rows
    undefined, so they are not compared."""
    rng, deg, n, start, _ = _windows(U, frac)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0  # flat steps in the CDF
    indptr = np.concatenate([start, [int(deg.sum())]]).astype(np.int64)
    cw = qt_sample.row_cumsum_weights(indptr, w[:indptr[-1]])
    cw = np.concatenate([cw, np.full(n - cw.shape[0], cw[-1], np.float32)])
    total = np.where(deg > 0, cw[np.maximum(start + deg - 1, 0)], 0.0)
    u = (rng.random((B, K)) * total[:, None]).astype(np.float32)
    want = np.asarray(jax_bg.blocked_weighted_positions(
        jnp.asarray(cw).reshape(-1, 128), jnp.asarray(start),
        jnp.asarray(deg), jnp.asarray(u), U=U, fallback_frac=frac))
    got = qt_sample._cdf_search(_t(cw), _t(start), _t(start + deg), _t(u),
                                24, f"blocked:{U}").numpy() - start[:, None]
    live = deg > 0
    np.testing.assert_array_equal(got[live], want[live])


def test_parse_blocked_matches_jax():
    for mode in ("blocked", "blocked:1", "blocked:5"):
        assert bg.parse_blocked(mode) == jax_bg.parse_blocked(mode)
    for bad in ("blocked:0", "blocked4", "blocked:x"):
        with pytest.raises(ValueError):
            bg.parse_blocked(bad)
        with pytest.raises(ValueError):
            jax_bg.parse_blocked(bad)
    assert config.resolve_gather_mode("blocked:2") == "blocked:2"
    with config.override(gather_mode="blocked"):
        assert config.resolve_gather_mode("auto") == "blocked"


@pytest.mark.parametrize("U", [1, 2, 3])
def test_blocked_hop_matches_jax(U):
    """One uniform hop under ``"blocked:U"`` on a skewed graph, masked
    seeds included, against JAX's ``"blocked:U"`` hop."""
    rng = np.random.default_rng(U)
    n = 1500
    deg = np.where(rng.random(n) < 0.2, rng.integers(200, 2000, n),
                   rng.integers(0, 20, n))
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    jip, jix = JaxTopo(indptr=indptr, indices=indices).to_device()
    pip, pix = qt.CSRTopo(indptr=indptr, indices=indices).to_device("cpu")
    seeds = rng.integers(0, n, 300).astype(np.int32)
    smask = rng.random(300) < 0.8
    key = make_key(U)
    words = tuple(int(np.asarray(w)) for w in _fold_key_words(key))
    j = jax_sample_neighbors(jip, jix, jnp.asarray(seeds), 9, key,
                             seed_mask=jnp.asarray(smask),
                             gather_mode=f"blocked:{U}", sample_rng="hash")
    p = qt.sample_neighbors(pip, pix, _t(seeds), 9, words,
                            seed_mask=_t(smask), device="cpu",
                            gather_mode=f"blocked:{U}")
    for name in ("nbrs", "mask", "counts", "eid"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
