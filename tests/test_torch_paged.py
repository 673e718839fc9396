"""Port parity, the paged feature store: page geometry, the page table, the
fault planner's block plans and kernel B5's plain version, against the JAX
package on the same numpy inputs (``tests/test_paged.py``'s geometry:
512 rows of width 16, 8-row pages).

Plan arrays must be bitwise equal to JAX's ``PagedStore.stage``; page
tables, frame pools and counters equal after every batch; gathered rows
bitwise equal to the source.  JAX's own paged gathers run the Pallas
kernel in interpret mode (about 0.3 s each), so the plan stream compares
JAX's plans and the port's rows, and the kernel is compared once on the
hand-built plan of ``tests/test_paged.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.feature import Feature as JaxFeature
from quiver_tpu.ops import paged as jax_paged
from quiver_tpu.ops.pallas.page_gather_kernel import page_gather as jax_pg

import quiver_tpu_torch as qt
from quiver_tpu_torch import config
from quiver_tpu_torch.ops import paged
from quiver_tpu_torch.ops.cuda import page_gather as b5

N, D, HOT, R = 512, 16, 128, 8
N_HOST_PAGES = (N - HOT) // R
# feature counters both packages keep (bytes shipped differ by design:
# JAX pads each copy to a shape bucket)
COUNTED = ("feature_rows_total", "feature_coldcache_", "feature_page_")


# the JAX package's telemetry switch as the process starts (collection
# runs before any test can change it)
_JAX_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _jax_telemetry_on():
    """The JAX counters compared here need the JAX package's telemetry on;
    a test file run earlier in the same worker may have left it off.
    After each test the JAX registry is emptied and the switch set back to
    its default, so nothing these tests record or switch reaches a later
    file."""
    telemetry.set_enabled(True)
    yield
    telemetry.reset()
    telemetry.set_enabled(_JAX_TELEMETRY_DEFAULT)


def jax_counts() -> dict:
    return {k: float(v) for k, v in telemetry.snapshot()["counters"].items()
            if k.startswith(COUNTED) and v}


def port_counts(f) -> dict:
    return {k: float(v) for k, v in f.stats()["counters"].items()
            if k.startswith(COUNTED) and v}


def assert_same_cache(j, p):
    for k in ("slot_of", "node_of", "freq", "ref", "touches"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k),
                                      err_msg=k)
    for k in ("hand", "next_free", "hits", "misses", "evictions"):
        assert getattr(p, k) == getattr(j, k), k


def _feats(n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _paged(feats, hot=HOT, **kw):
    kw.setdefault("page_rows", R)
    f = qt.Feature(device_cache_size=hot, cache_unit="rows",
                   device="cpu").from_cpu_tensor(feats)
    return f.enable_paging(**kw)


# -- geometry and page table -----------------------------------------------

def test_page_geometry_matches_jax():
    for row_bytes in [*range(1, 3000, 37), 7, 64, 1204, 2408, 4096]:
        assert paged.default_page_rows(row_bytes) == \
            jax_paged.default_page_rows(row_bytes), row_bytes
    assert paged.default_page_rows(128, target_bytes=512) == 4
    for page_rows in (1, 8, 32, 64, 256):
        for dim in (1, 16, 100, 602, 1024):
            for itemsize in (2, 4):
                assert paged._plan_geometry(page_rows, dim, itemsize) == \
                    jax_paged._plan_geometry(page_rows, dim, itemsize)
    assert paged.default_page_rows(602 * 4) == 64
    assert paged._plan_geometry(64, 602, 4) == (8, 8)


@pytest.mark.parametrize("n_rows,cc,pr,pool", [
    (100, 20, 8, 4), (512, 128, 8, 10_000), (515, 130, 8, 16), (64, 0, 8, 3),
    (64, 64, 8, 3), (10, 3, 4, 0)])
def test_page_table_matches_jax(n_rows, cc, pr, pool):
    j = jax_paged.PageTable(n_rows, cc, pr, pool)
    p = paged.PageTable(n_rows, cc, pr, pool)
    for k in ("page_rows", "n_rows", "n_pages", "hot_pages", "n_host_pages",
              "pool_pages", "n_frames"):
        assert getattr(p, k) == getattr(j, k), k
    assert p.resident_pages() == j.resident_pages()
    assert [p.state_of(i) for i in range(p.n_pages)] == \
        [j.state_of(i) for i in range(j.n_pages)]
    assert (p.cache is None) == (j.cache is None)


def test_enable_paging_sizes_match_jax():
    feats = _feats()
    for hot, kw in ((HOT, {}), (0, {}), (HOT, dict(pool_pages=3)),
                    (500, {})):
        jf = JaxFeature(device_cache_size=hot,
                        cache_unit="rows").from_cpu_tensor(feats)
        jf.enable_paging(**kw)
        pf = qt.Feature(device_cache_size=hot, cache_unit="rows",
                        device="cpu").from_cpu_tensor(feats)
        pf.enable_paging(**kw)
        jt, pt = jf.paged.table, pf.paged.table
        assert (pt.page_rows, pt.hot_pages, pt.pool_pages) == \
            (jt.page_rows, jt.hot_pages, jt.pool_pages)
        assert (pf.paged.block, pf.paged.ppb) == (jf.paged.block,
                                                  jf.paged.ppb)
        np.testing.assert_array_equal(pf.paged.frames.numpy(),
                                      np.asarray(jf.paged.frames))


def test_config_on_enables_paging():
    feats = _feats()
    with config.override(feature_paged="on", feature_page_rows=R,
                         feature_page_pool=16):
        f = qt.Feature(device_cache_size=HOT, cache_unit="rows",
                       device="cpu").from_cpu_tensor(feats)
        full = qt.Feature(device_cache_size=N, cache_unit="rows",
                          device="cpu").from_cpu_tensor(feats)
    assert f.paged.table.page_rows == R and f.paged.table.pool_pages == 16
    assert full.paged is None
    ids = np.random.default_rng(1).integers(0, N, 64)
    np.testing.assert_array_equal(f[ids].numpy(), feats[ids])
    assert qt.Feature(device_cache_size=HOT, cache_unit="rows",
                      device="cpu").from_cpu_tensor(feats).paged is None


# -- the planner ------------------------------------------------------------

def _plan_stream(rng, n):
    """Batches of up to 400 ids (several plan blocks of 128) with
    duplicates (runs across block edges), rows both sides of the hot
    edge, hot rows beside a 12-page window that moves over the host pages
    (so a 16-page pool evicts), the short tail page, and every fifth
    batch too wide for the pool."""
    out = []
    for i in range(16):
        B = int(rng.integers(2, 400))
        lo = HOT + (i * 5 * R) % (n - HOT - 12 * R)
        if i % 5 == 4:
            ids = HOT + 2 + rng.choice(n - HOT - 2, 100, replace=False)
        elif i % 3 == 0:
            ids = rng.integers(HOT - 10, HOT + 30, B)  # boundary page
        else:
            ids = np.concatenate([rng.integers(0, HOT, B // 3),
                                  rng.integers(lo, lo + 12 * R,
                                               B - B // 3)])
        if i % 2:
            ids[: B // 2 + 1] = ids[-1]
        ids[0] = n - 1 if i == 7 else ids[0]          # the short tail page
        out.append(ids.astype(np.int64))
    return out


@pytest.mark.parametrize("policy", ["clock", "minfreq"])
def test_plans_frames_and_counts_match_jax(policy):
    """``stage`` on the same stream: every plan array bitwise equal to
    JAX's, the page table and the frame pool equal after every batch, the
    same batches falling back, the same counters; the port's gather of
    each plan returns the source rows."""
    telemetry.reset()
    n = N + 3  # a short tail page
    feats = _feats(n)
    hot = HOT + 2  # the boundary page straddles the hot edge
    jf = JaxFeature(device_cache_size=hot, cache_unit="rows",
                    cold_cache_policy=policy).from_cpu_tensor(feats)
    jf.enable_paging(page_rows=R, pool_pages=16)
    pf = qt.Feature(device_cache_size=hot, cache_unit="rows",
                    cold_cache_policy=policy,
                    device="cpu").from_cpu_tensor(feats)
    pf.enable_paging(page_rows=R, pool_pages=16)
    fell_back = planned = 0
    for ids in _plan_stream(np.random.default_rng(5), n):
        js = jf.paged.stage(ids, jnp, telemetry)
        ps = pf.paged.stage(ids)
        assert (js is None) == (ps is None)
        if ps is None:
            fell_back += 1
        else:
            planned += 1
            assert ps[-1] == js[-1] == len(ids)
            for name, a, b in zip(("blk_pages", "blk_np", "row_lp",
                                   "row_off", "rank"), ps[1:6], js[2:7]):
                assert a.dtype == np.int32, name
                np.testing.assert_array_equal(a, np.asarray(b),
                                              err_msg=name)
            np.testing.assert_array_equal(pf.paged.finish(ps).numpy(),
                                          feats[ids])
        assert_same_cache(jf.paged.table.cache, pf.paged.table.cache)
        np.testing.assert_array_equal(pf.paged.frame_of_pages(),
                                      jf.paged.frame_of_pages())
        np.testing.assert_array_equal(pf.paged.frames.numpy(),
                                      np.asarray(jf.paged.frames))
    assert fell_back >= 2 and pf.paged.fallbacks == jf.paged.fallbacks
    assert planned >= 10
    st = pf.paged.stats()
    assert st["cache"] == jf.paged.stats()["cache"]
    assert port_counts(pf) == jax_counts()
    assert port_counts(pf)["feature_page_evictions_total"] > 0


def test_vectorized_planner_equals_block_loop():
    """``plan_blocks`` against the JAX planner's per-block loop, written
    out, at the Reddit geometry (block 8) and at block 16, with frame ids
    that fit 16 bits and ids that do not."""
    rng = np.random.default_rng(9)
    for block, hi in ((8, 40), (16, 40), (8, 70_000)):
        for B in (1, 7, 8, 9, 100, 1001):
            frame = rng.integers(0, hi, B).astype(np.int32)
            off = rng.integers(0, 64, B).astype(np.int32)
            got = paged.plan_blocks(frame, off, block, block)
            order = np.argsort(frame, kind="stable")
            sf = frame[order]
            nb = -(-B // block)
            blk_pages = np.zeros(nb * block, np.int32)
            blk_np = np.zeros(nb, np.int32)
            row_lp = np.zeros(nb * block, np.int32)
            for b in range(nb):
                lo, hi = b * block, min((b + 1) * block, B)
                uniq, inv = np.unique(sf[lo:hi], return_inverse=True)
                blk_pages[b * block: b * block + len(uniq)] = uniq
                blk_np[b] = len(uniq)
                row_lp[lo:hi] = inv
            for a, w in zip(got[:3], (blk_pages, blk_np, row_lp)):
                np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(got[3][:B], off[order])
            np.testing.assert_array_equal(order[got[4]], np.arange(B))


# -- kernel B5's plain version --------------------------------------------

def test_page_gather_plain_matches_pallas_kernel():
    """The hand-built plan of tests/test_paged.py (two blocks, different
    distinct-page counts, a padded tail) through JAX ``page_gather`` in
    interpret mode and through the plain version, with the identity rank
    (all 16 padded rows) and with a shuffled rank over the 13 real rows."""
    rng = np.random.default_rng(7)
    F, pr, d, block, ppb = 5, 4, 8, 8, 8
    frames = rng.standard_normal((F, pr, d)).astype(np.float32)
    nb, M, B = 2, 16, 13
    blk_np = np.array([3, 2], dtype=np.int32)
    blk_pages = np.zeros(nb * ppb, dtype=np.int32)
    blk_pages[0:3] = [0, 2, 4]
    blk_pages[ppb:ppb + 2] = [1, 3]
    row_lp = np.zeros(M, dtype=np.int32)
    row_off = np.zeros(M, dtype=np.int32)
    for i in range(B):
        row_lp[i] = rng.integers(0, blk_np[i // block])
        row_off[i] = rng.integers(0, pr)
    want = np.asarray(jax_pg(
        jnp.asarray(frames), jnp.asarray(blk_pages), jnp.asarray(blk_np),
        jnp.asarray(row_lp), jnp.asarray(row_off), page_rows=pr,
        block=block, ppb=ppb, interpret=True))
    t = torch.from_numpy
    plan = (t(blk_pages), t(row_lp), t(row_off))
    before = b5.page_gather.launches
    got = b5.page_gather(t(frames), *plan, t(np.arange(M, dtype=np.int32)),
                         block, ppb)
    np.testing.assert_array_equal(got.numpy(), want)
    rank = rng.permutation(B).astype(np.int32)
    got = b5.page_gather(t(frames), *plan, t(rank), block, ppb)
    np.testing.assert_array_equal(got.numpy(), want[rank])
    assert b5.page_gather.launches == before  # CPU tensors: plain version


# -- the paged Feature --------------------------------------------------------

def test_paged_rows_every_residency_mix():
    """Hot-only, overlay hits (no refault), fresh faults, the boundary and
    tail pages, prob order and pool overflow: rows bitwise equal to the
    source."""
    rng = np.random.default_rng(3)
    feats = _feats()
    f = _paged(feats, pool_pages=16)
    ids = rng.integers(0, HOT, 64)
    np.testing.assert_array_equal(f[ids].numpy(), feats[ids])
    assert f.paged.table.cache.resident == 0
    ids = rng.integers(HOT, HOT + 16 * R, 64)
    np.testing.assert_array_equal(f[ids].numpy(), feats[ids])
    faults = f.stats()["counters"]["feature_page_faults_total"]
    np.testing.assert_array_equal(f[ids].numpy(), feats[ids])
    c = f.stats()["counters"]
    assert c["feature_page_faults_total"] == faults
    assert c["feature_page_hits_total"] > 0
    wide = HOT + rng.choice(N - HOT, 96, replace=False)
    np.testing.assert_array_equal(f[wide].numpy(), feats[wide])
    assert f.paged.fallbacks == 1

    odd = _feats(N + 3)
    f = _paged(odd, hot=HOT + 2, pool_pages=16)
    edge = np.arange(HOT - 4, HOT + 12)
    tail = np.arange(N - 2, N + 3)
    for ids in (edge, tail):
        np.testing.assert_array_equal(f[ids].numpy(), odd[ids])

    prob = rng.random(N)
    f = qt.Feature(device_cache_size=HOT, cache_unit="rows",
                   device="cpu").from_cpu_tensor(feats, prob=prob)
    f.enable_paging(page_rows=R, pool_pages=N_HOST_PAGES)
    for _ in range(4):
        ids = rng.integers(0, N, 64)
        np.testing.assert_array_equal(f[ids].numpy(), feats[ids])


def test_paged_matches_jax_getitem_once():
    """One JAX paged gather (the Pallas kernel in interpret mode) against
    the port on the same mixed batch."""
    feats = _feats()
    ids = np.random.default_rng(4).integers(0, N, 40)
    jf = JaxFeature(device_cache_size=HOT,
                    cache_unit="rows").from_cpu_tensor(feats)
    jf.enable_paging(page_rows=R, pool_pages=N_HOST_PAGES)
    f = _paged(feats, pool_pages=N_HOST_PAGES)
    np.testing.assert_array_equal(f[ids].numpy(), np.asarray(jf[ids]))


@pytest.mark.parametrize("overlay", [False, True])
def test_pool_overflow_falls_back(overlay):
    """A batch whose pages exceed the pool is served by the staged merge,
    or by the overlay when one is attached, and counted."""
    feats = _feats()
    f = _paged(feats, pool_pages=8)
    if overlay:
        f.enable_cold_cache(rows=64, admit_threshold=1)
    ids = HOT + np.random.default_rng(2).choice(N - HOT, 96, replace=False)
    for _ in range(2):
        np.testing.assert_array_equal(f[ids].numpy(), feats[ids])
    c = f.stats()["counters"]
    assert c["feature_page_fallback_total"] == 2 == f.paged.fallbacks
    assert (c.get("feature_coldcache_rows_total{result=hit}", 0) > 0) \
        == overlay


def test_staged_plan_keeps_its_rows_after_eviction():
    """Stage A (faulting A's pages into the pool), then stage B, which
    evicts every one of A's pages and rewrites their frames in place: A's
    rows still come back."""
    feats = _feats()
    f = _paged(feats, pool_pages=8)
    a_ids = HOT + np.arange(8 * R)          # host pages 0..7
    b_ids = HOT + 8 * R + np.arange(8 * R)  # host pages 8..15
    with f._plock:
        a = f._stage(a_ids)
        frames_a = f.paged.frames.clone()
        b = f._stage(b_ids)
    assert not torch.equal(f.paged.frames, frames_a)
    assert (f.paged.table.cache.slot_of[:8] < 0).all()
    np.testing.assert_array_equal(a.numpy(), feats[a_ids])
    np.testing.assert_array_equal(b.numpy(), feats[b_ids])


def test_invalidate_moves_page_back_to_host():
    feats = _feats()
    jf = JaxFeature(device_cache_size=HOT,
                    cache_unit="rows").from_cpu_tensor(feats)
    jf.enable_paging(page_rows=R, pool_pages=8)
    f = _paged(feats, pool_pages=8)
    page = HOT // R + 2
    nid = np.array([page * R + 3])
    assert f.paged.table.state_of(page) == paged.HOST
    f[nid]
    jf.paged.stage(nid, jnp, telemetry)
    assert f.paged.table.state_of(page) == paged.OVERLAY
    assert f.invalidate_rows(nid) == jf.invalidate_rows(nid) == 0
    assert f.paged.table.state_of(page) == paged.HOST
    assert_same_cache(jf.paged.table.cache, f.paged.table.cache)
    np.testing.assert_array_equal(f[nid].numpy(), feats[nid])
