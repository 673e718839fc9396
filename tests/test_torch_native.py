"""Port parity: the native host sampler (``quiver_tpu_torch/cpp/native.py``).

The port compiles its own byte-identical copy of the JAX package's C++
source, so every output is bitwise equal to the JAX package's native
sampler for the same sequence of calls: one hop with and without a seed
mask, weighted and unweighted, the threaded branch (``B >= 256``) at 1 and
4 threads, the dedup relabel, the multi-hop pipeline, the COO -> CSR sort
and the sampled neighbourhood sizes.  A failed build raises; there is no
fallback.
"""

import sys
import threading

import numpy as np
import pytest

from quiver_tpu.cpp import native as jn

import quiver_tpu_torch as qt
from quiver_tpu_torch.cpp import native as pn

N = 700


@pytest.fixture(scope="module")
def csr():
    indptr, indices = qt.synthetic_csr(N, 9_000, seed=11)
    weights = np.random.default_rng(2).random(int(indptr[-1])) + 0.05
    return indptr, indices, weights


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform",
                                                         "weighted"])
def test_sample_neighbors_matches_jax(csr, weighted):
    """A sequence of calls (each advances the samplers' counters), with
    and without a seed mask, then a pinned seed."""
    indptr, indices, w = csr
    w = w if weighted else None
    js = jn.CPUSampler(indptr, indices, edge_weights=w)
    ps = pn.CPUSampler(indptr, indices, edge_weights=w)
    rng = np.random.default_rng(5)
    for k in (1, 4, 9):
        seeds = rng.integers(0, N, 120)
        mask = rng.random(120) < 0.6
        _equal(ps.sample_neighbors(seeds, k), js.sample_neighbors(seeds, k))
        _equal(ps.sample_neighbors(seeds, k, mask),
               js.sample_neighbors(seeds, k, mask))
    _equal(ps.sample_neighbors(seeds, 5, seed=1234),
           js.sample_neighbors(seeds, 5, seed=1234))
    nbrs, mask, counts = ps.sample_neighbors(seeds, 5, seed=1234)
    deg = np.diff(indptr)[seeds]
    np.testing.assert_array_equal(counts, np.minimum(deg, 5))
    for b in range(len(seeds)):
        row = set(indices[indptr[seeds[b]]: indptr[seeds[b] + 1]].tolist())
        assert set(nbrs[b][mask[b]].tolist()) <= row


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform",
                                                         "weighted"])
def test_threaded_branch_draws_independent_of_threads(csr, weighted):
    """``B >= 256`` splits the rows over threads; 1 and 4 threads and JAX's
    library draw the same."""
    indptr, indices, w = csr
    w = w if weighted else None
    seeds = np.random.default_rng(8).integers(0, N, 600)
    mask = np.arange(600) % 7 != 3
    outs = [pn.CPUSampler(indptr, indices, n_threads=t, edge_weights=w)
            .sample_neighbors(seeds, 6, mask) for t in (1, 4)]
    want = jn.CPUSampler(indptr, indices, n_threads=4,
                         edge_weights=w).sample_neighbors(seeds, 6, mask)
    _equal(outs[0], outs[1])
    _equal(outs[0], want)


def test_reindex_and_multihop_match_jax(csr):
    indptr, indices, _ = csr
    js = jn.CPUSampler(indptr, indices)
    ps = pn.CPUSampler(indptr, indices)
    rng = np.random.default_rng(3)
    seeds = np.concatenate([rng.integers(0, N, 40), [7, 7, 0]])
    smask = rng.random(len(seeds)) < 0.8
    nbrs, mask, _ = js.sample_neighbors(seeds, 5, smask)
    _equal(ps.sample_neighbors(seeds, 5, smask)[:2], (nbrs, mask))
    _equal(ps.reindex(seeds, nbrs, mask, smask),
           js.reindex(seeds, nbrs, mask, smask))
    _equal(ps.reindex(seeds, nbrs, mask), js.reindex(seeds, nbrs, mask))
    for _ in range(2):  # the second call draws from advanced counters
        got = ps.sample_multihop(seeds, [5, 3, 2])
        want = js.sample_multihop(seeds, [5, 3, 2])
        _equal(got[:3], want[:3])
        for gb, wb in zip(got[3], want[3]):
            _equal(gb, wb)


def test_coo_to_csr_and_neighbour_num_match_jax(csr):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 300, 4000)
    dst = rng.integers(0, 300, 4000)
    _equal(pn.coo_to_csr_native(src, dst, 320),
           jn.coo_to_csr_native(src, dst, 320))
    _equal(pn.coo_to_csr_native(src, dst), jn.coo_to_csr_native(src, dst))
    indptr, indices, _ = csr
    for sizes, threads in (([4, 3], 0), ([10, 5, 2], 3)):
        got = pn.neighbour_num_native(indptr, indices, sizes,
                                      n_threads=threads, seed=9)
        want = jn.neighbour_num_native(indptr, indices, sizes,
                                       n_threads=threads, seed=9)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_library_is_the_ports_own_build():
    """The port builds its own copy, into its build directory, under a name
    that hashes the source."""
    path = pn.library_path()
    assert path.parent == pn.BUILD_DIR and path.name.startswith(
        "libquiver_cpu-")
    assert pn.SRC.parent.parent.name == "cpp"
    assert pn.SRC.parents[2].name == "quiver_tpu_torch"
    pn._get_lib()
    assert path.exists()


def test_concurrent_builds_and_source_hash(tmp_path, monkeypatch):
    """Threads building at once all load one library; an edited source
    gets a new name; a source g++ rejects raises with its message."""
    src = tmp_path / "quiver_cpu.cpp"
    src.write_bytes(pn.SRC.read_bytes())
    monkeypatch.setattr(pn, "SRC", src)
    monkeypatch.setattr(pn, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(pn._build())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        paths[0].name]
    src.write_bytes(pn.SRC.read_bytes() + b"\nthis is not C++;\n")
    assert pn.library_path() != paths[0]
    with pytest.raises(RuntimeError, match="g.. failed"):
        pn._build()
    assert not pn.library_path().exists()


def test_seed_counter_under_threads():
    """Worker threads share a sampler (the mixed sampler, the CPU lane):
    16 threads drawing seeds at once, with a short switch interval, get
    every counter value exactly once, as one thread would."""
    s = pn.CPUSampler(np.array([0, 0]), np.zeros(0, np.int32))
    got, per = [], 2_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def draw():
            mine = [s._next_seed() for _ in range(per)]
            got.extend(mine)

        threads = [threading.Thread(target=draw) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    want = [(0x5EED * 1_000_003 + c) & (2**64 - 1)
            for c in range(1, 16 * per + 1)]
    assert sorted(got) == want


def _build_native_program(name: str):
    """``g++ -O3 -std=c++17 -pthread`` of ``csrc/<name>.cpp`` against the
    port's ``quiver_cpu.cpp``, into the port's build directory."""
    import os
    import subprocess

    csrc = pn.SRC.parent
    pn.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = pn.BUILD_DIR / f"{name}-{os.getpid()}"
    proc = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-pthread", "-o", str(out),
         str(csrc / "quiver_cpu.cpp"), str(csrc / f"{name}.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


def test_native_self_test_builds_and_passes():
    """The JAX package's C++ self-test (generated graphs, sample-validity
    properties), copied into the port, passes against the port's
    source."""
    import subprocess

    exe = _build_native_program("test_quiver_cpu")
    try:
        proc = subprocess.run([str(exe)], capture_output=True, text=True,
                              timeout=300)
    finally:
        exe.unlink(missing_ok=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    jax_copy = (pn.SRC.parents[3] / "quiver_tpu" / "cpp" / "csrc"
                / "test_quiver_cpu.cpp").read_text().splitlines()
    port_copy = (pn.SRC.parent / "test_quiver_cpu.cpp").read_text() \
        .splitlines()
    # only the build comment differs from the JAX package's copy
    assert [a for a in port_copy if not a.startswith("//")] == [
        a for a in jax_copy if not a.startswith("//")]


def test_native_bench_builds_and_runs_small():
    """The C++ sampling benchmark, at a small graph (``argv``: N, E)."""
    import re
    import subprocess

    exe = _build_native_program("bench_quiver_cpu")
    try:
        proc = subprocess.run([str(exe), "20000", "200000"],
                              capture_output=True, text=True, timeout=300)
    finally:
        exe.unlink(missing_ok=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"graph: N=20000 E=\d+", proc.stdout)
    seps = re.search(r"([\d.]+)M SEPS \((\d+) edges", proc.stdout)
    assert seps and float(seps.group(1)) > 0 and int(seps.group(2)) > 0



def test_native_available_reports_without_falling_back(monkeypatch):
    """``native_available()`` says what JAX's says where the build works;
    where it does not, it answers False, and the sampler still raises
    (nothing falls back)."""
    assert pn.native_available() is True
    assert pn.native_available() == jn.native_available()

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(pn, "_get_lib", broken)
    assert pn.native_available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pn.CPUSampler(np.array([0, 1], np.int64),
                      np.array([0], np.int32)).sample_neighbors(
            np.array([0], np.int64), 1)
