"""ctypes loader for the native host sampler (``csrc/quiver_cpu.cpp``),
counterpart of ``quiver_tpu/cpp/native.py``.

The source is the JAX package's C++ file, copied byte for byte into this
package.  It is compiled at first use with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``build/quiver_tpu_torch/libquiver_cpu-<hash>.so``
beside the package (the hash covers the flags and the source, so an edited
source is never served from a stale library) and loaded with ``ctypes``,
which releases the GIL for the length of each call.  Concurrent builds
(several test workers, several threads) each compile to a temporary name
and ``os.replace`` it into place.

There is no fallback: when ``g++`` fails the call raises with the
compiler's message.  (The JAX package falls back to numpy loops with
another RNG, which draw other neighbours.)

Every draw is a function of ``(rng_seed, row b)`` only
(``Rng(rng_seed * 0x2545F4914F6CDD1D + b)``), so results do not depend on
``n_threads``.  :class:`CPUSampler` derives a call's ``rng_seed`` from its
own counter exactly as the JAX package does, so the same sequence of calls
draws the same neighbours in both packages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.cuda.build import BUILD_DIR
from ..ops.sample import row_cumsum_weights

__all__ = ["CPUSampler", "coo_to_csr_native", "neighbour_num_native",
           "library_path", "SRC", "GXX_FLAGS"]

SRC = Path(__file__).resolve().parent / "csrc" / "quiver_cpu.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SRC.read_bytes())
    return BUILD_DIR / f"libquiver_cpu-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native sampler failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on {SRC.name} (rc {proc.returncode}):\n"
            + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        vp, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                             ctypes.c_uint64)
        lib.qt_sample.argtypes = [i64p, i32p, i32p, vp, i64, i32, u64, i32,
                                  i32p, u8p, i32p]
        lib.qt_sample.restype = None
        lib.qt_sample_weighted.argtypes = [i64p, i32p, f32p, i32p, vp, i64,
                                           i32, u64, i32, i32p, u8p, i32p]
        lib.qt_sample_weighted.restype = None
        lib.qt_reindex.argtypes = [i32p, vp, i64, i32p, u8p, i32, i32p, u8p,
                                   i32p]
        lib.qt_reindex.restype = ctypes.c_int64
        lib.qt_coo_to_csr.argtypes = [i64p, i64p, i64, i64, i64p, i32p, vp]
        lib.qt_coo_to_csr.restype = None
        lib.qt_neighbour_num.argtypes = [i64p, i32p, i64, i32p, i32, u64, i32,
                                         i64p]
        lib.qt_neighbour_num.restype = None
        _lib = lib
        return lib


def _u8_ptr(mask: Optional[np.ndarray]):
    return None if mask is None else mask.ctypes.data_as(ctypes.c_void_p)


class CPUSampler:
    """Host sampler with the device sampler's dense-block contract:
    ``[B, k]`` neighbours (-1 where masked), a mask and ``min(deg, k)``
    counts.  Unweighted rows of degree above ``k`` take ``k`` distinct
    neighbours (a reservoir); with ``edge_weights`` they draw ``k`` with
    replacement, weight-proportionally."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 n_threads: int = 0, seed: int = 0x5EED,
                 edge_weights: Optional[np.ndarray] = None):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.n_threads = n_threads
        self._seed = seed
        self._ctr = 0
        self._ctr_lock = threading.Lock()  # worker threads share a sampler
        self.cum_weights = None
        if edge_weights is not None:
            self.cum_weights = np.ascontiguousarray(
                row_cumsum_weights(self.indptr, edge_weights),
                dtype=np.float32)

    def _next_seed(self) -> int:
        with self._ctr_lock:
            self._ctr += 1
            ctr = self._ctr
        return (self._seed * 1_000_003 + ctr) & (2**64 - 1)

    def sample_neighbors(self, seeds: np.ndarray, k: int,
                         seed_mask: Optional[np.ndarray] = None,
                         seed: Optional[int] = None):
        """One hop from ``seeds``; rows where ``seed_mask`` is False are
        empty.  ``seed`` replaces the counter-derived RNG seed (the UVA
        cold tier passes one per hop).  Returns ``(nbrs, mask bool,
        counts)``."""
        lib = _get_lib()
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        B = len(seeds)
        nbrs = np.empty((B, k), dtype=np.int32)
        mask = np.empty((B, k), dtype=np.uint8)
        counts = np.empty(B, dtype=np.int32)
        sm = (None if seed_mask is None
              else np.ascontiguousarray(seed_mask, dtype=np.uint8))
        rng_seed = seed if seed is not None else self._next_seed()
        if self.cum_weights is not None:
            lib.qt_sample_weighted(self.indptr, self.indices,
                                   self.cum_weights, seeds, _u8_ptr(sm), B, k,
                                   rng_seed, self.n_threads,
                                   nbrs.reshape(-1), mask.reshape(-1), counts)
        else:
            lib.qt_sample(self.indptr, self.indices, seeds, _u8_ptr(sm), B, k,
                          rng_seed, self.n_threads, nbrs.reshape(-1),
                          mask.reshape(-1), counts)
        return nbrs, mask.astype(bool), counts

    def reindex(self, seeds: np.ndarray, nbrs: np.ndarray, mask: np.ndarray,
                seed_mask: Optional[np.ndarray] = None):
        """Dedup and relabel: ``n_id`` holds the valid seeds in their
        slots, then the other neighbours in ascending id order, padded to
        ``B + B*k``.  Returns ``(n_id, n_id_mask, num_nodes, local)``."""
        lib = _get_lib()
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        B, k = nbrs.shape
        nbrs = np.ascontiguousarray(nbrs, dtype=np.int32)
        m8 = np.ascontiguousarray(mask, dtype=np.uint8)
        sm = (None if seed_mask is None
              else np.ascontiguousarray(seed_mask, dtype=np.uint8))
        n_id = np.zeros(B + B * k, dtype=np.int32)
        n_id_mask = np.zeros(B + B * k, dtype=np.uint8)
        local = np.zeros((B, k), dtype=np.int32)
        num = lib.qt_reindex(seeds, _u8_ptr(sm), B, nbrs.reshape(-1),
                             m8.reshape(-1), k, n_id, n_id_mask,
                             local.reshape(-1))
        return n_id, n_id_mask.astype(bool), int(num), local

    def sample_multihop(self, seeds: np.ndarray, sizes: Sequence[int]):
        """Hops of fanouts ``sizes`` with exact dedup after each.  Returns
        ``(n_id, n_id_mask, num_nodes, blocks)``, blocks outermost first,
        each ``(local, mask, num_targets)``."""
        frontier = np.asarray(seeds, dtype=np.int32)
        fmask = np.ones(len(frontier), dtype=np.uint8)
        blocks: List[Tuple[np.ndarray, np.ndarray, int]] = []
        num_nodes = len(frontier)
        for k in sizes:
            nbrs, mask, _ = self.sample_neighbors(frontier, k, fmask)
            n_id, n_mask, num_nodes, local = self.reindex(frontier, nbrs,
                                                          mask, fmask)
            blocks.append((local, mask, int(fmask.sum())))
            frontier, fmask = n_id, n_mask.astype(np.uint8)
        return frontier, fmask.astype(bool), num_nodes, blocks[::-1]


def coo_to_csr_native(src, dst, node_count=None):
    """COO -> CSR ``(indptr, indices, eid)`` by a counting sort on the
    host; each row keeps its edges in input order."""
    lib = _get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if node_count is None:
        node_count = int(max(src.max(), dst.max())) + 1 if len(src) else 0
    indptr = np.zeros(node_count + 1, dtype=np.int64)
    indices = np.empty(len(src), dtype=np.int32)
    eid = np.empty(len(src), dtype=np.int64)
    lib.qt_coo_to_csr(src, dst, len(src), node_count, indptr, indices,
                      eid.ctypes.data_as(ctypes.c_void_p))
    return indptr, indices, eid


def neighbour_num_native(indptr, indices, sizes, n_threads=0, seed=7):
    """``[N]`` int64: each node's sampled neighbourhood size over the
    fanouts ``sizes`` (one sample a node, with replacement)."""
    lib = _get_lib()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = len(indptr) - 1
    out = np.zeros(n, dtype=np.int64)
    sz = np.ascontiguousarray(sizes, dtype=np.int32)
    lib.qt_neighbour_num(indptr, indices, n, sz, len(sz), seed, n_threads,
                         out)
    return out
