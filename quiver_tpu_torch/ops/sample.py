"""Neighbour sampling (counterpart of ``quiver_tpu/ops/sample.py``).

One hop returns dense ``[B, k]`` neighbour blocks with a validity mask, as
in the JAX package.  Slot ``j`` of seed ``b`` draws uniformly from stratum
``[floor(j*deg/k), floor((j+1)*deg/k))`` with a counter-hash uniform at
counter ``b*k + j``, keyed by the folded key words ``(k0, k1)``.  The hash
is integer arithmetic and the stratum bounds are correctly rounded fp32,
so every draw equals the JAX package's ``sample_rng="hash"`` draw bit for
bit.  Under ``sample_rng="key"`` the two words are the hop key's raw data
and the uniforms are JAX's threefry ``jax.random.uniform`` of that key,
so those draws equal JAX's ``"key"`` draws too: drawn in registers by
kernel B1's keyed instance on a uniform ``"blocked[:U]"`` hop, and at
every other draw site by :func:`_uniform` (``ops/threefry.py``: one
launch of the threefry kernel a draw site on the card).
:func:`fold_key_words` folds a key into the hash's words, and
:func:`hop_key_words` gives a pipeline's per-hop words under either RNG.

The hop's element gathers follow ``gather_mode``, as in the JAX package:
``"pwindow"`` (what ``"auto"`` resolves to) is one launch of kernel B1
(``ops/cuda/window_sample.py``), the fused hop, under the hash only;
under ``"key"`` a uniform ``"blocked[:U]"`` hop (what ``"auto"`` then
resolves to) is one launch of B1's keyed instance, where JAX runs XLA's
threefry and its block gather (:func:`run_hop`); every other mode, and a
hashed ``"blocked"`` hop, computes
the uniforms and positions here and reads ``indptr`` twice and ``indices``
once through :func:`_gather`: ``"xla"`` a clipped index, ``"lanes"`` and
``"lanes_fused"`` the lane-select gather (``ops/fastgather.py``, the
latter through kernel B4), ``"pallas"`` kernel B3
(``ops/cuda/element_gather.py``), whose pair entry reads ``indptr`` at the
seeds and the seeds plus one in one launch.  All modes give the same
draws.  On the CPU every kernel runs its plain version;
:func:`sample_hop_plain`, the hop with ``"xla"`` gathers, is B1's
reference.

Under ``"blocked*"`` and ``"pwindow*"`` the scattered element reads (the
bounds from ``indptr``, the weighted sampler's totals, CDF search and
draws, and every read of a hashed ``"blocked"`` hop) go through kernel B3, the
card's fastest scattered read; JAX sends them through ``"lanes"`` and
reads a ``"blocked"`` hop's windows as whole rows
(``ops/blockgather.py``).  The values read are the same.

:func:`sample_neighbors_weighted` draws weight-proportionally, with
replacement, by inverting each row's cumulative weights
(:func:`row_cumsum_weights`).

:func:`sample_neighbors_overlay` samples a streaming graph's snapshot: a
frozen base CSR plus a delta CSR of pending inserts, a tombstone table of
deleted base edges and optional per-edge timestamps.  It draws with the
frozen hop's uniforms and stratified positions over the virtual row
``[base neighbours | delta neighbours]``, so with no deltas and no
tombstones its draws are the frozen hop's bit for bit (and so kernel B1's
under ``"pwindow"``).  There is no fused kernel for it, in either package:
under ``"pwindow"``/``"blocked"``/``"pallas"`` every read goes through
kernel B3 — both bounds pairs by its pair entry, then ``indices``,
``d_indices`` and ``tomb``, and with a window ``base_ts`` and ``d_ts``:
five launches a hop, seven windowed.  Its plain version is the same
function under ``"xla"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_sampling
from ..utils.device import resolve_device

__all__ = ["sample_neighbors", "sample_neighbors_weighted",
           "sample_neighbors_overlay", "sample_hop",
           "sample_hop_plain", "SampleOut", "to_ragged", "key_words_pair",
           "row_cumsum_weights", "fold_key_words", "hop_key_words",
           "run_hop"]


class SampleOut(NamedTuple):
    """Dense one-hop sample: ``nbrs[b, j]`` valid where ``mask[b, j]``."""

    nbrs: torch.Tensor    # [B, k] int32 global neighbour ids (-1 where ~mask)
    mask: torch.Tensor    # [B, k] bool
    counts: torch.Tensor  # [B] int32 = min(degree, k), 0 for masked seeds
    eid: Optional[torch.Tensor] = None  # [B, k] int32 edge positions (-1 pad)


# counter-hash constants: the same words as the JAX package and the CUDA
# kernel (csrc/window_sample.cu); draws match only while all three agree
HASH_PHI = 0x9E3779B9
HASH_MUL1 = 0x85EBCA6B
HASH_MUL2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in ``[0, 2**32)``.

    The multiplier is split into 16-bit halves so no partial product
    exceeds 2**48: a plain int64 ``x * c`` can pass 2**63 and wrap the
    sign before the mask is applied."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32 values held in int64 (PyTorch
    has no ``>>`` for uint32 on the CPU)."""
    x = _mul32(x ^ (x >> 16), HASH_MUL1)
    x = _mul32(x ^ (x >> 13), HASH_MUL2)
    return x ^ (x >> 16)


def _hash_uniform(k0: int, k1: int, shape, device=None) -> torch.Tensor:
    """Counter-hash uniforms in ``[0, 1)``, fp32, at counters
    ``0 .. prod(shape)-1`` in row-major order."""
    n = 1
    for s in shape:
        n *= s
    x = torch.arange(n, dtype=torch.int64, device=device) & _M32
    x = _mul32(x, HASH_PHI)
    x = _fmix32(x ^ k0)
    x = _fmix32(x ^ k1)
    # x >> 8 < 2**24 converts exactly; the scale is a power of two
    return ((x >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def fold_key_words(key) -> Tuple[int, int]:
    """The counter hash's two words from a key's raw data: JAX's
    ``_fold_key_words`` (``quiver_tpu/ops/sample.py:64-80``), a
    position-sensitive multiplicative chain over the words."""
    k0, k1 = 0, HASH_PHI
    for i, w in enumerate(np.asarray(key, dtype=np.uint32).reshape(-1)):
        w = int(w)
        k0 = (((k0 ^ w) * HASH_MUL1) + i + 1) & _M32
        k1 = (((k1 + w) * HASH_MUL2) & _M32) ^ (((i + 1) * HASH_PHI) & _M32)
    return k0, k1


def hop_key_words(keys, sample_rng: str) -> np.ndarray:
    """``[L, 2]`` uint32 words of per-hop keys ``[L, 2]`` (a ``split`` of
    the batch key): folded (:func:`fold_key_words`) under ``"hash"``, the
    keys' raw data under ``"key"``."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    if sample_rng == "key":
        return keys.copy()
    if sample_rng != "hash":
        raise ValueError(f"sample_rng must be resolved to 'hash' or 'key', "
                         f"got {sample_rng!r}")
    return np.array([fold_key_words(k) for k in keys],
                    dtype=np.uint32).reshape(-1, 2)


def _uniform(k0: int, k1: int, shape, sample_rng: str, device=None,
             plain: bool = False) -> torch.Tensor:
    """The draw sites' uniforms (JAX's ``_uniform``,
    ``quiver_tpu/ops/sample.py:113-116``): the counter hash of the folded
    words under ``"hash"``, threefry's ``jax.random.uniform`` of the raw
    key words under ``"key"`` (one kernel launch on the card; its plain
    version with ``plain``)."""
    if sample_rng == "key":
        if plain:
            from .threefry import threefry_uniform_plain

            return threefry_uniform_plain((k0, k1), shape, device)
        from .cuda.threefry import threefry_uniform

        return threefry_uniform((k0, k1), shape, device)
    return _hash_uniform(k0, k1, shape, device=device)


def _stratified_positions(u: torch.Tensor, deg: torch.Tensor,
                          k: int) -> torch.Tensor:
    """In-window draw positions ``[B, k]`` from uniforms ``u``.

    The divisor is a tensor on ``u``'s device, not a Python number: CUDA
    PyTorch turns division by a host scalar into a multiply by its
    reciprocal, which is off by one ulp often enough to move a draw."""
    j = torch.arange(k, dtype=torch.int32, device=u.device)[None, :]
    degf = deg.to(torch.float32)[:, None]
    # a fill on the device: torch.tensor would copy the value from pageable
    # host memory, which waits for the stream
    kf = torch.full((), float(k), dtype=torch.float32, device=u.device)
    lo = torch.floor(j.to(torch.float32) * degf / kf)
    hi = torch.floor((j + 1).to(torch.float32) * degf / kf)
    strat = lo + torch.floor(u * torch.clamp_min(hi - lo, 1.0))
    pos = torch.where(deg[:, None] <= k, j, strat.to(torch.int32))
    return torch.minimum(pos, torch.clamp_min(deg[:, None] - 1, 0))


def _rows_of(table: torch.Tensor, mode: str) -> torch.Tensor:
    """``table`` as ``[rows, 128]`` for the lane modes and ``"pallas"``,
    which need a 128-multiple table (``CSRTopo.to_device`` pads it)."""
    if mode not in ("lanes", "lanes_fused", "pallas"):
        raise ValueError(f"no element gather for gather_mode={mode!r}")
    if table.shape[0] % 128:
        raise ValueError(f"gather_mode={mode!r} needs a 128-multiple table, "
                         f"got {table.shape[0]}: pad with "
                         "ops.fastgather.pad_table_128")
    return table.view(-1, 128)


def _scattered(mode: str) -> str:
    """The element-gather mode of a hop's scattered reads: the window
    modes ``"blocked*"`` and ``"pwindow*"`` read them with B3."""
    return "pallas" if mode.startswith(("blocked", "pwindow")) else mode


def _gather(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """``table[idx]`` with ``idx`` clipped into the table, by element-gather
    ``mode`` (:func:`_scattered`).  Kernel B3 (``"pallas"``) and its plain
    version clamp into the table themselves; the lane modes get clamped
    ids, as JAX gives them."""
    mode = _scattered(mode)
    m = table.shape[0]
    if mode == "xla":
        return table[idx.to(torch.int64).clamp(0, m - 1)]
    t2d = _rows_of(table, mode)
    if mode == "pallas":
        from .cuda.element_gather import element_gather as b3

        return b3(t2d, idx.to(torch.int32))
    from .fastgather import element_gather

    return element_gather(t2d, idx.to(torch.int32).clamp(0, m - 1),
                          fused=(mode == "lanes_fused"))


def _gather_bounds(indptr: torch.Tensor, seeds: torch.Tensor,
                   mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indptr[seeds], indptr[seeds + 1])``, clipped into the table.
    ``"pallas"`` reads both in one launch of B3's pair entry (``seeds + 1``
    in 64 bits; JAX's int32 sum differs only for a seed of 2**31 - 1,
    which no table of node ids reaches); the other modes read twice, as
    JAX does."""
    mode = _scattered(mode)
    if mode == "pallas":
        from .cuda.element_gather import element_gather_pair

        return element_gather_pair(_rows_of(indptr, mode), seeds)
    return _gather(indptr, seeds, mode), _gather(indptr, seeds + 1, mode)


def sample_hop_plain(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, k: int, k0: int, k1: int,
                     seed_mask: Optional[torch.Tensor] = None,
                     sample_rng: str = "hash") -> SampleOut:
    """One sampling hop in plain PyTorch, on any device: the reference for
    kernel B1 under either RNG (``"xla"`` reads; under ``"key"`` the
    uniforms of ``threefry_uniform_plain``, no kernel)."""
    return sample_hop(indptr, indices, seeds, k, k0, k1, seed_mask, "xla",
                      sample_rng, plain=True)


def sample_hop(indptr: torch.Tensor, indices: torch.Tensor,
               seeds: torch.Tensor, k: int, k0: int, k1: int,
               seed_mask: Optional[torch.Tensor] = None,
               gather_mode: str = "xla",
               sample_rng: str = "hash", *, plain: bool = False) -> SampleOut:
    """One sampling hop (``ops/sample.py:208-273`` of the JAX package)
    whose element gathers run by ``gather_mode``: the seeds' bounds
    (:func:`_gather_bounds`, one launch under ``"pallas"``, two reads
    otherwise) and the draws (:func:`_gather`).  The uniforms follow the
    resolved ``sample_rng`` (:func:`_uniform`; ``plain`` draws threefry
    by its plain version, as :func:`sample_hop_plain` does).

    Reads of ``indptr``/``indices`` are clipped to the (padded) tables,
    as the JAX gathers clip."""
    seeds = seeds.to(torch.int32)
    start, end = _gather_bounds(indptr, seeds, gather_mode)
    deg = end - start
    if seed_mask is not None:
        deg = torch.where(seed_mask, deg, torch.zeros_like(deg))
    counts = torch.clamp_max(deg, k).to(torch.int32)
    j = torch.arange(k, dtype=torch.int32, device=seeds.device)[None, :]
    u = _uniform(k0, k1, (seeds.shape[0], k), sample_rng, seeds.device,
                 plain)
    pos = _stratified_positions(u, deg, k)
    mask = j < counts[:, None]
    idx = start[:, None] + pos
    nbrs = _gather(indices, idx, gather_mode)
    neg = torch.full_like(idx, -1)
    return SampleOut(nbrs=torch.where(mask, nbrs, neg), mask=mask,
                     counts=counts, eid=torch.where(mask, idx, neg))


def sample_neighbors_overlay(indptr: torch.Tensor, indices: torch.Tensor,
                             tomb: torch.Tensor, d_indptr: torch.Tensor,
                             d_indices: torch.Tensor, seeds: torch.Tensor,
                             k: int, k0: int, k1: int,
                             seed_mask: Optional[torch.Tensor] = None,
                             base_ts: Optional[torch.Tensor] = None,
                             d_ts: Optional[torch.Tensor] = None,
                             window: Optional[Tuple[int, int]] = None,
                             gather_mode: str = "xla",
                             sample_rng: str = "hash") -> SampleOut:
    """One hop over a base CSR **plus a delta-CSR overlay**
    (``ops/sample.py:276-377`` of the JAX package), on tensors already on
    one device, in a resolved ``gather_mode``.

    A seed's degree is ``base_deg + delta_deg``; the stratified positions
    index the virtual concatenation ``[base | delta]`` with the frozen
    hop's math (:func:`_uniform` under the resolved ``sample_rng``,
    :func:`_stratified_positions`), so with zero deltas and no tombstones
    the draws equal the frozen path's.
    Deletions and the window reject, they do not resample: a draw on a
    tombstoned base edge (``tomb[pos] != 0``) or with a timestamp outside
    ``window = (lo, hi)``, ``lo <= ts < hi``, is masked out, so ``counts``
    may fall below ``min(deg, k)`` until a fold.  Both sides of each
    select are read (clipped into their tables), as JAX reads them.  A
    delta draw's ``eid`` is ``indices.shape[0] + delta_pos``.

    ``window`` holds Python ints, compared as kernel arguments: nothing is
    copied to the device per call.  ``base_ts``/``d_ts`` are required with
    a window."""
    seeds = seeds.to(torch.int32)
    start, end = _gather_bounds(indptr, seeds, gather_mode)
    bdeg = end - start
    dstart, dend = _gather_bounds(d_indptr, seeds, gather_mode)
    ddeg = dend - dstart
    if seed_mask is not None:
        zero = torch.zeros_like(bdeg)
        bdeg = torch.where(seed_mask, bdeg, zero)
        ddeg = torch.where(seed_mask, ddeg, zero)
    deg = bdeg + ddeg
    j = torch.arange(k, dtype=torch.int32, device=seeds.device)[None, :]
    u = _uniform(k0, k1, (seeds.shape[0], k), sample_rng, seeds.device)
    pos = _stratified_positions(u, deg, k)
    # position < base_deg draws from the base segment, the rest from the
    # delta segment; both indices are clipped so the untaken side of each
    # select still reads in bounds
    bd = bdeg[:, None]
    in_base = pos < bd
    bidx = start[:, None] + torch.minimum(pos, torch.clamp_min(bd - 1, 0))
    didx = dstart[:, None] + torch.clamp_min(pos - bd, 0)
    nbrs = torch.where(in_base, _gather(indices, bidx, gather_mode),
                       _gather(d_indices, didx, gather_mode))
    live = ~in_base | (_gather(tomb, bidx, gather_mode) == 0)
    if window is not None:
        lo, hi = window
        ets = torch.where(in_base, _gather(base_ts, bidx, gather_mode),
                          _gather(d_ts, didx, gather_mode))
        live = live & (ets >= int(lo)) & (ets < int(hi))
    mask = (j < torch.clamp_max(deg, k)[:, None]) & live
    counts = mask.sum(dim=1, dtype=torch.int32)
    neg = torch.full_like(bidx, -1)
    eid = torch.where(in_base, bidx, didx + int(indices.shape[0]))
    return SampleOut(nbrs=torch.where(mask, nbrs, neg), mask=mask,
                     counts=counts, eid=torch.where(mask, eid, neg))


def _cdf_search(cum_weights: torch.Tensor, start: torch.Tensor,
                end: torch.Tensor, u: torch.Tensor, bits: int,
                mode: str) -> torch.Tensor:
    """The first position ``p`` in ``[start, end)`` with
    ``cum_weights[p] > u``, by a ``bits``-round binary search of element
    gathers by ``mode``, clipped to ``[start, max(end - 1, 0)]``."""
    lo = start[:, None].expand(u.shape)
    hi = end[:, None].expand(u.shape)
    for _ in range(bits):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        gt = _gather(cum_weights, mid, mode) > u
        lo, hi = torch.where(gt, lo, mid + 1), torch.where(gt, mid, hi)
    return torch.minimum(torch.maximum(lo, start[:, None]),
                         torch.clamp_min(end[:, None] - 1, 0))


def sample_neighbors_weighted(indptr: torch.Tensor, indices: torch.Tensor,
                              cum_weights: torch.Tensor, seeds: torch.Tensor,
                              k: int, key_words,
                              seed_mask: Optional[torch.Tensor] = None,
                              gather_mode: str = "xla",
                              bits: int = 24,
                              sample_rng: str = "auto") -> SampleOut:
    """Weight-proportional neighbour sampling, with replacement
    (``ops/sample.py:382-469`` of the JAX package; the reference's
    ``weight_sample``), on tensors already on one device.

    ``cum_weights`` is the 128-padded per-row inclusive cumulative weight
    (:func:`row_cumsum_weights`).  Each draw ``u * total`` inverts its
    row's CDF by a ``bits``-round binary search of element gathers by
    ``gather_mode`` (``config.resolve_gather_mode``; ``"pwindow"`` and
    ``"blocked"`` read through B3 here).  JAX's ``"blocked"`` count over
    the CDF block finds the same positions.
    ``deg <= k`` rows return every neighbour once, in CSR order, as the
    uniform hop does.  ``key_words`` are the hop's two words: folded under
    ``sample_rng="hash"``, the hop key's raw data under ``"key"``
    (``config.resolve_sample_rng``)."""
    k0, k1 = key_words_pair(key_words)
    gather_mode, sample_rng = resolve_sampling(gather_mode, sample_rng)
    seeds = seeds.to(torch.int32)
    B = seeds.shape[0]
    start, end = _gather_bounds(indptr, seeds, gather_mode)
    deg = end - start
    if seed_mask is not None:
        deg = torch.where(seed_mask, deg, torch.zeros_like(deg))
    counts = torch.clamp_max(deg, k).to(torch.int32)
    j = torch.arange(k, dtype=torch.int32, device=seeds.device)[None, :]
    mask = j < counts[:, None]
    # the row total is the last entry of its inclusive cumulative weights
    last = _gather(cum_weights, torch.clamp_min(end - 1, 0), gather_mode)
    total = torch.where(deg > 0, last, torch.zeros_like(last))
    u = _uniform(k0, k1, (B, k), sample_rng, seeds.device) * total[:, None]
    pos = _cdf_search(cum_weights, start, end, u, bits, gather_mode)
    pos = torch.where(deg[:, None] <= k, start[:, None] + j, pos)
    nbrs = _gather(indices, torch.where(mask, pos, torch.zeros_like(pos)),
                   gather_mode)
    neg = torch.full_like(pos, -1)
    return SampleOut(nbrs=torch.where(mask, nbrs, neg), mask=mask,
                     counts=counts, eid=torch.where(mask, pos, neg))


def row_cumsum_weights(indptr, weights) -> np.ndarray:
    """Per-row inclusive cumulative weights, fp32, on the host, for
    :func:`sample_neighbors_weighted` (once per graph).  The running sum
    is float64: a float32 cumsum over 1e8 edges has an ulp above a
    typical weight, so late rows would lose their relative weights."""
    indptr = np.asarray(indptr)
    cw = np.cumsum(np.asarray(weights, dtype=np.float64))
    prev = np.concatenate([[0.0], cw])[indptr[:-1]]
    return (cw - np.repeat(prev, np.diff(indptr))).astype(np.float32)


def key_words_pair(key_words) -> Tuple[int, int]:
    """``(k0, k1)`` as Python ints from any two-word uint32 container."""
    w = np.asarray(key_words, dtype=np.uint32).reshape(-1)
    if w.shape[0] != 2:
        raise ValueError(f"need two uint32 key words, got {w.shape[0]}")
    return int(w[0]), int(w[1])


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, k: int, key_words,
                     seed_mask: Optional[torch.Tensor] = None,
                     device=None, gather_mode: str = "auto",
                     sample_rng: str = "auto") -> SampleOut:
    """Sample up to ``k`` distinct neighbours per seed from a CSR graph.

    Args:
      indptr / indices: int32 CSR tables, 128-padded
        (:meth:`CSRTopo.to_device`).
      seeds: ``[B]`` node ids; where ``seed_mask`` is False a seed counts
        as degree 0.
      k: fanout.
      key_words: two uint32 words ``(k0, k1)``: the folded words under
        ``"hash"``, the hop key's raw data under ``"key"``.
      device: where the hop runs (``None``: the card).
      gather_mode: element-gather mode (``config.resolve_gather_mode``;
        ``"auto"`` is ``"pwindow"``, or ``"blocked"`` under ``"key"``):
        ``"pwindow[:U]"`` is kernel B1, and so is ``"blocked[:U]"`` under
        ``"key"``; any other mode element gathers (two under
        ``"pallas"``, three otherwise); the draws are the same.
      sample_rng: ``"hash"``, ``"key"`` or ``"auto"``
        (``config.resolve_sample_rng``); ``"key"`` with ``"pwindow"``
        raises.

    ``deg <= k`` returns every neighbour in CSR order; ``deg > k`` returns
    k distinct neighbours, one per stratum.
    """
    dev = resolve_device(device)
    k0, k1 = key_words_pair(key_words)
    if seed_mask is not None:
        seed_mask = seed_mask.to(dev)
    gm, sample_rng = resolve_sampling(gather_mode, sample_rng)
    return run_hop(indptr.to(dev), indices.to(dev),
                   seeds.to(dev, torch.int32), k, k0, k1, seed_mask, gm,
                   sample_rng)


def run_hop(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
            k: int, k0: int, k1: int, seed_mask: Optional[torch.Tensor],
            gather_mode: str, sample_rng: str) -> SampleOut:
    """One hop on tensors already on one device, in a gather mode and RNG
    that :func:`config.resolve_sampling` has resolved.  Kernel B1 draws in
    registers: ``"pwindow[:U]"`` launches its hash instance (with
    ``"key"`` it raises, as JAX's op does,
    ``quiver_tpu/ops/sample.py:243-248``), and ``"blocked[:U]"`` under
    ``"key"`` its threefry instance, the same draws as JAX's keyed
    ``"blocked"`` hop (XLA's threefry, then its block gather).  Any other
    mode, and ``"blocked"`` under the hash, runs :func:`sample_hop`."""
    if gather_mode.startswith("pwindow"):
        if sample_rng != "hash":
            raise ValueError(
                "gather_mode='pwindow' fuses the counter-hash RNG in-kernel "
                "and requires sample_rng='hash' (the accelerator default); "
                f"got sample_rng={sample_rng!r}")
        from .cuda.window_sample import window_sample

        return window_sample(indptr, indices, seeds, k, k0, k1, seed_mask)
    if sample_rng == "key" and gather_mode.startswith("blocked"):
        from .cuda.window_sample import window_sample

        return window_sample(indptr, indices, seeds, k, k0, k1, seed_mask,
                             "key")
    return sample_hop(indptr, indices, seeds, k, k0, k1, seed_mask,
                      gather_mode, sample_rng)


def to_ragged(out: SampleOut) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[B, k]`` -> (flat neighbours, counts): neighbours of seed b
    occupy ``flat[offset[b] : offset[b] + counts[b]]``."""
    return out.nbrs[out.mask], out.counts
