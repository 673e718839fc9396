"""Neighbour sampling (counterpart of ``quiver_tpu/ops/sample.py``).

One hop returns dense ``[B, k]`` neighbour blocks with a validity mask, as
in the JAX package.  Slot ``j`` of seed ``b`` draws uniformly from stratum
``[floor(j*deg/k), floor((j+1)*deg/k))`` with a counter-hash uniform at
counter ``b*k + j``, keyed by the folded key words ``(k0, k1)``.  The hash
is integer arithmetic and the stratum bounds are correctly rounded fp32,
so every draw equals the JAX package's ``sample_rng="hash"`` draw bit for
bit.  The port has this one RNG; JAX's threefry ``sample_rng="key"`` has
no counterpart.

The hop's element gathers follow ``gather_mode``, as in the JAX package:
``"pwindow"`` (what ``"auto"`` resolves to) is one launch of kernel B1
(``ops/cuda/window_sample.py``), the fused hop; every other mode computes
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
draws, and every read of a ``"blocked"`` hop) go through kernel B3, the
card's fastest scattered read; JAX sends them through ``"lanes"`` and
reads a ``"blocked"`` hop's windows as whole rows
(``ops/blockgather.py``).  The values read are the same.

:func:`sample_neighbors_weighted` draws weight-proportionally, with
replacement, by inverting each row's cumulative weights
(:func:`row_cumsum_weights`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_gather_mode
from ..utils.device import resolve_device

__all__ = ["sample_neighbors", "sample_neighbors_weighted", "sample_hop",
           "sample_hop_plain", "SampleOut", "to_ragged", "key_words_pair",
           "row_cumsum_weights"]


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
                     seed_mask: Optional[torch.Tensor] = None) -> SampleOut:
    """One sampling hop in plain PyTorch: the reference for kernel B1."""
    return sample_hop(indptr, indices, seeds, k, k0, k1, seed_mask, "xla")


def sample_hop(indptr: torch.Tensor, indices: torch.Tensor,
               seeds: torch.Tensor, k: int, k0: int, k1: int,
               seed_mask: Optional[torch.Tensor] = None,
               gather_mode: str = "xla") -> SampleOut:
    """One sampling hop (``ops/sample.py:208-273`` of the JAX package)
    whose element gathers run by ``gather_mode``: the seeds' bounds
    (:func:`_gather_bounds`, one launch under ``"pallas"``, two reads
    otherwise) and the draws (:func:`_gather`).

    Reads of ``indptr``/``indices`` are clipped to the (padded) tables,
    as the JAX gathers clip."""
    seeds = seeds.to(torch.int32)
    start, end = _gather_bounds(indptr, seeds, gather_mode)
    deg = end - start
    if seed_mask is not None:
        deg = torch.where(seed_mask, deg, torch.zeros_like(deg))
    counts = torch.clamp_max(deg, k).to(torch.int32)
    j = torch.arange(k, dtype=torch.int32, device=seeds.device)[None, :]
    u = _hash_uniform(k0, k1, (seeds.shape[0], k), device=seeds.device)
    pos = _stratified_positions(u, deg, k)
    mask = j < counts[:, None]
    idx = start[:, None] + pos
    nbrs = _gather(indices, idx, gather_mode)
    neg = torch.full_like(idx, -1)
    return SampleOut(nbrs=torch.where(mask, nbrs, neg), mask=mask,
                     counts=counts, eid=torch.where(mask, idx, neg))


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
                              bits: int = 24) -> SampleOut:
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
    uniform hop does.  ``key_words`` are the hop's two folded words."""
    k0, k1 = key_words_pair(key_words)
    gather_mode = resolve_gather_mode(gather_mode)
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
    u = _hash_uniform(k0, k1, (B, k), device=seeds.device) * total[:, None]
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
                     device=None, gather_mode: str = "auto") -> SampleOut:
    """Sample up to ``k`` distinct neighbours per seed from a CSR graph.

    Args:
      indptr / indices: int32 CSR tables, 128-padded
        (:meth:`CSRTopo.to_device`).
      seeds: ``[B]`` node ids; where ``seed_mask`` is False a seed counts
        as degree 0.
      k: fanout.
      key_words: the two folded uint32 key words ``(k0, k1)``.
      device: where the hop runs (``None``: the card).
      gather_mode: element-gather mode (``config.resolve_gather_mode``;
        ``"auto"`` is ``"pwindow"``): ``"pwindow[:U]"`` is kernel B1, any
        other mode element gathers (two under ``"pallas"``, three
        otherwise); the draws are the same.

    ``deg <= k`` returns every neighbour in CSR order; ``deg > k`` returns
    k distinct neighbours, one per stratum.
    """
    dev = resolve_device(device)
    k0, k1 = key_words_pair(key_words)
    if seed_mask is not None:
        seed_mask = seed_mask.to(dev)
    return run_hop(indptr.to(dev), indices.to(dev),
                   seeds.to(dev, torch.int32), k, k0, k1, seed_mask,
                   resolve_gather_mode(gather_mode))


def run_hop(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
            k: int, k0: int, k1: int, seed_mask: Optional[torch.Tensor],
            gather_mode: str) -> SampleOut:
    """One hop on tensors already on one device, in a gather mode that
    :func:`resolve_gather_mode` has resolved: ``"pwindow[:U]"`` launches
    kernel B1, any other mode runs :func:`sample_hop`."""
    if gather_mode.startswith("pwindow"):
        from .cuda.window_sample import window_sample

        return window_sample(indptr, indices, seeds, k, k0, k1, seed_mask)
    return sample_hop(indptr, indices, seeds, k, k0, k1, seed_mask,
                      gather_mode)


def to_ragged(out: SampleOut) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[B, k]`` -> (flat neighbours, counts): neighbours of seed b
    occupy ``flat[offset[b] : offset[b] + counts[b]]``."""
    return out.nbrs[out.mask], out.counts
