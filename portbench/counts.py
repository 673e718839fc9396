"""The yardstick's arithmetic: the operations and bytes that the work of
a step or a pass needs, from its sampled shapes, and the card's peaks.

Counts are of what the algorithm needs from these inputs, not of what an
implementation reads: live targets and valid edges only (a dense block's
masked slots and dead targets are padding), each input byte read once and
each output byte written once.  Elementwise work (bias, ReLU, dropout,
the mean's divisions, the loss, Adam) is left out of the FLOP counts, so
a share of a peak computed from them is never too high.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

SECTOR = 32  # bytes the card fetches at a time from HBM

# Published dense peaks of one card (NVIDIA's data sheet), keyed by the
# name torch.cuda.get_device_name() gives.  fp32 is outside the tensor
# cores, the precision the port's steps compute in.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}")
    return PEAKS[device_name]


def sage_flops(layer_shapes: Sequence[Dict[str, int]], backward: bool
               ) -> int:
    """Matmul and aggregation FLOPs of GraphSAGE over sampled blocks.

    ``layer_shapes`` holds one dict a layer, outermost first, with ``live``
    (targets that are valid), ``edges`` (valid slots), ``d_in`` and
    ``d_out``.  Forward: two ``live x d_in x d_out`` products (self and
    neighbour halves) at 2 FLOPs a multiply-add, and ``edges x d_in`` adds
    for the mean.  Backward: the weight gradients of both products in
    every layer, and the input gradients (both products and the mean's
    scatter) in every layer but the first, whose input is data."""
    total = 0
    for i, s in enumerate(layer_shapes):
        mm = 2 * 2 * s["live"] * s["d_in"] * s["d_out"]
        agg = s["edges"] * s["d_in"]
        total += mm + agg
        if backward:
            total += mm
            if i > 0:
                total += mm + agg
    return total


def layer_shapes(hops, dims: Sequence[int]):
    """Per-layer shapes (outermost first) from reference hops (innermost
    first, each with ``live`` and ``mask``) and the model's widths
    ``[in, hidden..., out]``."""
    out = []
    for i, h in enumerate(reversed(hops)):
        out.append(dict(live=int(h.live.sum()), edges=int(h.mask.sum()),
                        d_in=dims[i], d_out=dims[i + 1]))
    return out


def sector_bytes(*positions: torch.Tensor) -> int:
    """Bytes of the distinct 32-byte sectors of a 4-byte-element table
    that the element ``positions`` touch together: the least a gather of
    them reads, each sector once however often it is hit."""
    pos = torch.cat([p.reshape(-1).to(torch.int64) for p in positions])
    return int(torch.unique(pos >> 3).numel()) * SECTOR


def b1_hop_bytes(indptr_positions_live: torch.Tensor, eid_valid: torch.Tensor
                 ) -> int:
    """Bytes kernel B1's pipeline entry needs for one hop: each live
    target and its mask read and its count written (4 + 1 + 4); the
    distinct sectors of ``indptr`` the live targets' two words touch and
    of ``indices`` the valid draws touch; each valid slot's id, mask and
    local id written (4 + 1 + 4).  Dead targets and masked slots are
    padding and stay out."""
    live = indptr_positions_live.to(torch.int64)
    return (live.numel() * (4 + 1 + 4) + sector_bytes(live, live + 1)
            + sector_bytes(eid_valid) + eid_valid.numel() * (4 + 1 + 4))


def b1_step_bytes(hops, n_id: torch.Tensor) -> int:
    """B1's bytes over the hops of one positional pipeline: ``hops`` from
    the reference sampler, whose hop over ``t`` targets reads
    ``n_id[:t]``."""
    return sum(b1_hop_bytes(n_id[:h.t][h.live], h.eid[h.mask]) for h in hops)


def b2_bytes(ids: torch.Tensor, row_bytes: int, ordered: bool) -> int:
    """Bytes kernel B2 needs to gather the live ``ids`` (a batch's masked
    entries are padding, their rows unread downstream, and are left out
    by the caller): the ids read, each distinct row read once (and its
    entry of the row order, where the feature has one), every output row
    written once."""
    m = ids.numel()
    distinct = int(torch.unique(ids).numel())
    return (m * ids.element_size() + (distinct * 4 if ordered else 0)
            + distinct * row_bytes + m * row_bytes)
