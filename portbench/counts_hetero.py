"""The yardstick's arithmetic for R-GAT over a hetero batch of the
reference sampler (``reference/hetero_sampler.py``): model FLOPs a step,
and B1's bytes a block and B2's a type by ``counts.py``'s rules.

FLOPs count live rows and valid slots (``live=True``), or every row and
slot of the padded frontiers (``live=False``, the work the dense blocks
compute), at 2 FLOPs a multiply-add:

- each type's projection over its frontier rows (``2 * d_in * hidden`` a
  row);
- at each layer, each block's ``w_src`` over the rows of its SRC type
  that the layer reads and its ``w_dst`` over its targets, and each
  target type's self transform over its targets (``2 * hidden**2`` a row
  each);
- each block's scores, ``<n, att_src>`` a slot and ``<b, att_dst>`` a
  target, and its ``alpha``-weighted sum a slot (``2 * hidden`` each);
- the classifier over the seeds (``2 * hidden * classes`` a seed).

Backward: every product's weight gradient, and its input gradient where
the input takes one, which is everywhere but the projections (their
input is data), so twice the forward but once for the projections; each
attention product's two gradients, one a multiply and one a multiply-add
an element, 1.5 times its forward.  Softmax, activations, dropout,
biases, the loss and Adam are left out, as ``counts.py`` leaves SAGE's
elementwise work out, so a share of a peak computed from the live count
is never too high.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import counts


def _rows(mask: torch.Tensor, n: int, live: bool) -> int:
    return int(mask[:n].sum()) if live else n


def rgat_flops(smp, d_in: Dict[str, int], hidden: int, classes: int,
               backward: bool, live: bool = True) -> int:
    """R-GAT's FLOPs over ``smp`` (a ``HeteroSampled``)."""
    fwd = bwd = 0
    n_rows = {t: int(m.numel()) for t, m in smp.n_mask.items()}
    for t, n in n_rows.items():
        mm = 2 * _rows(smp.n_mask[t], n, live) * d_in[t] * hidden
        fwd += mm
        bwd += mm
    for blocks in reversed(smp.hops):  # outermost layer first
        targets: Dict[str, int] = {}
        for b in blocks:
            s_t, _, d_t = b.relation
            targets[d_t] = max(targets.get(d_t, 0), b.hop.t)
            src = 2 * _rows(smp.n_mask[s_t], n_rows[s_t], live) * hidden ** 2
            t_live = int(b.hop.live.sum()) if live else b.hop.t
            slots = int(b.hop.mask.sum()) if live else b.hop.t * b.hop.k
            dst = 2 * t_live * hidden ** 2
            att = 2 * hidden * (2 * slots + t_live)
            fwd += src + dst + att
            bwd += 2 * (src + dst) + 3 * att // 2
        for d_t, n in targets.items():
            mm = 2 * _rows(smp.n_mask[d_t], n, live) * hidden ** 2
            fwd += mm
            bwd += 2 * mm
        n_rows.update(targets)
    head = 2 * smp.batch_size * hidden * classes
    fwd += head
    bwd += 2 * head
    return fwd + (bwd if backward else 0)


def b1_bytes(smp) -> int:
    """B1's literal entry over every block: ``counts.b1_hop_bytes`` of the
    block's live targets and valid draws."""
    total = 0
    for blocks in smp.hops:
        for b in blocks:
            ids = smp.n_id[b.relation[2]][:b.hop.t]
            total += counts.b1_hop_bytes(ids[b.hop.live],
                                         b.hop.eid[b.hop.mask])
    return total


def b2_bytes(smp, row_bytes: int) -> int:
    """B2 once a type over its live ids (no row order: each type's table
    is in id order): ``counts.b2_bytes``."""
    return sum(counts.b2_bytes(ids[smp.n_mask[t]], row_bytes, ordered=False)
               for t, ids in smp.n_id.items() if ids.numel())
