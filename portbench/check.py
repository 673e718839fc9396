"""The comparisons that decide ``correct``: the readings of what the
timed path produced against the plain reference, worked out after the
window has closed.

Each function returns readings by name; the run holds each against the
cell's limit of that name (``limits/<cell>.json``).  The same functions
read the control (the reference in the program's place at TF32) and the
planted fault in ``calibrate.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import sage as ref_sage
from .reference import sampler as ref_sampler

DIGEST_SEED = 20240521
# leaves whose reference gradient is under this share of the median
# leaf's are nought to rounding (as a bias under a softmax): left out
GRAD_FLOOR = 1e-3


def row_digest(rows: torch.Tensor) -> torch.Tensor:
    """``[M]`` int64: each row's bits (as int32 words) weighted by fixed
    factors below 2**20 and summed; exact and order-free, so two rows
    agree only where their bits do (up to a collision)."""
    bits = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    g = torch.Generator(device=rows.device).manual_seed(DIGEST_SEED)
    w = torch.randint(1, 2**20, (rows.shape[1],), generator=g,
                      dtype=torch.int64, device=rows.device)
    return (bits * w).sum(1)


def ids_off(prog: dict, ref: ref_sampler.Sampled) -> int:
    """Entries of ``n_id``, its mask and each block's local ids and mask
    where the program's batch differs from the reference's."""
    off = int((prog["n_id"] != ref.n_id).sum())
    off += int((prog["n_mask"] != ref.n_mask).sum())
    for (nl, m), h in zip(prog["blocks"], reversed(ref.hops)):
        if nl.shape != h.nbr_local.shape:
            return max(off, 1) + nl.numel()
        off += int((nl != h.nbr_local).sum()) + int((m != h.mask).sum())
    return off


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]):
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's; and that leaf's name."""
    med = float(np.median([ref[n] for n in keep]))
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def reference_train(inp, cfg: dict, feeds, dropout_seed: int, device,
                    tf32: bool = False, fault: Optional[str] = None) -> dict:
    """The reference over the check steps' feeds ``(seeds, labels,
    key_words)``: each step's batch, rows' digests and loss, the first
    step's gradients and the parameters after the last.  ``tf32`` rounds
    the matmuls' inputs to TF32 (the control); ``fault="half"`` takes the
    loss over the first half of each batch only."""
    fan = cfg["sampling"]["fanouts"]
    layers, hidden = cfg["model"]["layers"], cfg["model"]["hidden"]
    p_drop = cfg["model"]["dropout"]
    params = {n: w.clone() for n, w in inp.weights.items()}
    opt = ref_sage.Adam(params, cfg["optimizer"]["lr"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    out = dict(batches=[], digests=[], losses=[], grads=None)
    with ref_sage.fp32_matmuls():
        for seeds, labels, kw in feeds:
            smp = ref_sampler.sample(inp.indptr, inp.indices, seeds, fan, kw)
            x = inp.table[smp.n_id.to(torch.int64)]
            blocks = [(h.nbr_local, h.mask) for h in reversed(smp.hops)]
            keep = [torch.empty((blocks[i][0].shape[0], hidden),
                                device=device).bernoulli_(1.0 - p_drop,
                                                          generator=gen)
                    for i in range(layers - 1)]
            lmask = torch.ones(labels.shape, dtype=torch.bool, device=device)
            if fault == "half":
                lmask[labels.shape[0] // 2:] = False
            loss, grads = ref_sage.train_step(params, opt, x, blocks, labels,
                                              lmask, layers, keep, p_drop,
                                              tf32)
            out["batches"].append(smp)
            out["digests"].append(row_digest(x))
            out["losses"].append(loss)
            if out["grads"] is None:
                out["grad1"] = grads
                out["grads"] = {n: float(g.norm()) for n, g in grads.items()}
            del x, keep
    out["params"] = params
    out["change"] = {n: float((params[n] - inp.weights[n]).norm())
                     for n in params}
    return out


def train_readings(prog: dict, ref: dict, exact: bool = True
                   ) -> Dict[str, float]:
    """``prog``: what the program's check steps produced (``batches``,
    ``digests``, ``losses``, ``grads`` and ``change`` as leaf norms).
    Readings: ``loss_gap`` (the first step's relative loss gap) and
    ``loss_gap_later`` (the worst later step's), ``grad_gap`` and
    ``change_gap`` (the worst leaf's, see :func:`_leaf_gaps`, with
    ``change_leaf`` naming it), ``leaves_left_out`` by the gradient
    rule, and, with ``exact``, ``ids_off`` and ``rows_off`` (entries
    that differ)."""
    r = {}
    if exact:
        r["ids_off"] = float(sum(ids_off(p, q) for p, q in
                                 zip(prog["batches"], ref["batches"])))
        r["rows_off"] = float(sum(
            int((a != b).sum()) if a.shape == b.shape else a.numel() + 1
            for a, b in zip(prog["digests"], ref["digests"])))
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    r["loss_gap"] = gaps[0]
    r["loss_gap_later"] = max(gaps[1:], default=0.0)
    med = float(np.median(list(ref["grads"].values())))
    keep = [n for n, v in ref["grads"].items() if v >= GRAD_FLOOR * med]
    r["grad_gap"], _ = _leaf_gaps(prog["grads"], ref["grads"], keep)
    r["change_gap"], r["change_leaf"] = _leaf_gaps(prog["change"],
                                                   ref["change"], keep)
    r["leaves_left_out"] = len(ref["grads"]) - len(keep)
    return r

