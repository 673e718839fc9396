"""The comparisons that decide the hetero cell's ``correct``: what the
timed R-GAT step produced against the plain reference
(``reference/rgat.py`` over ``reference/hetero_sampler.py``), worked out
after the window has closed.  The readings are ``check.py``'s, with ids
and rows compared type by type and block by block; the same functions
read the control and the planted fault in ``calibrate_hetero.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import build_hetero, check
from .reference import hetero_sampler as ref_sampler
from .reference import rgat as ref_rgat
from .reference import sage as ref_sage


def ids_off(prog: dict, ref: ref_sampler.HeteroSampled) -> int:
    """Entries of each type's ids and mask, and of each block's local ids
    and mask, where the program's batch differs from the reference's."""
    off = 0
    for t, ids in ref.n_id.items():
        if prog["n_id"][t].shape != ids.shape:
            return max(off, 1) + ids.numel()
        off += int((prog["n_id"][t] != ids).sum())
        off += int((prog["n_mask"][t] != ref.n_mask[t]).sum())
    blocks = [b for hop in reversed(ref.hops) for b in hop]
    if len(prog["blocks"]) != len(blocks):
        return max(off, 1) + len(blocks)
    for (rel, nl, m), b in zip(prog["blocks"], blocks):
        if rel != b.relation or nl.shape != b.hop.nbr_local.shape:
            return max(off, 1) + nl.numel()
        off += int((nl != b.hop.nbr_local).sum())
        off += int((m != b.hop.mask).sum())
    return off


def reference_train(inp, cfg: dict, feeds, dropout_seed: int, device,
                    tf32: bool = False, fault: Optional[str] = None) -> dict:
    """The reference over the check steps' feeds ``(seeds, labels,
    key_words)``: each step's batch, rows' digests by type and loss, the
    first step's gradients and the parameters after the last.  ``tf32``
    rounds the matmuls' inputs to TF32 (the control); ``fault="half"``
    takes the loss over the first half of each batch only."""
    heads, p_drop = cfg["model"]["heads"], cfg["model"]["dropout"]
    sizes = build_hetero.hop_sizes(cfg)
    params = {n: w.clone() for n, w in inp.weights.items()}
    opt = ref_sage.Adam(params, cfg["optimizer"]["lr"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    out = dict(batches=[], digests=[], losses=[], grads=None)
    tables = {t: inp.table(t) for t in cfg["node_types"]}
    with ref_sage.fp32_matmuls():
        for seeds, labels, kw in feeds:
            smp = ref_sampler.sample(inp.csr, cfg["node_types"],
                                     cfg["seed_type"], seeds, sizes, kw)
            xs = {t: tables[t][smp.n_id[t].to(torch.int64)]
                  for t in cfg["node_types"]}
            layers = [[(b.relation, b.hop.nbr_local, b.hop.mask)
                       for b in hop] for hop in reversed(smp.hops)]
            lmask = torch.ones(labels.shape, dtype=torch.bool, device=device)
            if fault == "half":
                lmask[labels.shape[0] // 2:] = False
            loss, grads = ref_rgat.train_step(
                params, opt, xs, layers, cfg["seed_type"], labels, lmask,
                heads, gen, p_drop, tf32)
            out["batches"].append(smp)
            out["digests"].append({t: check.row_digest(x)
                                   for t, x in xs.items()})
            out["losses"].append(loss)
            if out["grads"] is None:
                out["grad1"] = grads
                out["grads"] = {n: float(g.norm()) for n, g in grads.items()}
            del xs, grads
    del tables
    out["params"] = params
    out["change"] = {n: float((params[n] - inp.weights[n]).norm())
                     for n in params}
    return out


def rows_off(prog_digests, ref_digests) -> int:
    off = 0
    for p, q in zip(prog_digests, ref_digests):
        for t, b in q.items():
            a = p[t]
            off += int((a != b).sum()) if a.shape == b.shape else a.numel() + 1
    return off


def train_readings(prog: dict, ref: dict, exact: bool = True
                   ) -> Dict[str, float]:
    """``check.train_readings`` of the losses, gradients and changes, with
    ``ids_off`` and ``rows_off`` (with ``exact``) over every type and
    block."""
    r = check.train_readings(prog, ref, exact=False)
    if exact:
        r["ids_off"] = float(sum(ids_off(p, q) for p, q in
                                 zip(prog["batches"], ref["batches"])))
        r["rows_off"] = float(rows_off(prog["digests"], ref["digests"]))
    return r
