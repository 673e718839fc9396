"""Training traffic: the port's fused step, ``make_fused_train_step``,
back to back over a seeded order of the training split.

Set-up builds the one step object (sampler, feature, model, Adam) and
drives it through its first steps on the window's own feed: the first
``check_steps`` are recorded for the comparison (their batches, rows,
losses, the first gradient from Adam's state and the parameters after
them), the rest warm up.  The window then continues the same object.
Losses stay on the card until the window closes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import build, check, trace
from ..core import Run, now


class Feed:
    """Batch ``s`` of the window's order: seeds and labels on the card
    (views, no device work) and key words drawn as the sampler draws
    them."""

    def __init__(self, inp, batch: int, seed: int, device):
        g = build.generator(seed, "traffic", device)
        order = inp.train_ids[torch.randperm(inp.train_ids.numel(),
                                             generator=g, device=device)]
        n = order.numel() // batch * batch
        self.seeds = order[:n].to(torch.int32)
        self.labels = inp.labels[order[:n]]
        self.batch, self.n = batch, n // batch
        self.mask = torch.ones(batch, dtype=torch.bool, device=device)
        self._rng = np.random.default_rng(build.seed_of(seed, "traffic"))

    def words(self, hops: int) -> np.ndarray:
        return self._rng.integers(0, 2**32, size=(hops, 2), dtype=np.uint32)

    def __call__(self, s: int, hops: int):
        i = s % self.n
        sl = slice(i * self.batch, (i + 1) * self.batch)
        return self.seeds[sl], self.labels[sl], self.mask, self.words(hops)


def _recording(sampler, feature, rec: dict):
    """Instance-level wrappers that keep what the step's sampler and
    lookup return; removed again by :func:`_stop_recording`."""
    pipe, look = sampler.pipeline, feature.lookup_device

    def pipeline(*a, **k):
        out = pipe(*a, **k)
        rec["batches"].append(dict(
            n_id=out[0].clone(), n_mask=out[1].clone(),
            blocks=[(b.nbr_local.clone(), b.mask.clone()) for b in out[3]]))
        return out

    def lookup_device(idx):
        rows = look(idx)
        rec["digests"].append(check.row_digest(rows))
        return rows

    sampler.pipeline, feature.lookup_device = pipeline, lookup_device


def _stop_recording(sampler, feature):
    del sampler.pipeline, feature.lookup_device


def run(r: Run, qt) -> None:
    cfg, mix, dev = r.cell.cfg, r.cell.mix, r.device
    inp = build.make_inputs(cfg, r.seed, dev)
    r.mark("inputs")
    topo, feature, sampler, model = build.port_objects(qt, cfg, inp, dev,
                                                       train=True, run=r)
    opt = torch.optim.Adam(model.parameters(), lr=cfg["optimizer"]["lr"])
    dropout_seed = build.seed_of(r.seed, "dropout")
    step = qt.make_fused_train_step(sampler, feature, model, opt,
                                    seed=dropout_seed)
    hops = len(cfg["sampling"]["fanouts"])
    feed = Feed(inp, cfg["sampling"]["batch"], r.seed, dev)

    # the check steps, recorded, then the warm-up: one object throughout
    n_check = mix["check_steps"]
    rec = dict(batches=[], digests=[], losses=[], feeds=[])
    _recording(sampler, feature, rec)
    for s in range(n_check):
        seeds, labels, mask, kw = feed(s, hops)
        rec["feeds"].append((seeds, labels, kw))
        rec["losses"].append(step(seeds, labels, mask, kw))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        r.mark(f"check step {s + 1}")
        if s == 0:
            b1 = opt.defaults["betas"][0]
            # a step that kept no state moved nothing: its gradient reads 0
            rec["grad1"] = {
                n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - b1) for n, p in model.named_parameters()}
            rec["grads"] = {n: float(g.norm()) for n, g in rec["grad1"].items()}
    rec["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    rec["change"] = {n: float((p - inp.weights[n]).norm())
                     for n, p in rec["params"].items()}
    rec["losses"] = [float(x) for x in rec["losses"]]
    _stop_recording(sampler, feature)
    r.mark("check steps")
    s = n_check
    for _ in range(mix["warmup_steps"]):
        step(*feed(s, hops))
        s += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    r.end_setup()

    # the window
    losses, host = [], 0.0
    t0 = now()
    first = s
    while now() - t0 < r.seconds:
        args = feed(s, hops)
        a = now()
        losses.append(step(*args))
        host += now() - a
        s += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window = now() - t0
    steps = s - first
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    r.e2e["train_seeds_per_s"] = steps * feed.batch / window
    r.layer.update(steps=steps, window_s=window,
                   host_dispatch_s=host / steps)
    if dev.type == "cuda":
        r.memory_peak = torch.cuda.max_memory_allocated(dev)

    if r.trace:
        n = mix["trace_steps"]
        fs = [feed(s + i, hops) for i in range(2 * n)]
        r.traced = trace.capture(lambda part: [step(*f) for f in part], dev,
                                 (fs[:n], fs[n:]), span="step")
        s += 2 * n
        _count_steps(r, inp, cfg, [(f[0], f[3]) for f in fs[:n]])
        r.mark("trace")

    # the program's state goes before the reference runs
    del step, opt, model, sampler, feature, topo, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_train(inp, cfg, rec["feeds"], dropout_seed, dev)
    readings = check.train_readings(rec, ref)
    for name in r.cell.limits:
        r.check(name, readings[name])
    r.mark("reference")
    r.keep.update(inp=inp, rec=rec, ref=ref, dropout_seed=dropout_seed)


def _count_steps(r: Run, inp, cfg, steps) -> None:
    """The yardstick over the traced steps: model FLOPs a step (mean),
    and B1's and B2's bytes over all of them, from the reference
    sampler's batches of the same seeds and key words."""
    from .. import counts
    from ..reference import sampler as ref_sampler

    dims = build.dims_of(cfg)
    fan = cfg["sampling"]["fanouts"]
    row = cfg["feature_dim"] * 4
    flops, b1, b2, live, ids = 0, 0, 0, 0, 0
    for seeds, kw in steps:
        smp = ref_sampler.sample(inp.indptr, inp.indices, seeds, fan, kw)
        flops += counts.sage_flops(counts.layer_shapes(smp.hops, dims),
                                   backward=True)
        b1 += counts.b1_step_bytes(smp.hops, smp.n_id)
        b2 += counts.b2_bytes(smp.n_id[smp.n_mask], row, ordered=True)
        live += int(smp.n_mask.sum())
        ids += smp.n_mask.numel()
    r.layer.update(flops_per_step=flops / len(steps), b1_bytes=b1,
                   b2_bytes=b2, traced_steps=len(steps))
    print(f"yardstick: {ids - live} of the traced batches' {ids} ids are "
          f"padding ({100.0 * (ids - live) / ids:.4f}%), left out of B2's "
          f"bytes", file=sys.stderr)
