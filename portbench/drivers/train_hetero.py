"""Hetero training traffic: R-GAT through the port's fused step,
``make_fused_train_step(HeteroGraphSageSampler, HeteroFeature, RGAT,
Adam)``, back to back over a seeded order of the training papers.

As ``drivers/train.py`` does for GraphSAGE: set-up builds the one step
object and drives it through its first steps on the window's own feed;
the first ``check_steps`` are recorded for the comparison (each type's
ids and rows, each block, the losses, the first gradient from Adam's
state and the parameters after them), the rest warm up, and the window
continues the same object.  A step's key words are one pair a sampled
block.
"""

from __future__ import annotations

import gc
import sys

import torch

from .. import build, build_hetero, check, check_hetero, counts_hetero, trace
from ..core import Run, now
from ..reference import hetero_sampler as ref_sampler
from .train import Feed


def _recording(sampler, feature, rec: dict):
    """Instance-level wrappers that keep what the step's sampler and
    lookup return; removed again by :func:`_stop_recording`."""
    pipe, look = sampler.pipeline, feature.lookup_device

    def pipeline(*a, **k):
        out = pipe(*a, **k)
        batch = out[3]
        rec["batches"].append(dict(
            n_id={t: x.clone() for t, x in batch.n_id.items()},
            n_mask={t: x.clone() for t, x in batch.n_id_mask.items()},
            blocks=[(b.relation, b.nbr_local.clone(), b.mask.clone())
                    for layer in batch.layers for b in layer]))
        return out

    def lookup_device(n_id):
        rows = look(n_id)
        rec["digests"].append({t: check.row_digest(x)
                               for t, x in rows.items()})
        return rows

    sampler.pipeline, feature.lookup_device = pipeline, lookup_device


def _stop_recording(sampler, feature):
    del sampler.pipeline, feature.lookup_device


def step_objects(qt, cfg: dict, inp, dev, seed: int, run=None):
    """The port's objects, Adam and the fused step over ``inp``, with the
    dropout seed of run ``seed``."""
    objs = build_hetero.port_objects(qt, cfg, inp, dev, train=True, run=run)
    model = objs[3]
    if objs[2].layer_relations() != build_hetero.layer_relations(cfg):
        raise RuntimeError("the sampler's blocks are not the reference's")
    opt = torch.optim.Adam(model.parameters(), lr=cfg["optimizer"]["lr"])
    dropout_seed = build.seed_of(seed, "dropout")
    step = qt.make_fused_train_step(objs[2], objs[1], model, opt,
                                    seed=dropout_seed)
    return objs, opt, step, dropout_seed


def run(r: Run, qt) -> None:
    cfg, mix, dev = r.cell.cfg, r.cell.mix, r.device
    inp = build_hetero.make_inputs(cfg, r.seed, dev)
    r.mark("inputs")
    objs, opt, step, dropout_seed = step_objects(qt, cfg, inp, dev, r.seed,
                                                 run=r)
    topo, feature, sampler, model = objs
    blocks = sampler.num_blocks(cfg["sampling"]["batch"])
    feed = Feed(inp, cfg["sampling"]["batch"], r.seed, dev)

    # the check steps, recorded, then the warm-up: one object throughout
    n_check = mix["check_steps"]
    rec = dict(batches=[], digests=[], losses=[], feeds=[])
    _recording(sampler, feature, rec)
    for s in range(n_check):
        seeds, labels, mask, kw = feed(s, blocks)
        rec["feeds"].append((seeds, labels, kw))
        rec["losses"].append(step(seeds, labels, mask, kw))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        r.mark(f"check step {s + 1}")
        if s == 0:
            b1 = opt.defaults["betas"][0]
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
        step(*feed(s, blocks))
        s += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    r.end_setup()

    # the window
    losses, host = [], 0.0
    t0 = now()
    first = s
    while now() - t0 < r.seconds:
        args = feed(s, blocks)
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
        fs = [feed(s + i, blocks) for i in range(2 * n)]
        r.traced = trace.capture(lambda part: [step(*f) for f in part], dev,
                                 (fs[:n], fs[n:]), span="step")
        s += 2 * n
        _count_steps(r, inp, cfg, [(f[0], f[3]) for f in fs[:n]])
        r.mark("trace")

    # the program's state goes before the reference runs
    del step, opt, model, sampler, feature, topo, objs, losses
    # the step's closures hold it in reference cycles: collected now, so
    # that its graphs' pool and tables go back to the card before the
    # reference takes as much again
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check_hetero.reference_train(inp, cfg, rec["feeds"], dropout_seed,
                                       dev)
    readings = check_hetero.train_readings(rec, ref)
    for name in r.cell.limits:
        r.check(name, readings[name])
    r.mark("reference")
    r.keep.update(inp=inp, rec=rec, ref=ref, dropout_seed=dropout_seed)


def _count_steps(r: Run, inp, cfg, steps) -> None:
    """The yardstick over the traced steps: live-row model FLOPs a step
    (mean), and B1's and B2's bytes over all of them, from the reference
    sampler's batches of the same seeds and key words."""
    dims = {t: cfg["feature_dim"] for t in cfg["node_types"]}
    hidden, classes = cfg["model"]["hidden"], cfg["classes"]
    sizes = build_hetero.hop_sizes(cfg)
    flops, whole, b1, b2 = 0, 0, 0, 0
    for seeds, kw in steps:
        smp = ref_sampler.sample(inp.csr, cfg["node_types"], cfg["seed_type"],
                                 seeds, sizes, kw)
        flops += counts_hetero.rgat_flops(smp, dims, hidden, classes, True)
        whole += counts_hetero.rgat_flops(smp, dims, hidden, classes, True,
                                          live=False)
        b1 += counts_hetero.b1_bytes(smp)
        b2 += counts_hetero.b2_bytes(smp, cfg["feature_dim"] * 4)
    r.layer.update(flops_per_step=flops / len(steps), b1_bytes=b1,
                   b2_bytes=b2, traced_steps=len(steps))
    print(f"yardstick: {flops / len(steps):.6e} live-row model FLOPs a step "
          f"of {whole / len(steps):.6e} over the whole padded frontiers "
          f"(padding {100.0 * (whole - flops) / whole:.4f}% of the dense "
          f"work), left out of mfu", file=sys.stderr)
