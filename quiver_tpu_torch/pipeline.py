"""Fused training pipeline (counterpart of ``quiver_tpu/pipeline.py``).

One step runs sampling, the feature lookup on the device (kernel B2),
forward, backward and the optimizer update with no host round trip
between the seeds and the loss: the key words go to the kernels as
arguments, the frontier never leaves the card, and the loss comes back as
a 0-d device tensor.  JAX compiles the chain into one program; here it is
a sequence of launches on one stream.  The feature must hold its whole
table on the device; a budgeted feature trains through ``SeedLoader``
and ``make_train_step`` instead.

The model step, ``parallel.train.GraphedStep``, chooses alone between
graphs and eager.  On the card it replays the model's forward with its
loss, and autograd's backward, from two CUDA graphs, so the host issues
a few launches a step where it issued a few dozen; B2 writes the rows
straight into the graphs' static input (``Feature._rows_into``), so no
copy of them follows.  Three parts stay eager, launched every step as
before: the sampler's pipeline, since B1 takes its key words by value
and a replay would draw the same neighbours every step; the lookup,
whose call the caller may wrap on the instance (the benchmark records
its rows that way); and the optimizer, since a plain
``torch.optim.Adam`` cannot be captured.  On the CPU it runs its eager
step and the lookup makes its own rows.

The step takes JAX's ``key`` (two uint32 words): ``ks, kd = split(key)``
(``quiver_tpu/pipeline.py:61``) and ``ks`` drives the hops, as the
sampler's ``sample(key=)`` splits its key; ``kd`` goes unused, since
dropout draws from the step's seeded ``torch.Generator``.  The epoch
splits its key into one a step (``:108``); eval samples from its key
directly.  Each also takes per-hop key words, ``[L, 2]`` uint32, or has
the sampler draw them.

While span events are retained (``QUIVER_TPU_TRACE=1``), a training step
records ``train.step`` and under it ``train.sample`` (the sampler's
pipeline), ``train.lookup`` (the rows' gather) and the model step's
``train.forward``, ``train.backward`` and ``train.optimizer``; otherwise
each site reads ``telemetry.spans._HOT`` once and enters a shared no-op
context.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import telemetry
from .parallel.train import _OFF, GraphedStep
from .telemetry import spans as _spans
from .utils import rng as _rng

__all__ = ["make_fused_train_step", "make_fused_eval_fn", "make_scan_epoch"]


def _check(feature) -> None:
    if feature.cache_count < feature.node_count:
        raise ValueError(
            "the fused pipeline needs the whole feature table on the device "
            f"({feature.cache_count} of {feature.node_count} rows are); use "
            "SeedLoader for a budgeted feature")


def _hop_words(sampler, key_words, key, split_first: bool):
    """Per-hop words from ``key_words``, or from ``key`` (after JAX's
    ``ks, kd = split(key)`` when ``split_first``), or ``None`` (the
    sampler draws them)."""
    if key is None:
        return key_words
    if key_words is not None:
        raise ValueError("pass key or key_words, not both")
    if split_first:
        key = _rng.split(_rng.key_data(key))[0]
    return sampler.words_of_key(key)


def _sample_rows(sampler, feature, seeds, key_words, hot, rows=None):
    """Blocks and the rows of the outermost frontier, all on the device.
    The sampler's dedup and frontier caps apply; its edge weights do not:
    the JAX package's fused step samples uniformly even for a weighted
    sampler (``quiver_tpu/pipeline.py:62-65``), and so does this one.
    ``hot``: the caller's read of the span gate (record ``train.sample``
    and ``train.lookup``); ``rows(shape, dtype)``: where the lookup
    writes the rows, if given."""
    if key_words is None:
        key_words = sampler.draw_key_words()
    seeds = sampler.seed_tensor(seeds)
    with (telemetry.span("train.sample") if hot else _OFF):
        n_id, _, _, blocks, _ = sampler.pipeline(seeds, key_words,
                                                 weighted=False)
    with (telemetry.span("train.lookup") if hot else _OFF):
        return _lookup(feature, n_id, rows), blocks


def _lookup(feature, n_id, rows):
    """``feature.lookup_device(n_id)``, called as ever, writing into
    ``rows(shape, dtype)`` where that gives a tensor."""
    if rows is None:
        return feature.lookup_device(n_id)
    with feature._rows_into(rows):
        return feature.lookup_device(n_id)


def make_fused_train_step(sampler, feature, model, optimizer,
                          loss_fn: Optional[Callable] = None, seed: int = 0):
    """Build ``step(seeds, labels, label_mask, key_words=None, *,
    key=None) -> loss``: sample ``seeds`` (a device tensor or host ids),
    gather, train one step.  ``seed`` seeds the step's dropout
    generator.  ``step.train`` is the model step it calls, a
    :class:`~quiver_tpu_torch.parallel.train.GraphedStep`."""
    _check(feature)
    train = GraphedStep(model, optimizer, loss_fn, seed=seed)
    rows = train.rows_buffer

    def step(seeds, labels, label_mask, key_words=None, *,
             key=None) -> torch.Tensor:
        hot = _spans._HOT
        with (telemetry.span("train.step") if hot else _OFF):
            words = _hop_words(sampler, key_words, key, split_first=True)
            x, blocks = _sample_rows(sampler, feature, seeds, words, hot,
                                     rows)
            return train(x, blocks, labels, label_mask)

    step.train = train
    return step


def make_fused_eval_fn(sampler, feature, model):
    """Build ``eval_fn(seeds, key_words=None, *, key=None) -> logits``
    (eval mode, no gradients)."""
    _check(feature)

    def eval_fn(seeds, key_words=None, *, key=None) -> torch.Tensor:
        words = _hop_words(sampler, key_words, key, split_first=False)
        model.eval()
        with torch.no_grad():
            x, blocks = _sample_rows(sampler, feature, seeds, words, False)
            return model(x, blocks)

    return eval_fn


def make_scan_epoch(sampler, feature, model, optimizer,
                    loss_fn: Optional[Callable] = None, seed: int = 0):
    """Build ``epoch(seeds [S, B], labels [S, B], key_words=None, *,
    key=None) -> losses [S]``: the fused step over S batches, every label
    valid.  JAX scans it as one program; here it is a loop, and the losses
    stay on the device.  ``key`` is split into one key a step, as JAX
    does; ``key_words`` is ``[S, L, 2]``; without either the sampler draws
    words per step."""
    step = make_fused_train_step(sampler, feature, model, optimizer, loss_fn,
                                 seed=seed)

    def epoch(seeds, labels, key_words=None, *, key=None) -> torch.Tensor:
        S, B = seeds.shape
        if key is not None and key_words is not None:
            raise ValueError("pass key or key_words, not both")
        keys = None if key is None else _rng.split(_rng.key_data(key), S)
        ones = torch.ones((B,), dtype=torch.bool, device=sampler.device)
        losses = []
        for s in range(S):
            if keys is not None:
                losses.append(step(seeds[s], labels[s], ones, key=keys[s]))
                continue
            kw = None if key_words is None else np.asarray(key_words)[s]
            losses.append(step(seeds[s], labels[s], ones, kw))
        return torch.stack(losses)

    return epoch
