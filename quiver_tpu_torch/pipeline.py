"""Fused training pipeline (counterpart of ``quiver_tpu/pipeline.py``).

One step runs sampling, the feature lookup on the device (kernel B2),
forward, backward and the optimizer update with no host round trip
between the seeds and the loss: the key words go to the kernels as
arguments, the frontier never leaves the card, and the loss comes back as
a 0-d device tensor.  JAX compiles the chain into one program; here it is
a sequence of launches on one stream.  The feature must hold its whole
table on the device; a budgeted feature trains through ``SeedLoader``
and ``make_train_step`` instead.

The step takes the sampling key words explicitly, ``[L, 2]`` uint32, as
the sampler does, or has the sampler draw them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .parallel.train import make_train_step

__all__ = ["make_fused_train_step", "make_fused_eval_fn", "make_scan_epoch"]


def _check(feature) -> None:
    if feature.cache_count < feature.node_count:
        raise ValueError(
            "the fused pipeline needs the whole feature table on the device "
            f"({feature.cache_count} of {feature.node_count} rows are); use "
            "SeedLoader for a budgeted feature")


def _sample_rows(sampler, feature, seeds, key_words):
    """Blocks and the rows of the outermost frontier, all on the device.
    The sampler's dedup and frontier caps apply; its edge weights do not:
    the JAX package's fused step samples uniformly even for a weighted
    sampler (``quiver_tpu/pipeline.py:62-65``), and so does this one."""
    if key_words is None:
        key_words = sampler.draw_key_words()
    n_id, _, _, blocks, _ = sampler.pipeline(sampler.seed_tensor(seeds),
                                             key_words, weighted=False)
    return feature.lookup_device(n_id), blocks


def make_fused_train_step(sampler, feature, model, optimizer,
                          loss_fn: Optional[Callable] = None, seed: int = 0):
    """Build ``step(seeds, labels, label_mask, key_words=None) -> loss``:
    sample ``seeds`` (a device tensor or host ids), gather, train one step.
    ``seed`` seeds the step's dropout generator."""
    _check(feature)
    train = make_train_step(model, optimizer, loss_fn, seed=seed)

    def step(seeds, labels, label_mask, key_words=None) -> torch.Tensor:
        x, blocks = _sample_rows(sampler, feature, seeds, key_words)
        return train(x, blocks, labels, label_mask)

    return step


def make_fused_eval_fn(sampler, feature, model):
    """Build ``eval_fn(seeds, key_words=None) -> logits`` (eval mode, no
    gradients)."""
    _check(feature)

    def eval_fn(seeds, key_words=None) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            x, blocks = _sample_rows(sampler, feature, seeds, key_words)
            return model(x, blocks)

    return eval_fn


def make_scan_epoch(sampler, feature, model, optimizer,
                    loss_fn: Optional[Callable] = None, seed: int = 0):
    """Build ``epoch(seeds [S, B], labels [S, B], key_words=None) ->
    losses [S]``: the fused step over S batches, every label valid.  JAX
    scans it as one program; here it is a loop, and the losses stay on
    the device.  ``key_words`` is ``[S, L, 2]``, or drawn by the sampler
    per step."""
    step = make_fused_train_step(sampler, feature, model, optimizer, loss_fn,
                                 seed=seed)

    def epoch(seeds, labels, key_words=None) -> torch.Tensor:
        S, B = seeds.shape
        ones = torch.ones((B,), dtype=torch.bool, device=sampler.device)
        losses = []
        for s in range(S):
            kw = None if key_words is None else np.asarray(key_words)[s]
            losses.append(step(seeds[s], labels[s], ones, kw))
        return torch.stack(losses)

    return epoch
