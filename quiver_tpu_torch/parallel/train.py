"""Training step (counterpart of ``quiver_tpu/parallel/train.py``).

JAX builds a pure, jitted ``(state, x, blocks, labels, label_mask, key) ->
(state, loss)``.  In PyTorch's idiom the state is the ``nn.Module`` and its
``torch.optim.Adam``, updated in place, and the step is
``(x, blocks, labels, label_mask) -> loss``: forward, autograd backward
through the model's plain ops (the JAX package has no backward kernel),
and one optimizer step.  The loss comes back as a 0-d tensor on the
model's device; nothing in the step waits for the card.

Dropout draws from a ``torch.Generator`` that the step holds, seeded when
the step is made; its bits cannot match Flax's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TrainState", "make_train_step", "masked_cross_entropy"]


class TrainState:
    """The model and its optimizer (JAX's params and opt state)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer

    @classmethod
    def create(cls, model: nn.Module, lr: float = 3e-3) -> "TrainState":
        """``model`` with a fresh ``torch.optim.Adam`` at ``lr`` (the
        defaults of ``optax.adam``: betas 0.9 and 0.999, eps 1e-8)."""
        return cls(model, torch.optim.Adam(model.parameters(), lr=lr))


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over the rows where ``mask`` is True
    (``train.py:59-65`` of the JAX package)."""
    ls = F.cross_entropy(logits, labels.to(torch.int64), reduction="none")
    m = mask.to(ls.dtype)
    return (ls * m).sum() / torch.clamp_min(m.sum(), 1.0)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None, mesh=None,
                    seed: int = 0):
    """Build ``step(x, blocks, labels, label_mask) -> loss``.

    Args:
      model: a :class:`GraphSAGE` (any module called as
        ``model(x, blocks, generator=g)``).
      optimizer: its optimizer, stepped once per call.
      loss_fn: ``(logits, labels, mask) -> loss``; default
        :func:`masked_cross_entropy`.
      mesh: the data-parallel variant is not ported (ROADMAP A13).
      seed: seed of the step's dropout generator.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel mesh= step is not ported yet (ROADMAP A13)")
    if loss_fn is None:
        loss_fn = masked_cross_entropy
    gen = torch.Generator(device=_device_of(model)).manual_seed(seed)

    def step(x, blocks, labels, label_mask) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(x, blocks, generator=gen)
        loss = loss_fn(logits, labels, label_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
