"""Training step (counterpart of ``quiver_tpu/parallel/train.py``).

JAX builds a pure, jitted ``(state, x, blocks, labels, label_mask, key) ->
(state, loss)``.  In PyTorch's idiom the state is the ``nn.Module`` and its
``torch.optim.Adam``, updated in place, and the step is
``(x, blocks, labels, label_mask) -> loss``: forward, autograd backward
through the model's plain ops (the JAX package has no backward kernel),
and one optimizer step.  The loss comes back as a 0-d tensor on the
model's device; nothing in the step waits for the card.

With ``mesh=`` the step is data-parallel, as JAX's: the batch carries a
leading replica axis of the mesh's ``data_axis`` size, each replica of the
model runs on its shard's device (its parameters are differentiable
copies of the model's, nothing at all on the model's own device), the
loss is the mean of the per-replica mean losses, and its backward sums
the replicas' gradients into the model's parameters (XLA's gradient
``psum``) before the optimizer steps once.

Dropout draws from a ``torch.Generator`` that the step holds, seeded when
the step is made (one a replica under ``mesh=``); its bits cannot match
Flax's.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TrainState", "make_train_step", "masked_cross_entropy",
           "shard_batch", "replicate"]


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


def _tree_map(fn, tree):
    """``fn`` over the tensor and array leaves of nested tuples, lists,
    dicts and NamedTuples (``None`` leaves stay)."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(mesh, tree, data_axis: str = "data") -> List:
    """Split a batch stacked on a leading replica axis over the mesh's
    ``data_axis``: one tree a device, each leaf's row ``i`` on device
    ``i``."""
    devs = mesh.axis_devices(data_axis)
    return [_tree_map(lambda a, i=i, d=d: torch.as_tensor(a[i]).to(d), tree)
            for i, d in enumerate(devs)]


def replicate(mesh, tree, data_axis: str = "data") -> List:
    """One copy of ``tree`` on each device of the mesh's ``data_axis``."""
    return [_tree_map(lambda a, d=d: torch.as_tensor(a).to(d), tree)
            for d in mesh.axis_devices(data_axis)]


def _mesh_step(model, optimizer, loss_fn, mesh, data_axis: str, seed: int):
    """The data-parallel step (JAX's ``dp_step``): a replica a device of
    ``data_axis``, the mean of their losses, one optimizer step."""
    from torch.func import functional_call

    devs = mesh.axis_devices(data_axis)
    gens = [torch.Generator(device=d).manual_seed(seed + i)
            for i, d in enumerate(devs)]
    home = _device_of(model)

    def step(x, blocks, labels, label_mask) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        parts = shard_batch(mesh, (x, blocks, labels, label_mask),
                            data_axis)
        losses = []
        for (xs, bs, ls, ms), d, g in zip(parts, devs, gens):
            # differentiable copies: backward sums each replica's
            # gradient into the model's parameters
            params = {k: v.to(d) for k, v in model.named_parameters()}
            buffers = {k: v.to(d) for k, v in model.named_buffers()}
            logits = functional_call(model, (params, buffers), (xs, bs),
                                     {"generator": g})
            losses.append(loss_fn(logits, ls, ms).to(home))
        loss = torch.stack(losses).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None, mesh=None,
                    seed: int = 0, data_axis: str = "data"):
    """Build ``step(x, blocks, labels, label_mask) -> loss``.

    Args:
      model: a :class:`GraphSAGE` (any module called as
        ``model(x, blocks, generator=g)``).
      optimizer: its optimizer, stepped once per call.
      loss_fn: ``(logits, labels, mask) -> loss``; default
        :func:`masked_cross_entropy`.
      mesh: a :class:`~quiver_tpu_torch.utils.mesh.Mesh`: the step takes
        every input stacked on a leading axis of ``mesh.shape[data_axis]``
        replicas (``blocks`` as LayerBlocks whose fields carry it, as
        ``DistGraphSampler.sample`` returns them) and trains data-parallel.
      seed: seed of the step's dropout generator.
      data_axis: the mesh axis the batch splits over.
    """
    if loss_fn is None:
        loss_fn = masked_cross_entropy
    if mesh is not None:
        return _mesh_step(model, optimizer, loss_fn, mesh, data_axis, seed)
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
