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

:class:`GraphedStep` is the fused pipeline's single-device step, and
alone chooses graphs or eager: on the card the forward with its loss and
autograd's backward are replayed from two CUDA graphs, bitwise the eager
step's; elsewhere it runs the eager step.  The optimizer steps eagerly
after the replays (a plain ``torch.optim.Adam`` cannot be captured);
sampling and the lookup are the caller's, and stay eager
(``pipeline.py`` says why).  :func:`make_train_step` stays eager.

While span events are retained (``QUIVER_TPU_TRACE=1``), the
single-device step records ``train.forward`` (model and loss),
``train.backward`` and ``train.optimizer``; otherwise it reads
``telemetry.spans._HOT`` once and enters :data:`_OFF`.  The mesh step
records none.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import telemetry
from ..telemetry import spans as _spans

__all__ = ["TrainState", "make_train_step", "GraphedStep",
           "masked_cross_entropy", "shard_batch", "replicate"]

# what a phase enters in place of its span while the gate is off
_OFF = contextlib.nullcontext()


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
    return _eager_step(model, optimizer, loss_fn, gen)


def _eager_step(model, optimizer, loss_fn, gen):
    """The single-device step, op by op, with dropout drawn from
    ``gen``."""

    def step(x, blocks, labels, label_mask) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        hot = _spans._HOT
        with (telemetry.span("train.forward") if hot else _OFF):
            logits = model(x, blocks, generator=gen)
            loss = loss_fn(logits, labels, label_mask)
        with (telemetry.span("train.backward") if hot else _OFF):
            loss.backward()
        with (telemetry.span("train.optimizer") if hot else _OFF):
            optimizer.step()
        return loss.detach()

    return step


class _Graphs:
    """One input signature's forward with its loss and autograd's
    backward, captured as two CUDA graphs on one memory pool, with the
    static tensors they read and write."""

    def __init__(self, sig, inputs, fwd, bwd, loss, grads, ones):
        self.sig, self.inputs = sig, inputs
        self.fwd, self.bwd = fwd, bwd
        self.loss, self.grads, self.ones = loss, grads, ones


class GraphedStep:
    """The fused pipeline's single-device step, ``step(x, blocks, labels,
    label_mask) -> loss``.  On the card the model's forward and loss are
    replayed from one CUDA graph and autograd's backward from another
    (two graphs on one pool, as ``torch.cuda.make_graphed_callables``
    builds them): two launches where autograd and the modules launch a
    few dozen kernels one by one.  Losses, gradients and parameters are
    bitwise the eager step's (:func:`make_train_step`'s).

    - The first call captures the graphs over its own inputs, after one
      eager pass on the capture stream (kernel loading, cuBLAS's handle
      and workspace).  That pass and the capture leave no trace: the
      dropout generator's state and the model's buffers are put back, no
      ``.grad`` is written, the optimizer is not stepped.  The call then
      replays, as every later one does.
    - The inputs are any tree of tensors (tuples, lists, dicts,
      NamedTuples), with other leaves fixed at the capture: GraphSAGE's
      rows and blocks, or R-GAT's dict of rows by node type and
      its ``HeteroSampledBatch``, whose relations, batch size and seed
      type come with its shapes.
    - Each call copies its tensors into the graphs' static inputs, except
      rows written into the buffers that :meth:`rows_buffer` hands out,
      which are the static inputs already.  The loss it returns is a copy,
      so no later replay overwrites it.
    - Dropout draws from the step's ``torch.Generator``, registered with
      the forward's graph: each replay draws the masks the eager step
      would draw from the generator's state, and advances it as much.
    - The backward's graph writes each parameter's gradient into one
      fixed buffer, which becomes the parameter's ``.grad``; the
      optimizer then steps eagerly (a plain ``torch.optim.Adam`` cannot
      be captured).
    - A call the graphs cannot take runs eagerly: an input off the card
      (every call on the CPU), tensors that differ in shape, dtype or
      device from the captured ones, blocks of another layout
      (``LayerBlock.positional``), or parameters that moved.
      A capture that fails raises: the step never falls back to eager for
      any other reason.

    ``captures`` and ``eager_calls`` count both.  While span events are
    retained, the input copies, the forward's replay and the loss's copy
    record ``train.forward``; the backward's replay ``train.backward``;
    the optimizer ``train.optimizer``.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Optional[Callable] = None, seed: int = 0):
        self.model, self.optimizer = model, optimizer
        self.loss_fn = masked_cross_entropy if loss_fn is None else loss_fn
        self.device = _device_of(model)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.eager = _eager_step(model, optimizer, self.loss_fn, self.gen)
        self.params = list(model.parameters())
        self._graphs: Optional[_Graphs] = None
        self.captures = 0      # graphs captured
        self.eager_calls = 0   # calls that ran op by op

    def rows_buffer(self, shape, dtype, at: int = 0
                    ) -> Optional[torch.Tensor]:
        """Where the next call's rows of ``shape`` and ``dtype`` may be
        written so that no copy follows: the graphs' static input tensor
        ``at`` (in the order the call's tensors are flattened: the rows
        ``x`` first, and where ``x`` is a dict of rows, one a node type,
        its tensors first in its order); ``None`` before the capture or
        where that tensor does not fit."""
        g = self._graphs
        if g is None:
            return None
        x = g.inputs[at]
        return x if x.shape == shape and x.dtype == dtype else None

    def __call__(self, x, blocks, labels, label_mask) -> torch.Tensor:
        args = (x, blocks, labels, label_mask)
        leaves: List = []
        _tree_map(leaves.append, args)
        g = self._graphs
        sig = self._signature(leaves, blocks)
        if g is None and sig is not None and all(a.is_cuda for a in leaves):
            g = self._capture(sig, args, leaves)
        if g is None or sig != g.sig:
            self.eager_calls += 1
            return self.eager(*args)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        hot = _spans._HOT
        with (telemetry.span("train.forward") if hot else _OFF):
            self._copy_in(g, leaves)
            g.fwd.replay()
            loss = g.loss.clone()
        with (telemetry.span("train.backward") if hot else _OFF):
            g.bwd.replay()
            self._set_grads(g)
        with (telemetry.span("train.optimizer") if hot else _OFF):
            self.optimizer.step()
        return loss

    def _signature(self, leaves, blocks):
        """Shape, dtype and device of every input, each block's layout
        (the model's route may follow it), and where each parameter lives
        and whether it takes a gradient; ``None`` for inputs the graphs
        cannot take."""
        if not all(isinstance(a, torch.Tensor) for a in leaves):
            return None
        return (tuple((a.shape, a.dtype, a.device) for a in leaves),
                tuple(getattr(b, "positional", None) for b in blocks),
                tuple((p.data_ptr(), p.requires_grad) for p in self.params))

    @staticmethod
    def _copy_in(g: _Graphs, leaves) -> None:
        """The call's tensors into the static inputs, one multi-tensor
        copy a dtype (a dozen single copies cost the host more than the
        replays)."""
        by_dtype: dict = {}
        for s, a in zip(g.inputs, leaves):
            if a is not s:
                dst, src = by_dtype.setdefault(s.dtype, ([], []))
                dst.append(s)
                src.append(a)
        for dst, src in by_dtype.values():
            torch._foreach_copy_(dst, src)

    @staticmethod
    def _set_grads(g: _Graphs) -> None:
        for p, gr in g.grads:
            p.grad = gr

    def _capture(self, sig, args, leaves) -> _Graphs:
        """Capture the graphs over copies of ``args``, their static
        inputs."""
        inputs = [a.clone() for a in leaves]
        it = iter(inputs)
        x, blocks, labels, label_mask = _tree_map(lambda a: next(it), args)
        params = [p for p in self.params if p.requires_grad]
        model, gen = self.model, self.gen

        def forward():
            logits = model(x, blocks, generator=gen)
            return self.loss_fn(logits, labels, label_mask)

        model.train()
        state = gen.get_state()
        buffers = [b.clone() for b in model.buffers()]
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        try:
            with torch.cuda.stream(side):
                torch.autograd.grad(forward(), params, allow_unused=True)
            gen.set_state(state)
            fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            fwd.register_generator_state(gen)
            with torch.cuda.graph(fwd, stream=side):
                loss = forward()
            ones = torch.ones_like(loss)
            with torch.cuda.graph(bwd, pool=fwd.pool(), stream=side):
                grads = torch.autograd.grad(loss, params, ones,
                                            allow_unused=True)
        finally:
            here.wait_stream(side)
            gen.set_state(state)
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        self._graphs = _Graphs(sig, inputs, fwd, bwd, loss.detach(),
                               list(zip(params, grads)), ones)
        self.captures += 1
        return self._graphs
