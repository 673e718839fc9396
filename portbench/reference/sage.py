"""Plain reference of GraphSAGE (mean aggregator) over dense sampled
blocks, its masked cross-entropy loss, and Adam.

Layer ``i`` (outermost block first) maps ``x [P_i, D]`` to ``[T_i, H]``:
``x[:T] @ W_self.T + b_self + mean_{valid j} x[nbr_local[:, j]] @ W_nbr.T``,
then ReLU and inverted dropout between layers.  Parameters are a dict of
named tensors, ``convs.{i}.lin_self.weight`` and so on, the names the
state of a PyTorch GraphSAGE of this shape carries.  Matmuls run in plain
fp32 with TF32 off; with ``tf32`` (the control) their inputs are first
rounded to TF32's 10-bit mantissa, as the card's TF32 tensor cores take
them, on any device.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def param_shapes(in_dim: int, hidden: int, out_dim: int,
                 layers: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every parameter, in the module's order."""
    dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
    out = []
    for i in range(layers):
        out += [(f"convs.{i}.lin_self.weight", (dims[i + 1], dims[i])),
                (f"convs.{i}.lin_self.bias", (dims[i + 1],)),
                (f"convs.{i}.lin_nbr.weight", (dims[i + 1], dims[i]))]
    return out


@contextlib.contextmanager
def fp32_matmuls():
    """Plain fp32 matmuls on the card: TF32 off while the reference runs."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest fp32 value with a 10-bit mantissa
    (ties away from zero), the precision of a TF32 matmul's inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every product's inputs rounded to TF32, forward and
    backward, as a TF32 matmul and its gradient matmuls compute."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.T, a.T @ g


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, blocks,
            layers: int, keep_masks: Optional[Iterable] = None,
            p_drop: float = 0.5, tf32: bool = False) -> torch.Tensor:
    """Logits of the innermost targets.  ``blocks`` are ``(nbr_local,
    mask)`` pairs, outermost first; ``keep_masks`` one dropout keep mask
    per hidden layer (``None``: no dropout, as in evaluation); ``tf32``
    rounds every matmul's inputs to TF32 (the control)."""
    keep = list(keep_masks) if keep_masks is not None else None
    for i, (nbr_local, mask) in enumerate(blocks):
        t, k = nbr_local.shape
        xs = x[nbr_local.reshape(-1).to(torch.int64)].view(t, k, x.shape[1])
        m = mask.to(x.dtype)[..., None]
        mean = (xs * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
        x = (_mm(x[:t], params[f"convs.{i}.lin_self.weight"].T, tf32)
             + params[f"convs.{i}.lin_self.bias"]
             + _mm(mean, params[f"convs.{i}.lin_nbr.weight"].T, tf32))
        if i != layers - 1:
            x = torch.relu(x)
            if keep is not None:
                x = x * keep[i] / (1.0 - p_drop)
    return x


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over the rows where ``mask``."""
    logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    nll = -logp.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


class Adam:
    """Adam (betas 0.9 and 0.999, eps 1e-8, no weight decay) over a dict of
    parameters, in plain tensor arithmetic."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            self.m[n] = self.b1 * self.m[n] + (1.0 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1.0 - self.b2) * g * g
            p -= self.lr * (self.m[n] / c1) / (
                torch.sqrt(self.v[n] / c2) + self.eps)


def train_step(params: Dict[str, torch.Tensor], opt: Adam, x, blocks,
               labels, label_mask, layers: int, keep_masks,
               p_drop: float = 0.5, tf32: bool = False):
    """One step in place: forward, loss, gradients, Adam.  Returns the
    loss (a float) and the gradients.  With ``tf32`` every matmul,
    forward and backward, rounds its inputs to TF32."""
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in params.items()}
    loss = masked_ce(forward(leaves, x, blocks, layers, keep_masks, p_drop,
                             tf32), labels, label_mask)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        opt.step(params, grads)
    return float(loss.detach()), grads
