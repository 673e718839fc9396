"""GraphSAGE's hidden-layer activation in training on the card, forward and
backward.

``sage_act(a, b, keep, p)`` is ``relu(a + b) * keep / (1 - p)`` for
SAGEConv's two addends ``a`` (``lin_self``'s output, bias included) and
``b`` (``lin_nbr``'s) and the dropout's keep mask ``keep`` (0 or 1, drawn
by the caller), with a byte an element for the backward: bit 0 is ReLU's
gate (the output is not ``<= 0``), bit 1 the keep bit.  One launch of
``csrc/sage_act.cu``'s forward kernel.  :func:`sage_act_backward` turns
the output's gradient and the byte into the addends' gradient with the
kernel's backward.  :class:`SageAct` binds the two under autograd and
saves the byte alone.  The kernels round every op as the chain they
replace does on the card, so both outputs are that chain's bit for bit.
They replace no TPU kernel (the JAX package leaves ReLU and dropout to
XLA); the source says what bounds them on the H100 and what their design
does.

Plain versions: :func:`sage_act_plain` and :func:`sage_act_backward_plain`
are the chain itself, op for op.  Each entry runs its plain version for
tensors on the CPU and its kernel for tensors on the card; a kernel that
does not build or launch raises, and arguments the kernel does not take
raise :class:`~.build.KernelArgumentError`: neither falls back.
``sage_act.launches`` and ``sage_act_backward.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .build import KernelArgumentError
from ...telemetry.profile import profiled

__all__ = ["sage_act", "sage_act_plain", "sage_act_backward",
           "sage_act_backward_plain", "SageAct", "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/sage_act.cu"
REPLACES = None  # the JAX package leaves ReLU and dropout to XLA

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, _P, _P, _I64, _F32, _INT, _P)
_BWD_ARGTYPES = (_P, _P, _P, _I64, _F32, _INT, _P)
_DTYPES = (torch.float32, torch.bfloat16)


def _scale(p: float) -> float:
    """``1 / (1 - p)`` as PyTorch's CUDA division by the Python scalar
    ``1 - p`` multiplies by it: the scalar rounded to fp32, its reciprocal
    taken in fp32."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(1.0 - p))


def sage_act_plain(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor,
                   p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain the kernel replaces: ``F.relu(a + b) * keep / (1 - p)``,
    and the byte of ReLU's gate and the keep bit."""
    r = F.relu(a + b)
    code = ((~(r <= 0)).to(torch.uint8)
            | ((keep != 0).to(torch.uint8) << 1))
    return r * keep / (1.0 - p), code


def sage_act_backward_plain(dy: torch.Tensor, code: torch.Tensor,
                            p: float) -> torch.Tensor:
    """Autograd's backward of the chain from the byte: the division's, the
    product's by the keep bit, then ReLU's (+0 where its gate is shut)."""
    gate = (code & 1).bool()
    keep = ((code >> 1) & 1).to(dy.dtype)
    return torch.where(gate, (dy / (1.0 - p)) * keep, 0)


def _check(what: str, p: float, *tensors) -> None:
    """``tensors`` are ``(name, tensor, dtype)``: the first on the card in
    fp32 or bf16 (its dtype ``None``), each contiguous, of the first's
    shape and device, in its ``dtype`` (``None``: the first's)."""
    _, first, _ = tensors[0]
    if first.device.type != "cuda":
        raise KernelArgumentError(f"{what}: unsupported device {first.device}")
    if first.dtype not in _DTYPES:
        raise KernelArgumentError(
            f"{what}: {tensors[0][0]} must be float32 or bfloat16, got "
            f"{first.dtype}")
    if not 0.0 <= p <= 1.0:
        raise KernelArgumentError(f"{what}: p must be in [0, 1], got {p}")
    for name, t, dtype in tensors:
        dtype = dtype or first.dtype
        if t.dtype != dtype:
            raise KernelArgumentError(
                f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise KernelArgumentError(
                f"{what}: {name} must have the shape {tuple(first.shape)} "
                f"on {first.device}, got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise KernelArgumentError(f"{what}: {name} must be contiguous")


@profiled("kernel")
def sage_act(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor,
             p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(relu(a + b) * keep / (1 - p), code)`` for contiguous fp32 or
    bf16 ``a``, ``b`` and ``keep`` of one shape and dtype on one device;
    ``code`` is a ``uint8`` tensor of that shape."""
    if a.device.type == "cpu":
        return sage_act_plain(a, b, keep, p)
    _check("sage_act", p, ("a", a, None), ("b", b, None),
           ("keep", keep, None))
    y = torch.empty_like(a)
    code = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
    build.launch(build.load("sage_act", "sage_act", _FWD_ARGTYPES),
                 a.device, a.data_ptr(), b.data_ptr(), keep.data_ptr(),
                 y.data_ptr(), code.data_ptr(), a.numel(), _scale(p),
                 int(a.dtype == torch.bfloat16))
    sage_act.launches += 1
    return y, code


sage_act.launches = 0


@profiled("kernel")
def sage_act_backward(dy: torch.Tensor, code: torch.Tensor,
                      p: float) -> torch.Tensor:
    """The gradient of :func:`sage_act`'s ``a`` (and ``b``) from its
    output's gradient ``dy`` and its ``code``."""
    if dy.device.type == "cpu":
        return sage_act_backward_plain(dy, code, p)
    _check("sage_act_backward", p, ("dy", dy, None),
           ("code", code, torch.uint8))
    dx = torch.empty_like(dy)
    build.launch(build.load("sage_act", "sage_act_backward", _BWD_ARGTYPES),
                 dy.device, dy.data_ptr(), code.data_ptr(), dx.data_ptr(),
                 dy.numel(), _scale(p), int(dy.dtype == torch.bfloat16))
    sage_act_backward.launches += 1
    return dx


sage_act_backward.launches = 0


class SageAct(torch.autograd.Function):
    """:func:`sage_act`'s output with the backward of
    :func:`sage_act_backward`, which hands both addends the same gradient
    (as the add's backward does).  Saves the ``uint8`` code alone: neither
    ReLU's output nor the keep mask is kept for the backward."""

    @staticmethod
    def forward(ctx, a, b, keep, p):
        y, code = sage_act(a, b, keep, p)
        ctx.save_for_backward(code)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, dy):
        code, = ctx.saved_tensors
        dx = sage_act_backward(dy.contiguous(), code, ctx.p)
        return dx, dx, None, None
