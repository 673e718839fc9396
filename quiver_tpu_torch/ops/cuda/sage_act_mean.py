"""A hidden GraphSAGE layer's activation in training fused with the next
layer's neighbour mean, over a positional block, forward and backward.

``sage_act_mean(a, b, keep, p, mask)`` is what
``sage_aggregate(SageAct.apply(a, b, keep, p), nbr_local, mask)`` gives
for a positional block (the no-dedup pipelines' layout, which
``LayerBlock.positional`` declares): slot ``j`` of target ``t`` names row
``T + t*k + j`` of the ``[T * (1 + k), D]`` addends, so ``nbr_local`` is
implied and each row is read by one target alone.  It returns the mean,
the self rows and the activation's code byte (``sage_act.py``'s), from one
launch of ``csrc/sage_act_mean.cu``'s forward kernel; the activation
itself is never written.  :func:`sage_act_mean_backward` turns the two
outputs' gradients and the code into the addends' gradient, each row
written once, with the kernel's backward.  :class:`SageActMean` binds the
two under autograd and saves the code and the mask alone.  Both outputs
are the chain's (``SageAct`` then ``SageMean``) bit for bit.  The kernels
replace no TPU kernel; the source says what bounds them on the H100 and
what their design does.

Plain versions: :func:`sage_act_mean_plain` and
:func:`sage_act_mean_backward_plain` are the chain's arithmetic over the
positional rows (the backward's scatter an ``index_add_``, atomic on the
card as the chain's is).  Each entry runs its plain version for tensors on
the CPU and its kernel for tensors on the card; a kernel that does not
build or launch raises, and arguments the kernel does not take raise
:class:`~.build.KernelArgumentError`: neither falls back.
``sage_act_mean.launches`` and ``sage_act_mean_backward.launches`` count
the kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .build import KernelArgumentError
from .gather_rows import vector_bytes
from .sage_act import _check, _scale, sage_act_backward_plain, sage_act_plain
from .sage_mean import _count
from ...telemetry.profile import profiled

__all__ = ["sage_act_mean", "sage_act_mean_plain", "sage_act_mean_backward",
           "sage_act_mean_backward_plain", "SageActMean", "SOURCE",
           "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/sage_act_mean.cu"
REPLACES = None  # the JAX package leaves activation and aggregation to XLA

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, _P, _I64, _INT, _F32, _P, _P, _P, _I64, _INT,
                 _INT, _P)
_BWD_ARGTYPES = (_P, _P, _P, _I64, _INT, _F32, _P, _P, _I64, _INT, _INT, _P)
_INT32_MAX = 2**31 - 1


def _slot_rows(mask: torch.Tensor) -> torch.Tensor:
    """``[T, k]`` int64: the row ``T + t*k + j`` slot ``j`` of target ``t``
    names in a positional block."""
    t, k = mask.shape
    return t + torch.arange(t * k, device=mask.device).view(t, k)


def sage_act_mean_plain(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor,
                        p: float, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain's arithmetic: ``sage_act``'s activation and code, then
    the valid slots' rows added in slot order in fp32 (fp64 for fp64
    addends), rounded once, divided by the count; and the self rows."""
    t, k = mask.shape
    y, code = sage_act_plain(a, b, keep, p)
    slots = y[t:].view(t, k, y.shape[1])
    acc_dtype = torch.promote_types(y.dtype, torch.float32)
    acc = torch.zeros((t, y.shape[1]), dtype=acc_dtype, device=y.device)
    for j in range(k):
        acc = torch.where(mask[:, j, None], acc + slots[:, j].to(acc_dtype),
                          acc)
    return acc.to(y.dtype) / _count(mask, y.dtype), y[:t].clone(), code


def sage_act_mean_backward_plain(grad_mean: Optional[torch.Tensor],
                                 grad_self: Optional[torch.Tensor],
                                 code: torch.Tensor, mask: torch.Tensor,
                                 p: float) -> torch.Tensor:
    """The chain's backward: the activation's output gradient built as the
    mean's backward builds it (``grad_self``, or zeros, in the first ``T``
    rows, zeros elsewhere, ``grad_mean / count`` added into each valid
    slot's row), then ``sage_act``'s backward."""
    t, k = mask.shape
    ref = grad_mean if grad_mean is not None else grad_self
    dy = torch.zeros(code.shape, dtype=ref.dtype, device=ref.device)
    if grad_self is not None:
        dy[:t] = grad_self
    if grad_mean is not None:
        g = grad_mean / _count(mask, grad_mean.dtype)
        rows = _slot_rows(mask)
        dy.index_add_(0, rows[mask], g[:, None, :].expand(t, k, -1)[mask])
    return sage_act_backward_plain(dy, code, p)


def _check_block(what: str, mask: torch.Tensor, n: int,
                 device: torch.device) -> None:
    if (mask.dtype != torch.bool or mask.dim() != 2
            or not mask.is_contiguous() or mask.device != device):
        raise KernelArgumentError(
            f"{what}: mask must be a contiguous 2-D bool tensor on {device}")
    t, k = mask.shape
    if t * (1 + k) != n:
        raise KernelArgumentError(
            f"{what}: a [{t}, {k}] positional block takes {t * (1 + k)} "
            f"rows, got {n}")
    if k > _INT32_MAX:
        raise KernelArgumentError(f"{what}: over 2**31 slots a target")


@profiled("kernel")
def sage_act_mean(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor,
                  p: float, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean [T, D], x_self [T, D], code [N, D] uint8)`` for contiguous
    fp32 or bf16 ``a``, ``b`` and ``keep`` ``[N, D]`` of one dtype and the
    next layer's positional block's ``mask [T, k]``, ``N = T * (1 + k)``,
    all on one device."""
    if a.device.type == "cpu":
        return sage_act_mean_plain(a, b, keep, p, mask)
    what = "sage_act_mean"
    _check(what, p, ("a", a, None), ("b", b, None), ("keep", keep, None))
    if a.dim() != 2:
        raise KernelArgumentError(f"{what}: a must be 2-D")
    n, d = a.shape
    _check_block(what, mask, n, a.device)
    t, k = mask.shape
    mean = torch.empty((t, d), dtype=a.dtype, device=a.device)
    x_self = torch.empty((t, d), dtype=a.dtype, device=a.device)
    code = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
    row_bytes = d * a.element_size()
    build.launch(build.load("sage_act_mean", "sage_act_mean", _FWD_ARGTYPES),
                 a.device, a.data_ptr(), b.data_ptr(), keep.data_ptr(),
                 mask.data_ptr(), t, k, _scale(p), x_self.data_ptr(),
                 mean.data_ptr(), code.data_ptr(), row_bytes,
                 vector_bytes(row_bytes, a.data_ptr(), b.data_ptr(),
                              keep.data_ptr()),
                 int(a.dtype == torch.bfloat16))
    sage_act_mean.launches += 1
    return mean, x_self, code


sage_act_mean.launches = 0


@profiled("kernel")
def sage_act_mean_backward(grad_mean: Optional[torch.Tensor],
                           grad_self: Optional[torch.Tensor],
                           code: torch.Tensor, mask: torch.Tensor,
                           p: float) -> torch.Tensor:
    """The gradient ``[N, D]`` of :func:`sage_act_mean`'s ``a`` (and
    ``b``) from its outputs' gradients ``grad_mean`` and ``grad_self``
    (``[T, D]`` each, either ``None`` for zeros, not both) and its
    ``code``."""
    ref = grad_mean if grad_mean is not None else grad_self
    if ref is None:
        raise KernelArgumentError(
            "sage_act_mean_backward: needs grad_mean or grad_self")
    if ref.device.type == "cpu":
        return sage_act_mean_backward_plain(grad_mean, grad_self, code, mask,
                                            p)
    what = "sage_act_mean_backward"
    t, k = mask.shape if mask.dim() == 2 else (-1, -1)
    rows = [(n, g, None) for n, g in (("grad_mean", grad_mean),
                                      ("grad_self", grad_self))
            if g is not None]
    _check(what, p, *rows)
    if ref.dim() != 2 or ref.shape[0] != t:
        raise KernelArgumentError(
            f"{what}: the gradients must be [T, D] for a [T, k] mask")
    if (code.dtype != torch.uint8 or code.dim() != 2
            or code.shape[1] != ref.shape[1] or not code.is_contiguous()
            or code.device != ref.device):
        raise KernelArgumentError(
            f"{what}: code must be a contiguous [N, D] uint8 tensor on "
            f"{ref.device}")
    n, d = code.shape
    _check_block(what, mask, n, ref.device)
    dx = torch.empty((n, d), dtype=ref.dtype, device=ref.device)
    row_bytes = d * ref.element_size()
    build.launch(build.load("sage_act_mean", "sage_act_mean_backward",
                            _BWD_ARGTYPES),
                 ref.device,
                 None if grad_mean is None else grad_mean.data_ptr(),
                 None if grad_self is None else grad_self.data_ptr(),
                 mask.data_ptr(), t, k, _scale(p), code.data_ptr(),
                 dx.data_ptr(), row_bytes,
                 vector_bytes(row_bytes, *(g.data_ptr() for _, g, _ in rows)),
                 int(ref.dtype == torch.bfloat16))
    sage_act_mean_backward.launches += 1
    return dx


sage_act_mean_backward.launches = 0


class SageActMean(torch.autograd.Function):
    """``(mean, x_self)`` of :func:`sage_act_mean` with the backward of
    :func:`sage_act_mean_backward`, which hands both addends the same
    gradient.  Saves the ``uint8`` code and the mask alone: neither the
    activation nor its gradient is ever held."""

    @staticmethod
    def forward(ctx, a, b, keep, p, mask):
        ctx.set_materialize_grads(False)
        mean, x_self, code = sage_act_mean(a, b, keep, p, mask)
        ctx.save_for_backward(code, mask)
        ctx.p = p
        return mean, x_self

    @staticmethod
    def backward(ctx, grad_mean, grad_self):
        if grad_mean is None and grad_self is None:
            return None, None, None, None, None
        code, mask = ctx.saved_tensors
        dx = sage_act_mean_backward(
            None if grad_mean is None else grad_mean.contiguous(),
            None if grad_self is None else grad_self.contiguous(),
            code, mask, ctx.p)
        return dx, dx, None, None, None
