"""GraphSAGE's masked neighbour mean on the card, forward and backward.

``sage_mean(x, nbr_local, mask)`` is, for each target ``t`` of a dense
``[T, k]`` block, the sum of ``x[nbr_local[t, j]]`` over the slots ``j``
where ``mask[t, j]``, in slot order, divided by the number of such slots
(1 where there is none): one launch of ``csrc/sage_mean.cu``'s forward
kernel.  :func:`sage_mean_backward` scatters ``grad_mean / count`` into a
gradient of ``x`` with the kernel's backward, after the self rows'
gradient.  :class:`SageMean` binds the two under autograd and also returns
the self rows ``x[:T]``, so that ``x``'s whole gradient is one buffer.
Indices are clamped to ``x``'s rows, as JAX's gather clamps.  The kernels
replace no TPU kernel (the JAX package leaves the aggregation to XLA); the
source says what bounds them on the H100 and what their design does.

Plain versions: :func:`sage_mean_plain` (a loop over the slots in the
kernel's order; masked slots add nothing) and
:func:`sage_mean_backward_plain`.  Each entry runs its plain version for
tensors on the CPU and its kernel for tensors on the card; a kernel that
does not build or launch raises, and arguments the kernel does not take
raise :class:`~.build.KernelArgumentError`: neither falls back.
``sage_mean.launches`` and ``sage_mean_backward.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .build import KernelArgumentError
from .gather_rows import vector_bytes
from ...telemetry.profile import profiled

__all__ = ["sage_mean", "sage_mean_plain", "sage_mean_backward",
           "sage_mean_backward_plain", "sage_aggregate", "SageMean",
           "SOURCE", "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/sage_mean.cu"
REPLACES = None  # the JAX package leaves the aggregation to XLA

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_FWD_ARGTYPES = (_P, _I64, _P, _P, _I64, _INT, _P, _I64, _INT, _INT, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _I64, _INT, _P, _I64, _I64, _INT, _INT, _P)
_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1


def _count(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[T, 1]`` valid slots a target, at least 1, in ``dtype`` (rounded
    to it, as a sum of a ``dtype`` mask is)."""
    return mask.sum(dim=1, keepdim=True).clamp_min(1).to(dtype)


def sage_mean_plain(x: torch.Tensor, nbr_local: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the valid slots' rows
    added in slot order in fp32 (fp64 for fp64 ``x``), rounded once to
    ``x``'s dtype, divided by the count."""
    t, k = nbr_local.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    idx = nbr_local.to(torch.int64).clamp(0, max(x.shape[0] - 1, 0))
    acc = torch.zeros((t, x.shape[1]), dtype=acc_dtype, device=x.device)
    for j in range(k):
        rows = x.index_select(0, idx[:, j]).to(acc_dtype)
        acc = torch.where(mask[:, j, None], acc + rows, acc)
    return acc.to(x.dtype) / _count(mask, x.dtype)


def sage_mean_backward_plain(grad_mean: torch.Tensor,
                             nbr_local: torch.Tensor, mask: torch.Tensor,
                             n: int,
                             grad_self: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The backward kernel's arithmetic in plain PyTorch: ``grad_self``
    (or zeros) in the first ``T`` rows of an ``[n, D]`` zero gradient, then
    ``grad_mean / count`` added into each valid slot's row, slot by
    slot."""
    t, k = nbr_local.shape
    g = grad_mean / _count(mask, grad_mean.dtype)
    grad_x = torch.zeros((n, grad_mean.shape[1]), dtype=grad_mean.dtype,
                         device=grad_mean.device)
    if grad_self is not None:
        grad_x[:t] = grad_self
    idx = nbr_local.to(torch.int64).clamp(0, max(n - 1, 0))
    for j in range(k):
        valid = mask[:, j]
        grad_x.index_add_(0, idx[valid, j], g[valid])
    return grad_x


def _check_slots(what: str, nbr_local: torch.Tensor, mask: torch.Tensor,
                 device: torch.device) -> None:
    if (nbr_local.dtype != torch.int32 or nbr_local.dim() != 2
            or not nbr_local.is_contiguous() or nbr_local.device != device):
        raise KernelArgumentError(
            f"{what}: nbr_local must be a contiguous 2-D int32 tensor on "
            f"{device}")
    if (mask.dtype != torch.bool or mask.shape != nbr_local.shape
            or not mask.is_contiguous() or mask.device != device):
        raise KernelArgumentError(
            f"{what}: mask must be a contiguous bool tensor of nbr_local's "
            f"shape on {device}")
    if nbr_local.shape[1] > _INT32_MAX:
        raise KernelArgumentError(f"{what}: over 2**31 slots a target")


def _check_rows(what: str, name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise KernelArgumentError(f"{what}: unsupported device {t.device}")
    if t.dtype not in _DTYPES:
        raise KernelArgumentError(
            f"{what}: {name} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise KernelArgumentError(
            f"{what}: {name} must be a contiguous 2-D tensor")


@profiled("kernel")
def sage_mean(x: torch.Tensor, nbr_local: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """``[T, D]`` masked mean of ``x [N, D]``'s rows at ``nbr_local [T,
    k]`` where ``mask [T, k]``; fp32 or bf16 ``x``, int32 ``nbr_local``
    (``LayerBlock``'s), all contiguous on one device."""
    if x.device.type == "cpu":
        return sage_mean_plain(x, nbr_local, mask)
    _check_rows("sage_mean", "x", x)
    _check_slots("sage_mean", nbr_local, mask, x.device)
    n, d = x.shape
    t, k = nbr_local.shape
    if n > _INT32_MAX:
        raise KernelArgumentError("sage_mean: x has 2**31 rows or more")
    if n == 0 and k and t:
        raise KernelArgumentError("sage_mean: slots into an x with no rows")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    row_bytes = d * x.element_size()
    build.launch(build.load("sage_mean", "sage_mean", _FWD_ARGTYPES),
                 x.device, x.data_ptr(), n, nbr_local.data_ptr(),
                 mask.data_ptr(), t, k,
                 out.data_ptr(), row_bytes,
                 vector_bytes(row_bytes, x.data_ptr()),
                 int(x.dtype == torch.bfloat16))
    sage_mean.launches += 1
    return out


sage_mean.launches = 0


@profiled("kernel")
def sage_mean_backward(grad_mean: torch.Tensor, nbr_local: torch.Tensor,
                       mask: torch.Tensor, n: int,
                       grad_self: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The gradient ``[n, D]`` of :func:`sage_mean`'s ``x`` (``n`` rows)
    from the mean's gradient ``grad_mean [T, D]``, plus ``grad_self [T,
    D]`` in its first ``T`` rows when given: the gradient of ``x[:T]``."""
    if grad_mean.device.type == "cpu":
        return sage_mean_backward_plain(grad_mean, nbr_local, mask, n,
                                        grad_self)
    what = "sage_mean_backward"
    _check_rows(what, "grad_mean", grad_mean)
    _check_slots(what, nbr_local, mask, grad_mean.device)
    t, d = grad_mean.shape
    if nbr_local.shape[0] != t:
        raise KernelArgumentError(
            f"{what}: grad_mean has {t} rows, nbr_local {nbr_local.shape[0]}")
    if not 0 <= n <= _INT32_MAX:
        raise KernelArgumentError(f"{what}: n must be in [0, 2**31)")
    if grad_self is not None:
        _check_rows(what, "grad_self", grad_self)
        if (grad_self.shape != grad_mean.shape
                or grad_self.dtype != grad_mean.dtype
                or grad_self.device != grad_mean.device or t > n):
            raise KernelArgumentError(
                f"{what}: grad_self must be a [T, D] tensor like grad_mean, "
                "T at most n")
    if n == 0 and bool(mask.any()):
        raise KernelArgumentError(f"{what}: slots into an x with no rows")
    grad_x = torch.empty((n, d), dtype=grad_mean.dtype,
                         device=grad_mean.device)
    row_bytes = d * grad_mean.element_size()
    ptrs = [grad_mean.data_ptr(), grad_x.data_ptr()]
    if grad_self is not None:
        ptrs.append(grad_self.data_ptr())
    build.launch(build.load("sage_mean", "sage_mean_backward", _BWD_ARGTYPES),
                 grad_mean.device, grad_mean.data_ptr(),
                 None if grad_self is None else grad_self.data_ptr(),
                 nbr_local.data_ptr(), mask.data_ptr(), t, nbr_local.shape[1],
                 grad_x.data_ptr(), n,
                 row_bytes, vector_bytes(row_bytes, *ptrs),
                 int(grad_mean.dtype == torch.bfloat16))
    sage_mean_backward.launches += 1
    return grad_x


sage_mean_backward.launches = 0


class SageMean(torch.autograd.Function):
    """``(sage_mean(x, nbr_local, mask), x[:T])`` with the backward of
    :func:`sage_mean_backward`: the gradients of both outputs land in one
    ``[N, D]`` buffer, and autograd adds none."""

    @staticmethod
    def forward(ctx, x, nbr_local, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(nbr_local, mask)
        ctx.n = x.shape[0]
        return sage_mean(x, nbr_local, mask), x[:nbr_local.shape[0]]

    @staticmethod
    def backward(ctx, grad_mean, grad_self):
        nbr_local, mask = ctx.saved_tensors
        if grad_mean is None:
            if grad_self is None:
                return None, None, None
            grad_mean = torch.zeros_like(grad_self)
        grad_x = sage_mean_backward(
            grad_mean.contiguous(), nbr_local, mask, ctx.n,
            None if grad_self is None else grad_self.contiguous())
        return grad_x, None, None


def sage_aggregate(x: torch.Tensor, nbr_local: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAGEConv's two inputs from ``x``: the masked neighbour mean and the
    self rows ``x[:T]``.  Through :class:`SageMean` where ``x`` needs a
    gradient, else one call of :func:`sage_mean` and a view."""
    x = x.contiguous()
    nbr_local, mask = nbr_local.contiguous(), mask.contiguous()
    if x.requires_grad and torch.is_grad_enabled():
        return SageMean.apply(x, nbr_local, mask)
    return sage_mean(x, nbr_local, mask), x[:nbr_local.shape[0]]
