"""Threefry uniform kernel wrapper: ``jax.random.uniform(key, shape)`` on
the card, one launch.

Counterpart of XLA's ``jax.random.uniform`` at the JAX package's three
draw sites under ``sample_rng="key"`` (``quiver_tpu/ops/sample.py:113-116``,
reached from ``:218``, ``:344`` and ``:424``): it replaces no Pallas
kernel.  The CUDA source, ``csrc/threefry_uniform.cu``, says what bounds
it (integer issue) and what its design does about that; its cipher is
``csrc/threefry.cuh``, which kernel B1's keyed instance draws in
registers, so a uniform ``"blocked[:U]"`` hop under the key launches B1
alone and not this kernel.  This kernel serves the keyed ``"pallas"``,
``"xla"`` and ``"lanes*"`` hops, the weighted and the overlay hops.  The
plain version is ``ops/threefry.py::threefry_uniform_plain``.

:func:`threefry_uniform` runs the plain version on the CPU and the kernel
on the card; a kernel that does not build or launch raises.
``threefry_uniform.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import build
from .build import KernelArgumentError
from ..sample import key_words_pair
from ..threefry import num_elements, threefry_uniform_plain
from ...telemetry.profile import profiled
from ...utils.device import resolve_device

__all__ = ["threefry_uniform", "threefry_uniform_plain", "SOURCE",
           "REPLACES"]

SOURCE = "quiver_tpu_torch/csrc/threefry_uniform.cu"
# no TPU kernel: XLA's jax.random.uniform at the key draw sites
REPLACES = "quiver_tpu/ops/sample.py:113"

_ARGTYPES = (ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p)


@profiled("kernel")
def threefry_uniform(key_words, shape: Sequence[int],
                     device=None) -> torch.Tensor:
    """fp32 ``jax.random.uniform`` of ``shape`` for the key whose raw words
    are ``key_words``, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return threefry_uniform_plain(key_words, shape, dev)
    if dev.type != "cuda":
        raise KernelArgumentError(
            f"threefry_uniform: unsupported device {dev}")
    try:
        k0, k1 = key_words_pair(key_words)
        n = num_elements(shape)
    except (TypeError, ValueError, OverflowError) as e:
        raise KernelArgumentError(f"threefry_uniform: {e}") from e
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    build.launch(build.load("threefry_uniform", "threefry_uniform",
                            _ARGTYPES),
                 dev, k0, k1, out.data_ptr(), n)
    threefry_uniform.launches += 1
    return out


threefry_uniform.launches = 0
