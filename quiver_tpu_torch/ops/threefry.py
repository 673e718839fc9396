"""Threefry uniforms: JAX's ``jax.random.uniform(key, shape, float32)``.

Under ``sample_rng="key"`` a sampling hop draws its ``[B, k]`` uniforms
from the hop key's two raw words, as the JAX package does
(``quiver_tpu/ops/sample.py::_uniform``).  JAX 0.9 with
``jax_threefry_partitionable`` on (its default) makes them so: element
``i`` of the row-major flat index hashes the counter pair ``(i >> 32, i &
0xFFFFFFFF)`` with threefry-2x32 under the key, the two output words are
xored, the top 23 bits become the mantissa of a float in ``[1, 2)``
(``(bits >> 9) | 0x3F800000``), and 1.0 is subtracted, exactly.

The entry is ``ops/cuda/threefry.py::threefry_uniform``: on the card one
launch of the kernel ``csrc/threefry_uniform.cu``, on the CPU
:func:`threefry_uniform_plain`, the key chain's cipher
(``utils/rng.py::threefry_rounds``) in int64 with each result masked to
32 bits (torch on the CPU has no uint32 ``>>``).  Both
equal JAX's bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.rng import threefry_rounds
from .sample import key_words_pair

__all__ = ["threefry_uniform_plain", "num_elements"]

_ONE_BITS = 0x3F800000  # 1.0f


def num_elements(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        if int(s) < 0:
            raise ValueError(f"negative dimension in shape {tuple(shape)}")
        n *= int(s)
    return n


def threefry_uniform_plain(key_words, shape: Sequence[int],
                           device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` for a key of two raw words, in
    plain PyTorch on ``device``: the reference for the kernel, on the key
    chain's own cipher (``utils/rng.py::threefry_rounds``)."""
    k0, k1 = key_words_pair(key_words)
    i = torch.arange(num_elements(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry_rounds(k0, k1, i >> 32, i & 0xFFFFFFFF)
    bits = ((x0 ^ x1) >> 9) | _ONE_BITS
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(
        tuple(int(s) for s in shape))
