"""Seeded generators and JAX's threefry key chain (counterpart of the JAX
package's ``utils/rng.py`` and of the ``jax.random`` calls its samplers
make).

JAX names a PRNG implementation for its keys (``QUIVER_TPU_PRNG``:
``threefry2x32`` by default, or ``rbg``).  :func:`make_key` is a seeded
``torch.Generator`` (Philox on the card, Mersenne Twister on the CPU)
whichever name is set; the name is still read and checked, so a setting
JAX would refuse is refused here too.

The key chain is JAX's threefry, on the host, in numpy ``uint32``: a key
is two words, :func:`key` makes one from a seed, :func:`split` and
:func:`fold_in` derive keys from a key, and :func:`threefry2x32` is the
hash under both (Salmon et al., "Parallel random numbers: as easy as 1,
2, 3", 20 rounds, rotations 13, 15, 26, 6 / 17, 29, 16, 24, five key
injections).  Each equals JAX 0.9's with ``jax_threefry_partitionable``
on (its default) bit for bit, so a seed gives the port the keys JAX
derives from it.  ``rbg``'s bits are XLA's and differ by backend: no port
can match them, and every key path here refuses that name.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["make_key", "default_impl", "IMPLS", "key", "key_data", "split",
           "fold_in", "threefry2x32", "threefry_rounds"]

IMPLS = ("threefry2x32", "rbg")

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def default_impl() -> str:
    """The PRNG implementation's name; ``QUIVER_TPU_PRNG`` overrides."""
    return os.environ.get("QUIVER_TPU_PRNG") or "threefry2x32"


def _impl(impl: Optional[str]) -> str:
    name = impl or default_impl()
    if name not in IMPLS:
        raise ValueError(f"PRNG implementation must be one of {IMPLS}, "
                         f"got {name!r}")
    return name


def make_key(seed: int = 0, impl: Optional[str] = None,
             device=None) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    by default).  ``impl`` (or ``QUIVER_TPU_PRNG``) must be one of
    :data:`IMPLS`."""
    _impl(impl)
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def threefry_rounds(k0: int, k1: int, x0, x1):
    """Threefry-2x32's key schedule and 20 rounds on uint32 words held in
    int64, each sum and left shift masked back to 32 bits, so the same
    code runs on numpy arrays and on torch tensors (which have no uint32
    ``>>`` on the CPU).  ``k0``/``k1`` are Python ints; returns the two
    output words, int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) & _M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry2x32(k, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` under the key ``k``
    (two words): JAX's ``threefry2x32_p``.  Arrays of any one shape;
    returns uint32."""
    k0, k1 = (int(w) for w in key_data(k))
    y0, y1 = threefry_rounds(
        k0, k1, np.array(x0, dtype=np.uint32, ndmin=1).astype(np.int64),
        np.array(x1, dtype=np.uint32, ndmin=1).astype(np.int64))
    return y0.astype(np.uint32), y1.astype(np.uint32)


def key(seed, impl: Optional[str] = None) -> np.ndarray:
    """The threefry key of an integer ``seed``: ``jax.random.key(seed)``'s
    data (and ``PRNGKey(seed)``), ``[2]`` uint32.

    JAX's default 32-bit mode converts the seed to 32 bits before its
    ``threefry_seed`` splits it into ``[seed >> 32, seed & 0xFFFFFFFF]``,
    so the high word is 0 and the low word is the seed modulo 2**32.  A
    Python int outside int64 raises ``OverflowError``, a non-integer
    ``TypeError``, ``impl="rbg"`` ``ValueError``, as in JAX."""
    if _impl(impl) != "threefry2x32":
        raise ValueError(
            "the port derives keys with threefry2x32 only: rbg's bits are "
            "XLA's and differ by backend, so no port can match them")
    if isinstance(seed, (bool, np.bool_)) or not isinstance(
            seed, (int, np.integer)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    if isinstance(seed, int) and not -2**63 <= seed < 2**63:
        raise OverflowError("Python int too large to convert to C long")
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def key_data(k) -> np.ndarray:
    """The raw words of a key (or of a ``[..., 2]`` stack of keys) as
    uint32: ``jax.random.key_data``."""
    w = np.asarray(k)
    if w.shape[-1:] != (2,):
        raise ValueError(f"a threefry key is two uint32 words; got shape "
                         f"{w.shape}")
    if w.dtype != np.uint32:
        if not np.issubdtype(w.dtype, np.integer) or (
                w.size and (w.min() < 0 or w.max() > 0xFFFFFFFF)):
            raise ValueError("key words must be integers in [0, 2**32)")
        w = w.astype(np.uint32)
    return w


def split(k, num: int = 2) -> np.ndarray:
    """``num`` new keys from ``k``, ``[num, 2]`` uint32:
    ``jax.random.split`` (key i hashes the counter pair ``(0, i)``)."""
    if num < 0:
        raise ValueError(f"split needs num >= 0, got {num}")
    y0, y1 = threefry2x32(k, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def fold_in(k, data: int) -> np.ndarray:
    """A new key from ``k`` and an integer in ``[0, 2**32)``:
    ``jax.random.fold_in`` (the counter pair ``(0, data)``)."""
    data = int(data)
    if not 0 <= data <= 0xFFFFFFFF:
        raise OverflowError(f"Python integer {data} out of bounds for "
                            "uint32")
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)
