"""Seeded generators (counterpart of the JAX package's ``utils/rng.py``).

JAX names a PRNG implementation for its keys (``QUIVER_TPU_PRNG``:
``threefry2x32`` by default, or ``rbg``).  The port draws from a seeded
``torch.Generator`` (Philox on the card, Mersenne Twister on the CPU)
whichever name is set: it has no threefry (ROADMAP A2), and the sampler
takes its uniforms from the counter hash, not from a generator.  The name
is still read and checked, so a setting JAX would refuse is refused here
too.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .device import resolve_device

__all__ = ["make_key", "default_impl", "IMPLS"]

IMPLS = ("threefry2x32", "rbg")


def default_impl() -> str:
    """The PRNG implementation's name; ``QUIVER_TPU_PRNG`` overrides."""
    return os.environ.get("QUIVER_TPU_PRNG") or "threefry2x32"


def make_key(seed: int = 0, impl: Optional[str] = None,
             device=None) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    by default).  ``impl`` (or ``QUIVER_TPU_PRNG``) must be one of
    :data:`IMPLS`."""
    name = impl or default_impl()
    if name not in IMPLS:
        raise ValueError(f"PRNG implementation must be one of {IMPLS}, "
                         f"got {name!r}")
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))
