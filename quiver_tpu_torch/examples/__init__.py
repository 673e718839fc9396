"""User entry points: the PyTorch counterparts of the JAX package's nine
example scripts, one module each under the same file name.

Each module runs as ``python -m quiver_tpu_torch.examples.<name>``, keeps
its JAX script's flags, defaults and printed lines, and adds ``--device``
(default ``cuda``; it raises where there is no card, never falling back to
the CPU: the tests pass ``--device cpu``).  ``main(argv=None,
report=None) -> int`` is the entry; a caller that passes a dict as
``report`` gets the run's first seed batch, losses and times in it.

The helpers below are what the modules share: the ``--device`` flag, the
key words a JAX script draws from ``PRNGKey(i)``, seeded model weights and
a host clock that waits for the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["EXAMPLES", "add_device_flag", "device_of", "key_words",
           "seeded", "Clock", "losses_of", "put", "mesh_devices"]

# the nine modules, in the order their README lists them
EXAMPLES = ("reddit_sage", "ogbn_products_sage", "graph_sage_unsup",
            "papers100M_dist", "mag240m_rgat", "serving_reddit",
            "preprocess_partition", "big_graph_single_chip",
            "dgl_products_sage")


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the example runs: 'cuda' (the default; "
                         "raises without a card) or 'cpu', where every "
                         "kernel runs its plain PyTorch version")


def device_of(args) -> torch.device:
    """``args.device`` resolved; raises where it names a missing card."""
    return resolve_device(args.device)


def mesh_devices(dev: torch.device, n: int) -> list:
    """The devices of a mesh of ``n`` shards on ``dev``'s type: the
    visible cards in turn (one card repeated ``n`` times on a one-card
    machine), or the CPU ``n`` times.  ``n`` = 0: every visible card, or
    one CPU device."""
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        n = n or len(cards)
        return [cards[i % len(cards)] for i in range(n)]
    return [dev] * (n or 1)


def key_words(i: int, hops: int, width: int = 2) -> np.ndarray:
    """``[hops, width]`` uint32 sampling key words of step ``i``: what a
    JAX script's ``PRNGKey(i)`` is to its sampler, drawn from
    ``default_rng(i)``."""
    return np.random.default_rng(i).integers(0, 2**32, (hops, width),
                                             dtype=np.uint32)


@contextlib.contextmanager
def seeded(seed: int, device: torch.device) -> Iterator[None]:
    """Model weights built inside the block come from ``seed`` (JAX's
    ``model.init(PRNGKey(seed), ...)``); the global generators' states are
    put back after."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


class Clock:
    """Host seconds that include the card's queued work: ``lap()`` waits
    for the card, then reads the clock (JAX's ``block_until_ready``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = time.perf_counter()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self) -> float:
        self.sync()
        return time.perf_counter() - self.t0

    def reset(self) -> None:
        self.sync()
        self.t0 = time.perf_counter()


def losses_of(losses) -> list:
    """Host floats of a list of 0-d loss tensors, read once at the end of
    a loop (reading each one in the loop would wait for the card every
    step)."""
    if not losses:
        return []
    return [float(x) for x in torch.stack(list(losses)).cpu()]


def put(report: Optional[dict], **items) -> None:
    """Record ``items`` in the caller's ``report`` dict, if it gave one."""
    if report is not None:
        report.update(items)
