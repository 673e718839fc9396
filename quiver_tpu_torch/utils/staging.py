"""Reusable pinned host buffers for host-to-device copies.

The budgeted feature store ships cold rows, faulted pages and gather plans
to the card every batch.  Each kind of payload has one long-lived host
buffer (pinned when the target is the card, so the copy is a DMA that does
not block the host), as the JAX package keeps one staging buffer per
bucket.  A buffer may be rewritten only after its last copy has finished:
:meth:`HostStaging.send` records an event behind the copy on the current
stream, and :meth:`HostStaging.buffer` waits on it before handing the
buffer out again.  On the CPU the "copy" is a clone, so a returned tensor
never aliases a buffer that the next batch rewrites.

:func:`upload` is the one-off form, for a small per-batch payload that
needs no reusable buffer.

Not thread-safe: the owning feature holds its ``_plock`` around use.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["HostStaging", "upload"]


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` on ``device`` without waiting for the stream: a pinned copy,
    then an asynchronous copy to the card (the caching host allocator
    keeps the pinned block until that copy has finished).  A copy from
    pageable memory would wait for the stream first.  On the CPU the
    result wraps ``arr``, as ``torch.from_numpy`` does."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class HostStaging:
    """Named staging buffers for copies to ``device``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        # name -> (uint8 host buffer, event behind its last copy or None)
        self._bufs: Dict[str, Tuple[torch.Tensor, object]] = {}

    def buffer(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host tensor of ``shape`` and ``dtype`` backed by buffer
        ``name``, free to be written: its previous copy has finished."""
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype) \
            .element_size()
        buf, done = self._bufs.get(name, (None, None))
        if done is not None:
            # quiverlint: ignore[QT001] -- the buffer's previous copy must
            # finish before it is rewritten: one event, once per reuse
            done.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=self._pin)
        # quiverlint: ignore[QT008] -- not thread-safe by contract (module
        # docstring): the owner holds Feature._plock or MeshFeature._lock
        # around buffer() and send(); the guard is real, not lexical here
        self._bufs[name] = (buf, None)
        return buf[:nbytes].view(dtype).view(shape)

    def send(self, name: str, host: torch.Tensor) -> torch.Tensor:
        """Copy ``host`` (a tensor from :meth:`buffer` ``name``) to the
        device without waiting for the copy."""
        if not self._pin:
            return host.clone()
        out = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._bufs[name] = (self._bufs[name][0], done)
        return out
