"""Prefetch of sample and gather ahead of the train step (counterpart of
``quiver_tpu/parallel/prefetch.py``).

Device work is already asynchronous on the card (launches return at
once); what needs overlapping is the host side: seed batches, the one
read-back of ``n_id``, and the cold-tail gather of a budgeted feature.
:class:`Prefetcher` runs ``make_batch`` on a worker thread behind a
bounded queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

from ..ops.sample import sample_neighbors
from ..utils.device import resolve_device
from ..utils.shutdown import join_and_reap

__all__ = ["Prefetcher", "AsyncNeighborSampler", "AsyncCudaNeighborSampler"]

_END = object()


class Prefetcher:
    """Iterate ``make_batch(item)`` over ``items``, built on a worker
    thread up to ``depth`` batches ahead of the consumer.

    :meth:`stop` ends an iteration from any thread: the worker's bounded
    put and the consumer's get both watch the stop flag, so a consumer
    that stopped reading cannot leave the worker blocked on a full queue.
    An exception in ``make_batch`` is raised to the consumer.
    """

    def __init__(self, items: Iterable, make_batch: Callable, depth: int = 2):
        self.items = list(items)
        self.make_batch = make_batch
        self.depth = depth
        self._stop = threading.Event()
        self._thread = None

    def __len__(self):
        return len(self.items)

    def stop(self) -> None:
        """Request the end of the current iteration (idempotent)."""
        self._stop.set()

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        exc = []
        stop = self._stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for it in self.items:
                    if stop.is_set() or not put(self.make_batch(it)):
                        return
            except BaseException as e:  # re-raised by the consumer
                exc.append(e)
            finally:
                put(_END)

        t = threading.Thread(target=worker, daemon=True,
                             name="quiver-prefetch")
        self._thread = t
        t.start()
        try:
            while True:
                try:
                    out = q.get(timeout=0.2)
                except queue.Empty:
                    # stopped and the worker gone: no _END is coming
                    if stop.is_set() and not t.is_alive():
                        break
                    continue
                if out is _END:
                    break
                yield out
        finally:
            stop.set()
            join_and_reap([t], timeout=5.0, component="prefetcher")
        if exc:
            raise exc[0]


class AsyncNeighborSampler:
    """One-hop sampler whose :meth:`sample_async` returns as soon as the
    hop is launched (the reference's ``AsyncCudaNeighborSampler``)."""

    def __init__(self, csr_topo, k: int, device=None):
        self.device = resolve_device(device)
        self.csr_topo = csr_topo
        self.k = k
        csr_topo.to_device(self.device)

    def sample_async(self, seeds, key_words):
        """Launch one hop of ``seeds`` under ``key_words`` ``(k0, k1)``;
        the :class:`SampleOut` tensors are ready when the stream is."""
        indptr, indices = self.csr_topo.to_device(self.device)
        seeds = torch.as_tensor(seeds).to(self.device, torch.int32)
        return sample_neighbors(indptr, indices, seeds, self.k, key_words,
                                device=self.device)

    def sample(self, seeds, key_words):
        """:meth:`sample_async`, then wait for the card."""
        out = self.sample_async(seeds, key_words)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out


# the reference's name (``async_cuda_sampler.py``)
AsyncCudaNeighborSampler = AsyncNeighborSampler
