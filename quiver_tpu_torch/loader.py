"""Seed loader, the training loop's front end (counterpart of
``quiver_tpu/loader.py``).

The reference drives sampling with a ``DataLoader`` over the train ids
and calls the sampler and the feature per batch.  :class:`SeedLoader`
packages that loop: epoch shuffling, a fixed batch shape (the last
partial batch padded and masked), the next batch sampled one step ahead
with its feature rows prefetched (``Feature.prefetch``), and the whole
batch built on a worker thread (``Prefetcher``).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .parallel.prefetch import Prefetcher

__all__ = ["SeedLoader"]


class SeedLoader:
    """Iterate epochs of ``(SampledBatch, features, labels, label_mask)``.

    Args:
      train_idx: ``[T]`` seed node ids.
      sampler: :class:`GraphSageSampler`.
      feature: :class:`Feature` (or anything indexed by node ids).
      labels: optional ``[N]`` label array (zeros when ``None``).
      batch_size: fixed batch size; the last partial batch is padded with
        its first seed and masked by ``label_mask``.
      shuffle: shuffle the seeds each epoch (numpy generator of ``seed``).
      drop_last: drop the last partial batch.
      prefetch: depth of the batch queue (0: build batches in the caller).
      seed: seed of the shuffle.
      key_words_fn: ``(epoch, i) -> [L, 2]`` uint32 key words of batch
        ``i`` (epochs count from 1).  Default: the sampler draws them from
        its own generator, in batch order.
    """

    def __init__(self, train_idx, sampler, feature, labels=None,
                 batch_size: int = 1024, shuffle: bool = True,
                 drop_last: bool = False, prefetch: int = 2, seed: int = 0,
                 key_words_fn: Optional[Callable] = None):
        # a copy: the epoch shuffle is in place
        self.train_idx = np.array(train_idx, copy=True)
        self.sampler = sampler
        self.feature = feature
        self.labels = None if labels is None else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.key_words_fn = key_words_fn
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self._lookahead = {}

    def __len__(self):
        n = len(self.train_idx)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _sample(self, i: int):
        B = self.batch_size
        seeds = self.train_idx[i * B: (i + 1) * B]
        valid = len(seeds)
        if valid < B:  # pad to the fixed shape, mask the tail
            seeds = np.concatenate(
                [seeds, np.repeat(seeds[:1] if valid else [0], B - valid)])
        kw = (self.key_words_fn(self._epoch, i) if self.key_words_fn
              else self.sampler.draw_key_words())
        return seeds, valid, self.sampler.sample(seeds, key_words=kw)

    def _make(self, i: int):
        B = self.batch_size
        e = self._epoch  # a batch sampled ahead belongs to its epoch
        got = self._lookahead.pop((e, i), None)
        seeds, valid, batch = got if got is not None else self._sample(i)
        if i + 1 < len(self):
            # sample batch i+1 now and start its feature gather, so the
            # host side of that gather runs while batch i trains
            nxt = self._sample(i + 1)
            self._lookahead[(e, i + 1)] = nxt
            if hasattr(self.feature, "prefetch"):
                self.feature.prefetch(nxt[2].n_id)
        x = self.feature[batch.n_id.cpu().numpy()]
        dev = batch.n_id.device
        mask = torch.arange(B, device=dev) < valid
        if self.labels is not None:
            labels = torch.from_numpy(
                np.ascontiguousarray(self.labels[seeds])).to(dev)
        else:
            labels = torch.zeros((B,), dtype=torch.int32, device=dev)
        return batch, x, labels, mask

    def __iter__(self) -> Iterator:
        if self.shuffle:
            self._rng.shuffle(self.train_idx)
        self._epoch += 1
        self._lookahead = {}
        n = len(self)
        if self.prefetch > 0:
            return iter(Prefetcher(range(n), self._make,
                                   depth=self.prefetch))
        return (self._make(i) for i in range(n))
