"""PyG and DGL interop (counterpart of ``quiver_tpu/interop.py``).

The reference is a PyG add-on whose sampler returns ``(n_id, batch_size,
adjs)`` for a PyG training loop; these helpers give the port's batches the
same form.  Where the JAX package converts host numpy arrays, the port's
batches are already torch tensors: :func:`to_torch_adjs` builds the edge
lists on the batch's device, with no copy to the host, and
:class:`TorchSampleLoader` gathers features on the feature's device
(kernel B2 for a whole-table feature).  The values equal the JAX
package's.  ``dgl`` is imported only by :func:`to_dgl_blocks`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["to_torch_adjs", "to_torch", "TorchSampleLoader", "block_specs",
           "to_dgl_blocks"]


def to_torch(x) -> torch.Tensor:
    """A tensor as it is; anything else through numpy (sharing memory on
    the host)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def to_torch_adjs(batch):
    """:class:`SampledBatch` -> PyG-style ``(n_id, batch_size, adjs)`` on the
    batch's device, each adj ``(edge_index [2, e] int64, e_id int64,
    (n_src, n_dst))``, the sizes the padded frontier lengths (each hop's
    targets a prefix of its sources).  ``SampledBatch.to_pyg_adjs`` is its
    host copy.  ``e_id`` is empty unless the sampler returns edge ids."""
    adjs = []
    n_src = int(batch.n_id.shape[0])
    for blk in batch.layers:
        t, k = blk.mask.shape
        e = blk.mask.reshape(-1)
        row = torch.arange(t, device=e.device).repeat_interleave(k)
        col = blk.nbr_local.reshape(-1).long()
        edge_index = torch.stack([col[e], row[e]])
        e_id = (blk.eid.reshape(-1)[e].long() if blk.eid is not None
                else torch.empty(0, dtype=torch.int64, device=e.device))
        adjs.append((edge_index, e_id, (n_src, t)))
        n_src = t
    return batch.n_id.long(), batch.batch_size, adjs


class TorchSampleLoader:
    """Iterate ``(n_id, batch_size, adjs, x, y)`` batches from a sampler and
    a feature store, the reference's ``for seeds in loader: sample;
    feature[n_id]; model(...)`` loop packaged for a torch script.

    ``x`` is ``feature[batch.n_id]`` and ``y`` the seeds' labels, both on
    the batch's device.  ``key_words_fn(i)``, when given, supplies batch
    ``i``'s key words (tests hand in the JAX package's).
    """

    def __init__(self, train_idx, sampler, feature, labels=None,
                 batch_size: int = 1024, shuffle: bool = True, seed: int = 0,
                 key_words_fn: Optional[Callable[[int], np.ndarray]] = None):
        self.train_idx = np.array(train_idx, copy=True)
        self.sampler = sampler
        self.feature = feature
        self.labels = None if labels is None else np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.key_words_fn = key_words_fn
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.train_idx) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self.shuffle:
            self._rng.shuffle(self.train_idx)
        B = self.batch_size
        for i in range(len(self)):
            seeds = self.train_idx[i * B: (i + 1) * B]
            kw = None if self.key_words_fn is None else self.key_words_fn(i)
            batch = self.sampler.sample(seeds, key_words=kw)
            n_id, bs, adjs = to_torch_adjs(batch)
            x = self.feature[batch.n_id]
            y = (None if self.labels is None else
                 torch.from_numpy(self.labels[seeds]).to(batch.n_id.device))
            yield n_id, bs, adjs, x, y


def block_specs(batch):
    """:class:`SampledBatch` -> per-layer message-flow-graph specs ``(src,
    dst, eid, n_src, n_dst)`` as host numpy, outermost layer first:
    ``dgl.create_block((src, dst), num_src_nodes=n_src,
    num_dst_nodes=n_dst)``'s arguments, the targets a prefix of the
    sources.  ``eid`` is empty unless the sampler returns edge ids."""
    _, _, adjs = batch.to_pyg_adjs()
    return [(edge_index[0], edge_index[1], e_id, int(n_src), int(n_dst))
            for edge_index, e_id, (n_src, n_dst) in adjs]


def to_dgl_blocks(batch):
    """:class:`SampledBatch` -> DGL blocks (outermost first), sampled edge
    ids in ``block.edata["_ID"]`` when the sampler returns them.  Needs
    ``dgl``."""
    import dgl

    blocks = []
    for src, dst, eid, n_src, n_dst in block_specs(batch):
        b = dgl.create_block(
            (torch.from_numpy(src.astype(np.int64)),
             torch.from_numpy(dst.astype(np.int64))),
            num_src_nodes=n_src, num_dst_nodes=n_dst)
        if len(eid) == len(src):
            b.edata["_ID"] = torch.from_numpy(eid.astype(np.int64))
        blocks.append(b)
    return blocks
