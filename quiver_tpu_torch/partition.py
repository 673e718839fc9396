"""Offline probability-weighted feature partitioning (counterpart of
``quiver_tpu/partition.py``; host numpy, no device).

Nodes are assigned in probability-descending chunks to the partition where
their own access probability most exceeds the other partitions', taking
equal shares, and each partition's rows are written under ``result_path``
in the JAX package's layout.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "partition_without_replication",
    "select_nodes",
    "partition_feature_without_replication",
    "quiver_partition_feature",
    "load_quiver_feature_partition",
]

CHUNK_NUM = 32


def _host_probs(probs) -> List[np.ndarray]:
    """Each probability vector as float64 numpy (a tensor is read back)."""
    return [(p.cpu().numpy() if isinstance(p, torch.Tensor)
             else np.asarray(p)).astype(np.float64) for p in probs]


def partition_without_replication(
    probs: Sequence[np.ndarray], ids: Optional[np.ndarray] = None,
    chunk_num: int = CHUNK_NUM,
) -> List[np.ndarray]:
    """Assign each node to exactly one partition.

    Args:
      probs: per-partition access-probability vectors ``[N]`` (from
        ``GraphSageSampler.sample_prob`` per partition's train set).
      ids: optional subset of node ids to partition (default: all).

    Greedy chunked scheme (the reference's partition.py:16-80): process nodes in
    descending total probability, in ``chunk_num`` rounds; within a round
    each partition takes (from the still-unassigned chunk) the nodes where
    its own probability minus the sum of the others' is largest, taking
    equal shares.
    """
    probs = _host_probs(probs)
    n_parts = len(probs)
    N = probs[0].shape[0]
    if ids is None:
        ids = np.arange(N, dtype=np.int64)
    else:
        ids = np.asarray(ids, dtype=np.int64)
    total = sum(p[ids] for p in probs)
    order = ids[np.argsort(-total, kind="stable")]
    res: List[List[np.ndarray]] = [[] for _ in range(n_parts)]
    chunks = np.array_split(order, chunk_num)
    for ci, chunk in enumerate(chunks):
        if len(chunk) == 0:
            continue
        remaining = chunk.copy()
        share = int(np.ceil(len(chunk) / n_parts))
        # rotate the starting partition per chunk so small chunks don't
        # starve the high-numbered partitions
        for p in [(ci + q) % n_parts for q in range(n_parts)]:
            if len(remaining) == 0:
                break
            own = probs[p][remaining]
            others = sum(probs[q][remaining] for q in range(n_parts)
                         if q != p)
            score = own - others
            take = min(share, len(remaining))
            pick = np.argsort(-score, kind="stable")[:take]
            res[p].append(remaining[pick])
            keep = np.ones(len(remaining), dtype=bool)
            keep[pick] = False
            remaining = remaining[keep]
        if len(remaining):
            res[-1].append(remaining)
    return [
        np.concatenate(r) if r else np.empty(0, dtype=np.int64) for r in res
    ]


def select_nodes(probs: Sequence[np.ndarray], ids=None):
    """Split nodes into (accessed-by-any, never-accessed) (the reference's partition.py:83)."""
    total = sum(_host_probs(probs))
    if ids is not None:
        mask = np.zeros_like(total, dtype=bool)
        mask[np.asarray(ids)] = True
        total = np.where(mask, total, 0)
    accessed = np.nonzero(total > 0)[0]
    unaccessed = np.nonzero(total <= 0)[0]
    return accessed, unaccessed


def partition_feature_without_replication(
    probs: Sequence[np.ndarray], chunk_num: int = CHUNK_NUM
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Partition accessed nodes; also return per-partition hot-cache order.

    Returns (partition id lists, per-partition probability-descending cache
    order within the partition, unaccessed ids), as in the reference's
    partition.py:95-160, where each partition also gets a cache priority.
    """
    probs = _host_probs(probs)
    accessed, unaccessed = select_nodes(probs)
    parts = partition_without_replication(probs, accessed, chunk_num)
    orders = []
    for p, part in enumerate(parts):
        pr = probs[p][part]
        orders.append(part[np.argsort(-pr, kind="stable")])
    return parts, orders, unaccessed


def quiver_partition_feature(
    feature: np.ndarray, probs: Sequence[np.ndarray], result_path: str,
    chunk_num: int = CHUNK_NUM,
):
    """Write partition artifacts to disk (the reference's partition.py:163-249).

    Layout: ``{result_path}/feature_partition_{p}/partition_res.npy`` (node
    ids), ``cache_res.npy`` (cache-priority order), ``feature.npy`` (rows),
    and a global ``feature_partition_book.npy`` (node -> partition).
    """
    feature = np.asarray(feature)
    parts, orders, unaccessed = partition_feature_without_replication(
        probs, chunk_num
    )
    n_parts = len(parts)
    book = np.full(feature.shape[0], -1, dtype=np.int32)
    os.makedirs(result_path, exist_ok=True)
    for p in range(n_parts):
        book[parts[p]] = p
    # unaccessed nodes round-robin so every row has a home
    if len(unaccessed):
        book[unaccessed] = np.arange(len(unaccessed)) % n_parts
        parts = [
            np.concatenate([parts[p], unaccessed[book[unaccessed] == p]])
            for p in range(n_parts)
        ]
    np.save(os.path.join(result_path, "feature_partition_book.npy"), book)
    for p in range(n_parts):
        d = os.path.join(result_path, f"feature_partition_{p}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "partition_res.npy"), parts[p])
        np.save(os.path.join(d, "cache_res.npy"), orders[p])
        np.save(os.path.join(d, "feature.npy"), feature[parts[p]])
    return parts, orders, book


def load_quiver_feature_partition(partition_idx: int, result_path: str):
    """Load one partition's artifacts (the reference's partition.py:252-283)."""
    d = os.path.join(result_path, f"feature_partition_{partition_idx}")
    ids = np.load(os.path.join(d, "partition_res.npy"))
    cache_order = np.load(os.path.join(d, "cache_res.npy"))
    feature = np.load(os.path.join(d, "feature.npy"))
    book = np.load(os.path.join(result_path, "feature_partition_book.npy"))
    return ids, cache_order, feature, book
