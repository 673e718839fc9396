"""Offline probability-guided feature partitioning: the preprocessing step
of multi-host training.

PyTorch counterpart of the JAX package's
``examples/preprocess_partition.py`` (the reference's
``benchmarks/ogbn-papers100M/preprocess.py``, :119-211): per-host access
probabilities from the train split (computed on the card), greedy
partitioning on the host, artifacts on disk, then at train time
``PartitionInfo``/``DistFeature`` load them.  No kernel runs.

    python -m quiver_tpu_torch.examples.preprocess_partition
    python -m quiver_tpu_torch.examples.preprocess_partition --device cpu \\
        --nodes 2000 --edges 20000 --hosts 4 --out /tmp/qt_part
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from . import add_device_flag, device_of, put


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=500_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--fanout", type=int, nargs="+", default=[15, 10, 5])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "quiver_tpu_partition"))
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(topo, feature, rng)``: ``synthetic_csr`` and normal rows from
    ``default_rng(0)``; ``rng`` continues the stream (the train split
    comes from it)."""
    from ..utils.synthetic import synthetic_csr
    from ..utils.topology import CSRTopo

    indptr, indices = synthetic_csr(args.nodes, args.edges)
    topo = CSRTopo(indptr=indptr, indices=indices)
    rng = np.random.default_rng(0)
    feature = rng.normal(size=(args.nodes, args.dim)).astype(np.float32)
    return topo, feature, rng


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import (GraphSageSampler, load_quiver_feature_partition,
                    quiver_partition_feature)

    topo, feature, rng = make_data(args)

    # per-host train splits -> per-host access probabilities (the
    # cal_next recurrence), exactly the reference's preprocessing recipe
    sampler = GraphSageSampler(topo, args.fanout, device=dev)
    train_idx = rng.permutation(args.nodes)[: args.nodes // 2]
    shards = np.array_split(train_idx, args.hosts)
    # the partitioner runs on the host: each host's probabilities are read
    # back once, offline
    probs = []
    for shard in shards:
        prob = sampler.sample_prob(shard, topo.node_count)
        probs.append(prob.cpu().numpy())  # quiverlint: sync-ok[offline]
    print(f"probabilities computed for {args.hosts} hosts")

    parts, orders, book = quiver_partition_feature(
        feature, probs, args.out
    )
    sizes = [len(p) for p in parts]
    print(f"partitions: {sizes} (balance "
          f"{min(sizes) / max(sizes):.2f}), artifacts in {args.out}")

    # verify round-trip like the training side would
    ids0, cache0, feat0, book0 = load_quiver_feature_partition(0, args.out)
    assert np.allclose(feat0, feature[ids0])
    print(f"partition 0: {len(ids0)} nodes, cache order head "
          f"{cache0[:5].tolist()}")
    print("load_quiver_feature_partition round-trip OK; feed `book` to "
          "PartitionInfo.from_partition_book(...) at train time")
    put(report, first_seeds=shards[0], sizes=sizes, book=book,
        probs=probs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
