"""GNN model serving, a Reddit-style deployment, on the card.

PyTorch counterpart of the JAX package's ``examples/serving_reddit.py``
(the reference's ``examples/serving/reddit/reddit_serving.py``): client
streams push id-batches; the batcher routes small expansions to the CPU
sampler lane and big ones to the card's lane; the inference server runs
sample -> feature -> model with bucketed shapes and reports tp99.  The
card's lane runs kernels B1 and B2; the CPU lane samples on the host and
gathers with B2.

    python -m quiver_tpu_torch.examples.serving_reddit
    python -m quiver_tpu_torch.examples.serving_reddit --device cpu \\
        --nodes 1500 --edges 15000 --clients 2 --requests-per-client 4
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

from . import add_device_flag, device_of, put, seeded
from ..utils.topology import CSRTopo


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=500_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--requests-per-client", type=int, default=30)
    add_device_flag(ap)
    return ap.parse_args(argv)


def make_data(args):
    """``(topo, feat)``: a lognormal-degree random graph and normal
    features, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    deg = np.maximum(rng.lognormal(2, 1, args.nodes), 1).astype(np.int64)
    deg = (deg * args.edges / deg.sum()).astype(np.int64) + 1
    src = np.repeat(np.arange(args.nodes), deg)
    dst = rng.integers(0, args.nodes, len(src))
    topo = CSRTopo(edge_index=np.stack([src, dst]))
    feat = rng.normal(size=(args.nodes, args.dim)).astype(np.float32)
    return topo, feat


def client_requests(args, cid: int):
    """Client ``cid``'s requests: ``(ids, pause_s)`` pairs from
    ``default_rng(cid)``."""
    crng = np.random.default_rng(cid)
    out = []
    for _ in range(args.requests_per_client):
        ids = crng.integers(0, args.nodes, crng.integers(1, 32))
        out.append((ids, crng.exponential(0.01)))
    return out


def main(argv=None, report=None) -> int:
    args = parse_args(argv)
    dev = device_of(args)

    from .. import (Feature, GraphSageSampler, HybridSampler,
                    InferenceServer_Debug, RequestBatcher,
                    generate_neighbour_num)
    from ..config import get_config
    from ..models import GraphSAGE
    from ..resilience.shutdown import join_and_reap
    from ..serving import ServingRequest

    topo, feat = make_data(args)
    feature = Feature(device_cache_size="10G",
                      device=dev).from_cpu_tensor(feat)
    sizes = [10, 5]
    card_sampler = GraphSageSampler(topo, sizes, device=dev)
    cpu_sampler = GraphSageSampler(topo, sizes, mode="CPU", device=dev)
    with seeded(0, dev):
        model = GraphSAGE(args.dim, hidden=128, out_dim=41, num_layers=2,
                          dropout=0.0, device=dev).eval()

    # pre-warm the serving buckets so request latency excludes the first
    # calls' allocations, and the host sampler so it excludes the native
    # library's build
    with torch.no_grad():
        for bucket in get_config().serving_buckets:
            if bucket > 32:
                break
            bb = card_sampler.sample(np.arange(bucket, dtype=np.int64))
            model(feature[bb.n_id], bb.layers)
    cpu_sampler.sample(np.arange(8, dtype=np.int64))

    nn_num = generate_neighbour_num(topo, sizes, mode="expected", device=dev)
    streams = [queue.Queue() for _ in range(args.clients)]
    rb = RequestBatcher(streams, neighbour_num=nn_num,
                        threshold=float(np.percentile(nn_num, 30) * 2),
                        mode="Auto").start()
    hs = HybridSampler(cpu_sampler, rb.cpu_batched_queue,
                       num_workers=2).start()
    server = InferenceServer_Debug(
        card_sampler, feature, model, rb.device_batched_queue,
        hs.sampled_queue,
    ).start()

    plans = [client_requests(args, c) for c in range(args.clients)]

    def client(cid):
        for i, (ids, pause) in enumerate(plans[cid]):
            streams[cid].put(ServingRequest(ids=ids, client=cid, seq=i))
            time.sleep(pause)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(args.clients)]
    for t in threads:
        t.start()

    total = args.clients * args.requests_per_client
    try:
        for _ in range(total):
            req, out = server.result_queue.get(timeout=120)
            if isinstance(out, BaseException):
                raise out
            assert out.shape[0] == len(req.ids)
            assert np.isfinite(out).all()
    finally:
        join_and_reap(threads, 60.0, component="client")
        stats = server.stats()
        rb.stop()
        hs.stop()
        server.stop()
    print(f"served {stats['count']}: avg {stats['avg_latency_ms']:.1f}ms "
          f"p99 {stats['p99_latency_ms']:.1f}ms "
          f"{stats['throughput_rps']:.0f} rps")
    put(report, first_seeds=plans[0][0][0] if plans and plans[0] else None,
        served=stats["count"], p50_ms=stats["p50_latency_ms"],
        p99_ms=stats["p99_latency_ms"], avg_ms=stats["avg_latency_ms"],
        rps=stats["throughput_rps"],
        lanes={lane: int(h.count) for lane, h in server.lane_latency.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
