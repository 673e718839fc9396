"""A cell's inputs, made on the card from ``--seed``, and the port's
objects built over them.

The graph copies the lognormal arithmetic of the port's
``synthetic_csr`` (degrees lognormal with mean 3 and sigma 1, scaled to
the edge count, floored, at least 1; neighbours uniform), drawn on the
card, with the floor's shortfall given to the largest remainders so that
the configuration's edge count holds exactly.  Features are standard
normal fp32, labels uniform over the classes, weights uniform in
``+-1/sqrt(fan_in)``: each in one or two large calls of a generator on
the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .reference.sage import param_shapes

# sub-streams of one run's seed: each input draws from its own
STREAMS = {"graph": 1, "features": 2, "labels": 3, "weights": 4,
           "split": 5, "traffic": 6, "dropout": 8}


def seed_of(seed: int, what: str) -> int:
    """A 63-bit seed for the input ``what`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS[what]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, what))


@dataclass
class Inputs:
    """What the benchmark makes and hands to both sides."""

    indptr: torch.Tensor   # [N + 1] int64 on the card
    indices: torch.Tensor  # [E] int32 on the card
    table: torch.Tensor    # [N, D] fp32 on the card
    labels: torch.Tensor   # [N] int64 on the card
    weights: Dict[str, torch.Tensor]  # initial parameters, on the card
    train_ids: torch.Tensor  # [S] int64: the seeded training split


def make_graph(nodes: int, edges: int, seed: int, device):
    g = generator(seed, "graph", device)
    raw = torch.empty(nodes, dtype=torch.float64, device=device)
    raw.log_normal_(3.0, 1.0, generator=g)
    share = raw / raw.sum() * edges
    deg = torch.clamp_min(torch.floor(share), 1).to(torch.int64)
    short = edges - int(deg.sum())
    if short < 0:
        raise ValueError(f"{nodes} nodes of degree >= 1 exceed {edges} edges")
    if short:
        top = torch.topk(share - torch.floor(share), short).indices
        deg[top] += 1
    indptr = torch.zeros(nodes + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])
    indices = torch.randint(0, nodes, (edges,), generator=g,
                            dtype=torch.int32, device=device)
    return indptr, indices


def make_weights(dims: List[int], seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(dims[0], dims[1], dims[-1], len(dims) - 1)
    total = sum(int(np.prod(s)) for _, s in shapes)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(seed, "weights", device))
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        fan_in = shape[-1] if len(shape) == 2 else dims[int(name.split(".")[1])]
        out[name] = flat[off:off + n].view(shape) / fan_in ** 0.5
        off += n
    return out


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    n, e = cfg["graph"]["nodes"], cfg["graph"]["edges"]
    indptr, indices = make_graph(n, e, seed, device)
    table = torch.empty((n, cfg["feature_dim"]), dtype=torch.float32,
                        device=device)
    table.normal_(generator=generator(seed, "features", device))
    labels = torch.randint(0, cfg["classes"], (n,), dtype=torch.int64,
                           device=device,
                           generator=generator(seed, "labels", device))
    split = torch.randperm(n, device=device,
                           generator=generator(seed, "split", device))
    return Inputs(indptr=indptr, indices=indices, table=table, labels=labels,
                  weights=make_weights(dims_of(cfg), seed, device),
                  train_ids=split[:cfg["train_nodes"]])


def dims_of(cfg: dict) -> List[int]:
    m = cfg["model"]
    return ([cfg["feature_dim"]] + [m["hidden"]] * (m["layers"] - 1)
            + [cfg["classes"]])


def port_objects(qt, cfg: dict, inp: Inputs, device, *, train: bool,
                 run=None):
    """The port's topology, feature, sampler and model over ``inp``, as
    the reference Quiver user builds them: ``CSRTopo`` from the host
    arrays, a ``Feature`` holding the whole table on the card with the
    topology's degree order, a ``GraphSageSampler`` at the configuration's
    fanouts and gather mode, and a ``GraphSAGE`` carrying ``inp.weights``
    (in training mode when ``train``)."""
    topo = qt.CSRTopo(indptr=inp.indptr.cpu().numpy(),
                      indices=inp.indices.cpu().numpy())
    feature = qt.Feature(rank=0, device_list=[0], device_cache_size=
                         inp.table.numel() * inp.table.element_size(),
                         cache_policy="device_replicate", csr_topo=topo,
                         device=device)
    mark = run.mark if run is not None else (lambda what: None)
    mark("CSRTopo")
    feature.from_cpu_tensor(inp.table)
    mark("Feature")
    s = cfg["sampling"]
    sampler = qt.GraphSageSampler(topo, s["fanouts"], device=device,
                                  gather_mode=s["gather_mode"],
                                  sample_rng=s["sample_rng"],
                                  dedup=s["dedup"])
    m = cfg["model"]
    model = qt.GraphSAGE(cfg["feature_dim"], m["hidden"], cfg["classes"],
                         num_layers=m["layers"], dropout=m["dropout"],
                         device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(inp.weights[name])
    model.train(train)
    mark("sampler and model")
    return topo, feature, sampler, model
