"""The hetero cell's inputs, made on the card from ``--seed``, and the
port's R-GAT objects built over them.

Each relation's graph takes the lognormal arithmetic of ``build.py``
over its DST type: in-degree shares lognormal with mean 3 and sigma 1,
scaled to the relation's edge count and floored, at least 1 where the
relation's average in-degree is 1 or more (no floor below it, or the
floor alone would pass the edge count), the shortfall given to the
largest remainders so that the edge count holds exactly; SRC neighbours
uniform.  Tables are standard normal fp32 for every type (drawn again
wherever they are needed: :meth:`HeteroInputs.table`), labels uniform
over the classes (papers), weights uniform in ``+-1/sqrt(fan_in)``.  Each
input draws from its own stream of the run's seed, each relation and
type from its own sub-stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build
from .reference.rgat import param_shapes

Relation = Tuple[str, str, str]


def seed_of(seed: int, what: str, index: int) -> int:
    """A 63-bit seed for part ``index`` of the input ``what`` of run
    ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1),
                                 build.STREAMS[what], index])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, what: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        seed_of(seed, what, index))


def relations(cfg: dict) -> List[Relation]:
    return [tuple(r) for r in cfg["relations"]]


def node_counts(cfg: dict) -> Dict[str, int]:
    return {t: cfg[f"{t}_nodes"] for t in cfg["node_types"]}


@dataclass
class HeteroInputs:
    """What the benchmark makes and hands to both sides."""

    csr: Dict[Relation, Tuple[torch.Tensor, torch.Tensor]]  # on the card:
    # [N_dst + 1] int64 indptr, [E] int32 SRC ids
    labels: torch.Tensor              # [N_paper] int64 on the card
    weights: Dict[str, torch.Tensor]  # initial parameters, on the card
    train_ids: torch.Tensor           # [S] int64: the seeded training split
    counts: Dict[str, int]
    dim: int
    seed: int
    device: torch.device

    def table(self, node_type: str) -> torch.Tensor:
        """``node_type``'s ``[N_t, D]`` fp32 table, drawn on the card from
        the run's seed, the same bits at every call: the program's feature
        and the reference each draw their own, so that no second copy of
        the 12 GB of tables stays on the card through the window."""
        i = list(self.counts).index(node_type)
        x = torch.empty((self.counts[node_type], self.dim),
                        dtype=torch.float32, device=self.device)
        return x.normal_(generator=generator(self.seed, "features", i,
                                             self.device))


def relation_graph(n_dst: int, n_src: int, edges: int, g: torch.Generator,
                   device):
    raw = torch.empty(n_dst, dtype=torch.float64, device=device)
    raw.log_normal_(3.0, 1.0, generator=g)
    share = raw / raw.sum() * edges
    deg = torch.floor(share).to(torch.int64)
    if edges >= n_dst:
        deg.clamp_min_(1)
    short = edges - int(deg.sum())
    if short < 0:
        raise ValueError(f"{n_dst} nodes of degree >= 1 exceed {edges} edges")
    if short:
        deg[torch.topk(share - torch.floor(share), short).indices] += 1
    indptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])
    indices = torch.randint(0, n_src, (edges,), generator=g,
                            dtype=torch.int32, device=device)
    return indptr, indices


def make_weights(cfg: dict, layer_relations, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    m = cfg["model"]
    shapes = param_shapes({t: cfg["feature_dim"] for t in cfg["node_types"]},
                          m["hidden"], m["heads"], cfg["classes"],
                          layer_relations)
    total = sum(int(np.prod(s)) for _, s in shapes)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(seed, "weights", 0, device))
    fan = {n: s[-1] for n, s in shapes}
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        fan_in = (fan[name[:-len("bias")] + "weight"]
                  if name.endswith(".bias") else shape[-1])
        out[name] = flat[off:off + n].view(shape) / fan_in ** 0.5
        off += n
    return out


def layer_relations(cfg: dict):
    """The relations of each layer's blocks, outermost first: the
    sampler's plan (``reference.hetero_sampler``'s rule) on lengths."""
    lens = {t: 0 for t in cfg["node_types"]}
    lens[cfg["seed_type"]] = 1
    hops = []
    for _ in cfg["sampling"]["fanouts"]:
        snap = dict(lens)
        hop = [r for r in relations(cfg) if snap[r[2]]]
        for r in hop:
            lens[r[0]] += 1
        hops.append(tuple(hop))
    return tuple(hops[::-1])


def hop_sizes(cfg: dict):
    """``(relation, k)`` of every relation, one list a hop, innermost
    first (the reference sampler's ``sizes``)."""
    return [[(r, k) for r in relations(cfg)]
            for k in cfg["sampling"]["fanouts"]]


def make_inputs(cfg: dict, seed: int, device) -> HeteroInputs:
    counts = node_counts(cfg)
    csr = {}
    for i, rel in enumerate(relations(cfg)):
        csr[rel] = relation_graph(counts[rel[2]], counts[rel[0]],
                                  cfg[f"{rel[1]}_edges"],
                                  generator(seed, "graph", i, device), device)
    n_seed = counts[cfg["seed_type"]]
    labels = torch.randint(0, cfg["classes"], (n_seed,), dtype=torch.int64,
                           device=device,
                           generator=generator(seed, "labels", 0, device))
    split = torch.randperm(n_seed, device=device,
                           generator=generator(seed, "split", 0, device))
    return HeteroInputs(csr=csr, labels=labels,
                        weights=make_weights(cfg, layer_relations(cfg), seed,
                                             device),
                        train_ids=split[:cfg["train_nodes"]], counts=counts,
                        dim=cfg["feature_dim"], seed=seed,
                        device=torch.device(device))


def port_objects(qt, cfg: dict, inp: HeteroInputs, device, *, train: bool,
                 run=None):
    """The port's hetero topology, feature, sampler and R-GAT over
    ``inp``, as ``examples/mag240m_rgat.py`` builds them: a
    ``HeteroCSRTopo`` from the host arrays, a ``HeteroFeature`` whose every
    type holds its whole table on the card, a ``HeteroGraphSageSampler``
    at the configuration's fanouts (every relation at each hop's), gather
    mode and RNG, and an ``RGAT`` carrying ``inp.weights`` (in training
    mode when ``train``)."""
    mark = run.mark if run is not None else (lambda what: None)
    topo = qt.HeteroCSRTopo(
        {rel: qt.CSRTopo(indptr=ip.cpu().numpy(), indices=ix.cpu().numpy())
         for rel, (ip, ix) in inp.csr.items()}, node_counts(cfg))
    mark("HeteroCSRTopo")
    feature = qt.HeteroFeature({
        t: qt.Feature(device_cache_size=n * inp.dim * 4,
                      device=device).from_cpu_tensor(inp.table(t))
        for t, n in inp.counts.items()})
    mark("HeteroFeature")
    s = cfg["sampling"]
    sampler = qt.HeteroGraphSageSampler(
        topo, list(s["fanouts"]), seed_type=cfg["seed_type"], device=device,
        gather_mode=s["gather_mode"], sample_rng=s["sample_rng"])
    m = cfg["model"]
    model = qt.RGAT({t: cfg["feature_dim"] for t in cfg["node_types"]},
                    m["hidden"], cfg["classes"], m["layers"],
                    sampler.layer_relations(), heads=m["heads"],
                    dropout=m["dropout"], device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(inp.weights[name])
    model.train(train)
    mark("sampler and model")
    return topo, feature, sampler, model
