"""Heterogeneous topology, features and sampler (counterpart of
``quiver_tpu/hetero.py``), for R-GAT on a MAG240M-class schema.

A relation is ``(src_type, name, dst_type)``; its CSR rows are DST nodes
and its neighbours SRC nodes (sources are sampled for targets, messages
flow src -> dst).  Sampling keeps one positional frontier per node type,
with no dedup, as the homogeneous ``dedup="none"`` pipeline does:

- at the start of a hop each type's frontier is snapshotted; a relation
  whose DST snapshot is empty is skipped and uses no key words;
- every other relation, in the dict order of the hop's sizes, samples
  ``k`` sources for each DST id of the snapshot (one hop of
  ``ops/sample.py::run_hop``: B1's literal entry under ``"pwindow"``),
  and appends them, 0 where masked, to its SRC type's frontier; its
  block's ``nbr_local[b, j]`` is ``base + b*k + j`` where valid, ``base``
  being the SRC frontier's length at that moment.

Those lengths follow from the seed count and the sizes alone, so the
frontiers are allocated once at their final length and each block writes
its slice: nothing on the path reads the card back.

Key words: JAX splits ``key, sub = split(key)`` once per sampled block and
folds ``sub`` into two uint32 words; the port takes those words, one pair
per sampled block in block order, ``[n_blocks, 2]``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .config import resolve_gather_mode, resolve_sample_rng
from .feature import Feature
from .ops.sample import key_words_pair, run_hop
from .utils.device import resolve_device
from .utils.topology import CSRTopo

__all__ = ["HeteroCSRTopo", "HeteroGraphSageSampler", "HeteroLayerBlock",
           "HeteroSampledBatch", "HeteroFeature"]

Relation = Tuple[str, str, str]


class HeteroLayerBlock(NamedTuple):
    """One (relation, hop) bipartite block; ``relation`` is plain
    metadata."""

    nbr_local: torch.Tensor    # [T, k] int32 positions in the SRC frontier
    mask: torch.Tensor         # [T, k] bool
    num_targets: torch.Tensor  # scalar int32: valid targets (DST prefix)
    relation: Relation


class HeteroSampledBatch(NamedTuple):
    n_id: Dict[str, torch.Tensor]       # per type: padded frontier ids
    n_id_mask: Dict[str, torch.Tensor]  # per type: validity
    # layers[l]: the blocks of one hop, OUTERMOST hop first
    layers: Tuple[Tuple[HeteroLayerBlock, ...], ...]
    batch_size: int
    seed_type: str


class HeteroCSRTopo:
    """Per-relation CSRs (the port's :class:`CSRTopo`) and per-type node
    counts."""

    def __init__(self, relations: Dict[Relation, CSRTopo],
                 node_counts: Dict[str, int]):
        self.relations = dict(relations)
        self.node_counts = dict(node_counts)
        for (s, _, d), topo in self.relations.items():
            if s not in self.node_counts or d not in self.node_counts:
                raise ValueError(f"relation types {s!r}, {d!r} need node "
                                 "counts")
            if topo.node_count > self.node_counts[d]:
                raise ValueError(f"relation rows ({topo.node_count}) exceed "
                                 f"the {d!r} count")

    @classmethod
    def from_edge_index_dict(cls, edge_index_dict: Dict[Relation, np.ndarray],
                             node_counts: Dict[str, int]) -> "HeteroCSRTopo":
        """``{relation: [2, E] (src, dst)}``: each relation's CSR has DST
        rows and SRC neighbours."""
        rels = {}
        for rel, ei in edge_index_dict.items():
            ei = np.asarray(ei)
            rels[rel] = CSRTopo(edge_index=np.stack([ei[1], ei[0]]),
                                node_count=node_counts[rel[2]])
        return cls(rels, node_counts)

    def node_types(self) -> List[str]:
        return list(self.node_counts)

    def to_device(self, device=None) -> "HeteroCSRTopo":
        for topo in self.relations.values():
            topo.to_device(device)
        return self


class HeteroFeature:
    """Per-node-type :class:`Feature` stores with one batch-level lookup."""

    def __init__(self, features: Dict[str, Feature]):
        self.features = dict(features)

    @classmethod
    def from_cpu_tensors(cls, tensors: Dict[str, np.ndarray],
                         device_cache_size="1G", **kwargs) -> "HeteroFeature":
        """One :class:`Feature` per type (``kwargs`` go to each, ``device``
        among them) built from its ``[N_t, D_t]`` host table."""
        return cls({t: Feature(device_cache_size=device_cache_size,
                               **kwargs).from_cpu_tensor(x)
                    for t, x in tensors.items()})

    def __getitem__(self, key) -> torch.Tensor:
        node_type, ids = key
        return self.features[node_type][ids]

    def lookup(self, batch: HeteroSampledBatch) -> Dict[str, torch.Tensor]:
        """Rows of every type's padded frontier, ``{type: [P_t, D_t]}``; an
        empty or absent frontier gives ``zeros((0, D_t))``.  The ids stay
        on the device: a whole-table feature gathers them with B2
        (``Feature.__getitem__`` -> ``lookup_device``), where JAX reads
        them back to the host first; a budgeted one reads them back once,
        as ``Feature.__getitem__`` does.  The rows are the same."""
        out = {}
        for t, f in self.features.items():
            n_id = batch.n_id.get(t)
            if n_id is None or n_id.shape[0] == 0:
                out[t] = torch.zeros((0, f.dim), dtype=torch.float32,
                                     device=f.device)
            else:
                out[t] = f[n_id]
        return out


class _Block(NamedTuple):
    """A sampled block of the static plan: its relation and fanout, the
    DST snapshot's length and the SRC frontier's length before it."""

    relation: Relation
    k: int
    t_len: int
    base: int


class HeteroGraphSageSampler:
    """Multi-hop hetero sampler with per-relation fanouts.

    Args:
      topo: :class:`HeteroCSRTopo`.
      sizes: an int for every relation and hop (with ``num_hops``), a
        ``{relation: k}`` dict for every hop (with ``num_hops``), or a list
        of such dicts (or ints), one per hop, outward.
      seed_type: node type of the seeds.
      device: where the topology lives and hops run (``None``: the card).
      gather_mode: element-gather mode of each hop
        (``config.resolve_gather_mode``; ``"auto"`` is ``"pwindow"``, one
        launch of B1's literal entry a block).
      sample_rng: ``"auto"`` or ``"hash"``; ``"key"`` raises.
      seed: seed of the generator that draws key words when a call gives
        none.
    """

    def __init__(self, topo: HeteroCSRTopo, sizes, num_hops: int = None,
                 seed_type: str = "paper", device=None,
                 gather_mode: str = "auto", sample_rng: str = "auto",
                 seed: int = 0):
        self.topo = topo
        self.device = resolve_device(device)
        self.gather_mode = resolve_gather_mode(gather_mode)
        resolve_sample_rng(sample_rng)  # validates: the port has one RNG
        if isinstance(sizes, (list, tuple)):
            self.hop_sizes = [self._norm(s) for s in sizes]
        else:
            if num_hops is None:
                raise ValueError("sizes that are not a list need num_hops")
            self.hop_sizes = [self._norm(sizes)] * num_hops
        if seed_type not in topo.node_counts:
            raise ValueError(f"seed_type {seed_type!r} is not a node type")
        self.seed_type = seed_type
        self._rng = np.random.default_rng(seed)
        topo.to_device(self.device)

    def _norm(self, s) -> Dict[Relation, int]:
        if isinstance(s, int):
            return {rel: s for rel in self.topo.relations}
        for rel in s:
            if rel not in self.topo.relations:
                raise ValueError(f"no relation {rel!r} in the topology")
        return dict(s)

    def plan(self, batch_size: int
             ) -> Tuple[List[List[_Block]], Dict[str, int]]:
        """The blocks of each hop (innermost first) for ``batch_size``
        seeds and each type's final frontier length: the snapshot rule of
        ``quiver_tpu/hetero.py:176-188`` on lengths alone."""
        lens = {t: 0 for t in self.topo.node_types()}
        lens[self.seed_type] = batch_size
        hops = []
        for hop_size in self.hop_sizes:
            snap = dict(lens)
            blocks = []
            for rel, k in hop_size.items():
                s_t, _, d_t = rel
                if snap[d_t] == 0:
                    continue
                blocks.append(_Block(rel, k, snap[d_t], lens[s_t]))
                lens[s_t] += snap[d_t] * k
            hops.append(blocks)
        return hops, lens

    def layer_relations(self, batch_size: int = 1
                        ) -> Tuple[Tuple[Relation, ...], ...]:
        """The relations of each layer's blocks, outermost layer first:
        what ``RGAT(layer_relations=...)`` needs."""
        hops, _ = self.plan(batch_size)
        return tuple(tuple(b.relation for b in hop) for hop in hops[::-1])

    def num_blocks(self, batch_size: int) -> int:
        return sum(len(hop) for hop in self.plan(batch_size)[0])

    def draw_key_words(self, batch_size: int) -> np.ndarray:
        """``[n_blocks, 2]`` uint32 key words from the sampler's own
        generator."""
        return self._rng.integers(0, 2**32,
                                  size=(self.num_blocks(batch_size), 2),
                                  dtype=np.uint32)

    def seed_tensor(self, input_nodes) -> torch.Tensor:
        if isinstance(input_nodes, torch.Tensor):
            return input_nodes.to(self.device, torch.int32)
        ids = np.asarray(input_nodes)
        n = self.topo.node_counts[self.seed_type]
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"{self.seed_type} ids must lie in [0, {n})")
        return torch.from_numpy(ids.astype(np.int32)).to(self.device)

    def sample(self, input_nodes, key_words=None) -> HeteroSampledBatch:
        """Sample every hop for ``input_nodes`` (ids of ``seed_type``)
        under ``key_words`` (``[n_blocks, 2]`` uint32, one pair per sampled
        block in block order; drawn here when ``None``)."""
        seeds = self.seed_tensor(input_nodes)
        B = int(seeds.shape[0])
        hops, lens = self.plan(B)
        n_blocks = sum(len(hop) for hop in hops)
        if key_words is None:
            key_words = self.draw_key_words(B)
        key_words = np.asarray(key_words, dtype=np.uint32).reshape(-1, 2)
        if key_words.shape[0] != n_blocks:
            raise ValueError(f"{key_words.shape[0]} key-word pairs for "
                             f"{n_blocks} sampled blocks")
        dev = self.device
        n_id = {t: torch.empty((n,), dtype=torch.int32, device=dev)
                for t, n in lens.items()}
        n_mask = {t: torch.empty((n,), dtype=torch.bool, device=dev)
                  for t, n in lens.items()}
        n_id[self.seed_type][:B].copy_(seeds)
        n_mask[self.seed_type][:B].fill_(True)
        layers, i = [], 0
        for hop in hops:
            blocks = []
            for blk in hop:
                s_t, _, d_t = blk.relation
                t, k, base = blk.t_len, blk.k, blk.base
                indptr, indices = self.topo.relations[blk.relation].to_device(
                    dev)
                dst_mask = n_mask[d_t][:t]
                out = run_hop(indptr, indices, n_id[d_t][:t], k,
                              *key_words_pair(key_words[i]), dst_mask,
                              self.gather_mode)
                i += 1
                pos = (base
                       + torch.arange(t, dtype=torch.int32,
                                      device=dev)[:, None] * k
                       + torch.arange(k, dtype=torch.int32, device=dev)[None])
                zero = torch.zeros_like(pos)
                n_id[s_t][base:base + t * k].copy_(
                    torch.where(out.mask, out.nbrs, zero).reshape(-1))
                n_mask[s_t][base:base + t * k].copy_(out.mask.reshape(-1))
                blocks.append(HeteroLayerBlock(
                    nbr_local=torch.where(out.mask, pos, zero),
                    mask=out.mask,
                    num_targets=dst_mask.sum().to(torch.int32),
                    relation=blk.relation))
            layers.append(tuple(blocks))
        return HeteroSampledBatch(n_id=n_id, n_id_mask=n_mask,
                                  layers=tuple(layers[::-1]), batch_size=B,
                                  seed_type=self.seed_type)

    def __repr__(self):
        return (f"HeteroGraphSageSampler(hops={len(self.hop_sizes)}, "
                f"seed_type={self.seed_type!r}, gather={self.gather_mode!r}, "
                f"device={self.device})")
