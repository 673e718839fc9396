"""Plain reference of R-GAT (Busbridge et al. 2019, "Relational Graph
Attention Networks") over dense sampled hetero blocks, its masked
cross-entropy loss, gradients and Adam.

The equations, for node-type rows ``xs[t] [P_t, D_t]`` and layers of
blocks (outermost first), each block a relation ``(src, name, dst)`` with
``nbr_local [T, k]`` (positions in the SRC rows) and ``mask [T, k]``:

- ``h[t] = xs[t] @ P_t.T + p_t``, a projection a type;
- per layer, for each type ``d`` that some block targets, its ``n_d`` rows
  (the longest of its blocks' ``T``): ``new[d] = h[d][:n_d] @ S.T + s``,
  plus, for each block into ``d``, zero-padded to ``n_d`` rows, a 4-head
  attention from SRC into DST with no self loop: ``a = h[src] @ A.T``,
  ``b = h[d][:T] @ B.T`` (``[., H, F]`` each), ``n = a[nbr_local]``
  ``[T, k, H, F]``, ``e = leaky_relu(<n, att_src> + <b, att_dst>, 0.2)``
  by head, a softmax over the valid slots (0 where none is valid), and the
  ``alpha``-weighted sum of ``n`` over the slots;
- ReLU then inverted dropout on the types that receive a block, the others
  kept as they are;
- logits: the seed type's first ``batch_size`` rows ``@ C.T + c``.

Parameters are a dict of named tensors, the names of the port's ``RGAT``
state (``mods.proj_{t}.weight``, ``mods.self_{l}_{t}.bias``,
``mods.rel_{l}_{src}__{name}__{dst}.w_src.weight``, ``.att_src`` ...,
``mods.classifier.weight``).  Matmuls run in plain fp32 with TF32 off;
with ``tf32`` (the control) their inputs are rounded to TF32 first, as in
``sage.py``.  Imports nothing of the program.

Departures from the OGB-LSC MAG240M baseline (``examples/lsc/mag240m/
rgnn.py`` of snap-stanford/ogb), which the program shares: no BatchNorm;
ReLU where it has ELU; one Linear head where it has a two-layer MLP; a
projection a type where it has a skip Linear; three forward relations
(paper-cites-paper, author-writes-paper, institution-employs-author),
sampled with fanouts a relation, where it has five edge types sampled
[25, 15] over the merged adjacency; fp32 throughout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .sage import Adam, _mm, masked_ce

Relation = Tuple[str, str, str]


def rel_key(layer: int, rel: Relation) -> str:
    return f"mods.rel_{layer}_{rel[0]}__{rel[1]}__{rel[2]}"


def param_shapes(in_dims: Dict[str, int], hidden: int, heads: int,
                 out_dim: int, layer_relations: Sequence[Sequence[Relation]]
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every parameter."""
    f = hidden // heads
    out = []
    for t, d in in_dims.items():
        out += [(f"mods.proj_{t}.weight", (hidden, d)),
                (f"mods.proj_{t}.bias", (hidden,))]
    for l, rels in enumerate(layer_relations):
        for d_t in dict.fromkeys(r[2] for r in rels):
            out += [(f"mods.self_{l}_{d_t}.weight", (hidden, hidden)),
                    (f"mods.self_{l}_{d_t}.bias", (hidden,))]
        for rel in rels:
            k = rel_key(l, rel)
            out += [(f"{k}.w_src.weight", (hidden, hidden)),
                    (f"{k}.w_dst.weight", (hidden, hidden)),
                    (f"{k}.att_src", (heads, f)),
                    (f"{k}.att_dst", (heads, f))]
    out += [("mods.classifier.weight", (out_dim, hidden)),
            ("mods.classifier.bias", (out_dim,))]
    return out


def _linear(params, name: str, x: torch.Tensor, tf32: bool):
    y = _mm(x, params[f"{name}.weight"].T, tf32)
    bias = params.get(f"{name}.bias")
    return y if bias is None else y + bias


def attention(params, key: str, x_src: torch.Tensor, x_dst: torch.Tensor,
              nbr_local: torch.Tensor, mask: torch.Tensor, heads: int,
              tf32: bool) -> torch.Tensor:
    """One relation's block: ``[T, H * F]``."""
    t, k = nbr_local.shape
    a = _linear(params, f"{key}.w_src", x_src, tf32)
    f = a.shape[1] // heads
    b = _linear(params, f"{key}.w_dst", x_dst[:t], tf32).view(t, heads, f)
    n = a[nbr_local.reshape(-1).to(torch.int64)].view(t, k, heads, f)
    e = torch.nn.functional.leaky_relu(
        (n * params[f"{key}.att_src"]).sum(-1)
        + (b * params[f"{key}.att_dst"]).sum(-1)[:, None], 0.2)
    m = mask[..., None]
    alpha = torch.softmax(torch.where(m, e, float("-inf")), dim=1)
    alpha = torch.where(m, alpha, torch.zeros_like(alpha))
    return (alpha[..., None] * n).sum(1).reshape(t, heads * f)


def forward(params: Dict[str, torch.Tensor], xs: Dict[str, torch.Tensor],
            layers, seed_type: str, batch_size: int, heads: int,
            generator: Optional[torch.Generator] = None, p_drop: float = 0.5,
            tf32: bool = False) -> torch.Tensor:
    """Logits of the seeds.  ``layers``: outermost first, each a list of
    ``(relation, nbr_local, mask)``.  With a ``generator`` (training),
    each dropout keep mask is drawn from it as the layer reaches the type,
    in the order of the types' rows (``xs``'s, then each layer's targets
    first); without one, no dropout."""
    h = {t: _linear(params, f"mods.proj_{t}", x, tf32) for t, x in xs.items()}
    for l, blocks in enumerate(layers):
        rows: Dict[str, int] = {}
        for rel, nbr_local, _ in blocks:
            rows[rel[2]] = max(rows.get(rel[2], 0), nbr_local.shape[0])
        new = {t: _linear(params, f"mods.self_{l}_{t}", h[t][:n], tf32)
               for t, n in rows.items()}
        for rel, nbr_local, mask in blocks:
            agg = attention(params, rel_key(l, rel), h[rel[0]], h[rel[2]],
                            nbr_local, mask, heads, tf32)
            pad = rows[rel[2]] - agg.shape[0]
            if pad:
                agg = torch.cat([agg, agg.new_zeros((pad, agg.shape[1]))])
            new[rel[2]] = new[rel[2]] + agg
        for t in h:
            if t not in new:
                new[t] = h[t]
                continue
            y = torch.relu(new[t])
            if generator is not None:
                keep = torch.empty(y.shape, dtype=y.dtype, device=y.device
                                   ).bernoulli_(1.0 - p_drop,
                                                generator=generator)
                y = y * keep / (1.0 - p_drop)
            new[t] = y
        h = new
    return _linear(params, "mods.classifier", h[seed_type][:batch_size],
                   tf32)


def train_step(params: Dict[str, torch.Tensor], opt: Adam, xs, layers,
               seed_type: str, labels, label_mask, heads: int, generator,
               p_drop: float = 0.5, tf32: bool = False):
    """One step in place: forward with dropout from ``generator``, loss,
    gradients, Adam.  Returns the loss (a float) and the gradients."""
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in params.items()}
    logits = forward(leaves, xs, layers, seed_type, labels.shape[0], heads,
                     generator, p_drop, tf32)
    loss = masked_ce(logits, labels, label_mask)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        opt.step(params, grads)
    return float(loss.detach()), grads
