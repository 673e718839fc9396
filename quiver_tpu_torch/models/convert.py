"""Parameter conversion between the port's models and the JAX package's
Flax models, in both directions.

Flax ``Dense.kernel`` is ``[in, out]`` and ``nn.Linear.weight`` is
``[out, in]``, so kernels are transposed; other leaves (GAT's and R-GAT's
``att_*`` vectors, ``[H, F]``) are carried as they are.  Only the names of
the top-level submodules differ, one rule per family:

- GraphSAGE ``conv{i}`` <-> ``convs.{i}``;
- GAT ``gat{i}`` <-> ``convs.{i}``; GCN ``gcn{i}`` <-> ``convs.{i}``;
- R-GAT ``proj_{t}``, ``self_{l}_{t}``, ``rel_{l}_{src}__{name}__{dst}``,
  ``classifier`` <-> ``mods.<the same name>``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping

import numpy as np
import torch

__all__ = ["sage_params_from_flax", "sage_params_to_flax",
           "gat_params_from_flax", "gat_params_to_flax",
           "gcn_params_from_flax", "gcn_params_to_flax",
           "rgat_params_from_flax", "rgat_params_to_flax"]


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a))  # a copy: JAX leaves are read-only


def _flatten_flax(node: Mapping, pre: str, out: Dict[str, torch.Tensor]):
    """A Flax subtree -> ``state_dict`` entries under ``pre``: a node with
    a ``kernel`` is a Dense (``weight``, ``bias``), a mapping is a
    submodule, anything else a parameter."""
    if "kernel" in node:
        out[pre + "weight"] = _tensor(np.asarray(node["kernel"]).T)
        if "bias" in node:
            out[pre + "bias"] = _tensor(node["bias"])
        return
    for k, v in node.items():
        if isinstance(v, Mapping):
            _flatten_flax(v, f"{pre}{k}.", out)
        else:
            out[f"{pre}{k}"] = _tensor(v)


def _from_flax(params, port_name: Callable[[str], str], what: str
               ) -> Dict[str, torch.Tensor]:
    """``{'params': {name: subtree}}`` (or the inner dict) -> a
    ``state_dict``; ``port_name`` maps a top-level Flax name to the port's
    module path (``None``: not this family's)."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        path = port_name(name)
        if path is None:
            raise ValueError(f"{name!r} is not a {what} parameter")
        _flatten_flax(sub, path + ".", out)
    if not out:
        raise ValueError(f"no {what} parameters in the Flax tree")
    return out


def _to_flax(state_dict, flax_name: Callable[[str], tuple], what: str
             ) -> Dict[str, dict]:
    """The inverse of :func:`_from_flax`: ``flax_name`` splits a
    ``state_dict`` key into (top-level Flax name, the rest of the path) or
    returns ``None`` for a key that is not this family's."""
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    tree: Dict[str, dict] = {}
    for key, t in state_dict.items():
        split = flax_name(key)
        if split is None:
            raise ValueError(f"{key!r} is not a {what} parameter")
        top, rest = split
        *mods, leaf = [top] + rest.split(".")
        a = t.detach().cpu().numpy().copy()
        if leaf == "weight":
            leaf, a = "kernel", a.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    if not tree:
        raise ValueError(f"no {what} parameters in the state_dict")
    return {"params": tree}


def _indexed(flax_prefix: str):
    """Name maps for ``{flax_prefix}{i}`` <-> ``convs.{i}``."""
    fl = re.compile(rf"{flax_prefix}(\d+)")
    pt = re.compile(r"convs\.(\d+)\.(.+)")

    def port_name(name):
        m = fl.fullmatch(name)
        return f"convs.{m.group(1)}" if m else None

    def flax_name(key):
        m = pt.fullmatch(key)
        return (f"{flax_prefix}{m.group(1)}", m.group(2)) if m else None

    return port_name, flax_name


_SAGE, _GAT, _GCN = _indexed("conv"), _indexed("gat"), _indexed("gcn")


def sage_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """``{'params': {'conv{i}': {'lin_self': {kernel, bias}, 'lin_nbr':
    {kernel}}}}`` (numpy leaves) -> a :class:`GraphSAGE` ``state_dict``."""
    return _from_flax(params, _SAGE[0], "GraphSAGE")


def sage_params_to_flax(state_dict) -> Dict[str, dict]:
    """A :class:`GraphSAGE` ``state_dict`` (or the module) -> the Flax tree
    ``{'params': {'conv{i}': ...}}`` of numpy arrays, so parameters of
    both packages can be compared in one layout."""
    return _to_flax(state_dict, _SAGE[1], "GraphSAGE")


def gat_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """``{'params': {'gat{i}': {'lin': {kernel}, 'att_src', 'att_tgt'}}}``
    -> a :class:`GAT` ``state_dict``."""
    return _from_flax(params, _GAT[0], "GAT")


def gat_params_to_flax(state_dict) -> Dict[str, dict]:
    """A :class:`GAT` ``state_dict`` (or the module) -> the Flax tree."""
    return _to_flax(state_dict, _GAT[1], "GAT")


def gcn_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """``{'params': {'gcn{i}': {'lin': {kernel, bias}}}}`` -> a
    :class:`GCN` ``state_dict``."""
    return _from_flax(params, _GCN[0], "GCN")


def gcn_params_to_flax(state_dict) -> Dict[str, dict]:
    """A :class:`GCN` ``state_dict`` (or the module) -> the Flax tree."""
    return _to_flax(state_dict, _GCN[1], "GCN")


_RGAT_TOP = re.compile(r"proj_.+|self_\d+_.+|rel_\d+_.+__.+__.+|classifier")


def _rgat_port_name(name):
    return f"mods.{name}" if _RGAT_TOP.fullmatch(name) else None


def _rgat_flax_name(key):
    parts = key.split(".", 2)
    if len(parts) == 3 and parts[0] == "mods":
        return parts[1], parts[2]
    return None


def rgat_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """``{'params': {'proj_{t}', 'self_{l}_{t}', 'rel_{l}_{src}__{name}__
    {dst}': {'w_src', 'w_dst', 'att_src', 'att_dst'}, 'classifier'}}`` ->
    an :class:`RGAT` ``state_dict`` (``mods.<name>...``)."""
    return _from_flax(params, _rgat_port_name, "R-GAT")


def rgat_params_to_flax(state_dict) -> Dict[str, dict]:
    """An :class:`RGAT` ``state_dict`` (or the module) -> the Flax tree."""
    return _to_flax(state_dict, _rgat_flax_name, "R-GAT")
