"""Parameter conversion between the port's GraphSAGE and the JAX
package's Flax GraphSAGE, in both directions."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["sage_params_from_flax", "sage_params_to_flax"]


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a))  # a copy: JAX leaves are read-only


def sage_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """``{'params': {'conv{i}': {'lin_self': {kernel, bias}, 'lin_nbr':
    {kernel}}}}`` (numpy leaves) -> a :class:`GraphSAGE` ``state_dict``.

    Flax ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is
    ``[out, in]``, so kernels are transposed."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}" in tree:
        conv, pre = tree[f"conv{i}"], f"convs.{i}"
        out[f"{pre}.lin_self.weight"] = _tensor(
            np.asarray(conv["lin_self"]["kernel"]).T)
        if "bias" in conv["lin_self"]:
            out[f"{pre}.lin_self.bias"] = _tensor(conv["lin_self"]["bias"])
        out[f"{pre}.lin_nbr.weight"] = _tensor(
            np.asarray(conv["lin_nbr"]["kernel"]).T)
        i += 1
    if i == 0:
        raise ValueError("no conv{i} entries in the Flax params")
    return out


def sage_params_to_flax(state_dict) -> Dict[str, dict]:
    """A :class:`GraphSAGE` ``state_dict`` (or the module) -> the Flax tree
    ``{'params': {'conv{i}': ...}}`` of numpy arrays, the inverse of
    :func:`sage_params_from_flax`, so parameters of both packages can be
    compared in one layout."""
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()

    def arr(t) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    tree: Dict[str, dict] = {}
    i = 0
    while f"convs.{i}.lin_self.weight" in state_dict:
        pre = f"convs.{i}"
        lin_self = {"kernel": arr(state_dict[f"{pre}.lin_self.weight"]).T}
        if f"{pre}.lin_self.bias" in state_dict:
            lin_self["bias"] = arr(state_dict[f"{pre}.lin_self.bias"])
        tree[f"conv{i}"] = {
            "lin_self": lin_self,
            "lin_nbr": {"kernel": arr(state_dict[f"{pre}.lin_nbr.weight"]).T}}
        i += 1
    if i == 0:
        raise ValueError("no convs.{i} entries in the state_dict")
    return {"params": tree}
