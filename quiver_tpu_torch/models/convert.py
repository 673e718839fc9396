"""Parameter conversion from the JAX package's Flax GraphSAGE."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["sage_params_from_flax"]


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
