"""Checkpoint and resume (counterpart of the JAX package's
``utils/checkpoint.py``).

:func:`save_checkpoint` writes ``{path}/ckpt_{step}.pt`` with
``torch.save``: the model's and the optimizer's ``state_dict`` of a
:class:`~quiver_tpu_torch.parallel.TrainState`, the step and ``extra``.
It publishes atomically: a temporary name, then ``os.replace``.
:func:`latest_checkpoint` and the root-versus-leaf resolution of
:func:`load_checkpoint` follow the JAX package's rules, and also see its
layouts (``ckpt_<step>.pkl``, an orbax ``ckpt_<step>/`` directory); the
port cannot read those (they need flax and optax classes) and says so.
A checkpoint is read with ``torch.load(weights_only=True)``, which runs
no pickled code: ``extra`` holds plain values (numbers, strings, lists,
dicts, tensors).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_SUFFIXES = (".pt", ".pkl")


def save_checkpoint(path: str, state, step: int,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write step ``step`` of ``state``; returns the checkpoint's path.
    ``extra`` holds plain values that ``weights_only`` loading accepts."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "extra": extra or {},
    }
    f = os.path.join(path, f"ckpt_{step}.pt")
    tmp = f + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, f)  # atomic publish
    return f


def _step_of(name: str) -> Optional[int]:
    if not name.startswith("ckpt_") or name.endswith(".tmp"):
        return None
    stem = name[5:]
    for suffix in _SUFFIXES:
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    try:
        return int(stem)
    except ValueError:
        return None


def latest_checkpoint(path: str) -> Optional[str]:
    """Newest checkpoint under ``path``: the largest step among
    ``ckpt_<step>``, ``ckpt_<step>.pt`` and ``ckpt_<step>.pkl`` (temporary
    ``.tmp`` names left out), or None."""
    if not os.path.isdir(path):
        return None
    best_step, best = -1, None
    for f in os.listdir(path):
        step = _step_of(f)
        if step is not None and step > best_step:
            best_step, best = step, os.path.join(path, f)
    return best


def load_checkpoint(path_or_file: str, state=None):
    """Load a checkpoint: a ``.pt`` file, or the newest under a root
    directory.  With ``state`` given, its model and optimizer are restored
    in place, on the state's device, and ``(state, step)`` comes back;
    else the payload dict (tensors on the CPU)."""
    f = path_or_file
    if os.path.isdir(f):
        resolved = latest_checkpoint(f)
        if resolved is None:
            if os.path.exists(os.path.join(f, "_CHECKPOINT_METADATA")):
                resolved = f  # an orbax leaf: refused below
            else:
                raise FileNotFoundError(f"no checkpoints under "
                                        f"{path_or_file}")
        f = resolved
    if not f.endswith(".pt"):
        raise ValueError(
            f"{f} is a checkpoint of the JAX package (pickle or orbax); "
            "the port reads only its own torch.save format")
    if state is None:
        return torch.load(f, map_location="cpu", weights_only=True)
    device = next(state.model.parameters()).device
    payload = torch.load(f, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    return state, int(payload["step"])
