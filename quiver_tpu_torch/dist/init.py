"""Multi-process bootstrap and hybrid meshes (counterpart of
``quiver_tpu/dist/init.py``).

JAX's bootstrap is ``jax.distributed.initialize``; the port's is
``torch.distributed.init_process_group``, given its address, world size
and rank by the caller (nothing on a machine tells a program of a
cluster).  The mesh layout is what remains worth wrapping: the slow axis
(``dcn``, across processes) major and the fast one (``ici``, the cards of
one process) minor, so shards exchange among a process's cards and only
partition traffic crosses processes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.mesh import Mesh, visible_cards

__all__ = ["initialize", "make_hybrid_mesh"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None):
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``, with NCCL where there is a card
    and gloo otherwise (or ``backend``).  Without an address, or when the
    group already exists, nothing is started.  Returns ``(world size,
    rank)``: ``(1, 0)`` in a single process."""
    import torch.distributed as dist

    if not dist.is_available():
        return 1, 0
    if not dist.is_initialized() and coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize needs num_processes and process_id "
                             "with a coordinator address")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        addr = coordinator_address
        if "://" not in addr:
            addr = "tcp://" + addr
        dist.init_process_group(backend, init_method=addr,
                                world_size=int(num_processes),
                                rank=int(process_id))
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def make_hybrid_mesh(ici_axis: str = "ici", dcn_axis: str = "dcn",
                     devices: Optional[Sequence] = None) -> Mesh:
    """Mesh ``[n_processes, devices_per_process]``, ``dcn`` major, ``ici``
    minor.  In one process it is ``[1, n]`` over ``devices`` (default:
    every card), so code written against both axes runs unchanged.
    Across processes each row names the devices of one rank; a single
    controller drives only its own row (collectives over ``dcn`` go
    through :class:`~quiver_tpu_torch.dist.comm.TpuComm`'s process
    group)."""
    world, _ = initialize()
    devs = list(devices) if devices is not None else visible_cards()
    grid = np.empty((world, len(devs)), dtype=object)
    for r in range(world):
        grid[r, :] = devs
    return Mesh(grid, (dcn_axis, ici_axis))
