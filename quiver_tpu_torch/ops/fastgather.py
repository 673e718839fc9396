"""Lane-select element gather (counterpart of ``quiver_tpu/ops/fastgather.py``).

``element_gather(table2d, idx)`` is ``table2d.reshape(-1)[idx]`` computed
as the JAX package computes it for its ``"lanes"`` and ``"lanes_fused"``
gather modes: gather the covering 128-lane row of every element, then
select the lane.  On the TPU that sidestepped a serialized scalar gather;
the card has no such limit, so the port keeps the two modes for users
who pick them and for parity, not for speed.

``fused=False`` is the row gather and a one-hot lane sum in plain PyTorch
(no kernel, as in JAX); it materializes the ``[M, 128]`` rows, 128 times
the payload.  ``fused=True`` is kernel B4's fused entry
(``ops/cuda/lane_select.py::lane_select_rows``), which reads each selected
element straight from the table: on the card the rows never land in device
memory, as on the TPU, where the row gather streams into the Pallas
kernel through VMEM.  On the CPU it is the row gather and B4's plain
version.

Floating results follow JAX's lane sum, which adds zeros to the selected
element: a ``-0.0`` comes back as ``+0.0``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LANES", "element_gather", "prepare_table", "pad_table_128"]

LANES = 128


def prepare_table(table: torch.Tensor) -> torch.Tensor:
    """Zero-pad a 1-D table to a multiple of 128 and view it as
    ``[rows, 128]``."""
    return pad_table_128(table).reshape(-1, LANES)


def pad_table_128(table, fill=None):
    """Pad a 1-D table (numpy or torch, returned as such) to a multiple of
    128 with zeros, or with ``fill``.  The ``lanes``, ``lanes_fused`` and
    ``pallas`` gather modes need 128-multiple tables."""
    pad = (-table.shape[0]) % LANES
    if not pad:
        return table
    val = 0 if fill is None else fill
    if isinstance(table, torch.Tensor):
        return torch.cat([table, torch.full((pad,), val, dtype=table.dtype,
                                            device=table.device)])
    table = np.asarray(table)
    return np.concatenate([table, np.full((pad,), val, table.dtype)])


def element_gather(table2d: torch.Tensor, idx: torch.Tensor,
                   fused: bool = False) -> torch.Tensor:
    """``table2d.reshape(-1)[idx]`` by row gather and lane select.

    Args:
      table2d: ``[rows, 128]`` (:func:`prepare_table`).
      idx: int32 flat element indices of any shape, each below
        ``rows * 128``.
      fused: read the elements with kernel B4's fused entry instead of a
        row gather and a one-hot sum.
    """
    shape = idx.shape
    flat = idx.reshape(-1).to(torch.int32)
    row = torch.bitwise_right_shift(flat, 7)  # idx >= 0: the logical shift
    lane = torch.bitwise_and(flat, LANES - 1)
    if fused:
        from .cuda.lane_select import lane_select_rows

        return lane_select_rows(table2d, row, lane).reshape(shape)
    rows = table2d.index_select(0, row)                  # [M, 128]
    onehot = lane[:, None] == torch.arange(LANES, dtype=torch.int32,
                                           device=lane.device)[None, :]
    out = torch.where(onehot, rows, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device))
    return out.sum(dim=1, dtype=table2d.dtype).reshape(shape)
