"""Serving settings the port reads (counterpart of ``quiver_tpu/config.py``).

Only the two fields the serving slice needs are kept: the bucketed batch
shapes every device pass is padded to, and how many queued requests one
pass may coalesce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["Config", "get_config"]


@dataclass(frozen=True)
class Config:
    serving_buckets: Tuple[int, ...] = (
        8, 16, 32, 64, 128, 256, 512, 1024, 2048
    )
    max_coalesce: int = 8


_DEFAULT = Config()


def get_config() -> Config:
    return _DEFAULT
