"""Settings the port reads (counterpart of ``quiver_tpu/config.py``).

Kept: the bucketed batch shapes every serving pass is padded to, how many
queued requests one pass may coalesce, and the feature-store knobs of the
budgeted path (cold-row overlay and paged store).  Defaults are the JAX
package's, and each feature-store field reads the same ``QUIVER_TPU_*``
environment name, so a deployment's setting means the same to both
packages.

The configuration is built once per process, at first use.
:func:`override` swaps in a changed copy for the length of a ``with``
block, so a test's settings never leak into the next test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

__all__ = ["Config", "get_config", "override"]


def _env(name: str, default, cast=str):
    v = os.environ.get(f"QUIVER_TPU_{name}")
    return default if v is None else cast(v)


@dataclass(frozen=True)
class Config:
    serving_buckets: Tuple[int, ...] = (
        8, 16, 32, 64, 128, 256, 512, 1024, 2048
    )
    max_coalesce: int = 8
    # cold-row overlay: "auto" = off until enable_cold_cache() or the
    # serving lane's auto-enable; "off"/"0" = never; a size ("64M", or
    # rows under cache_unit="rows") enables it when the feature is built
    cold_cache_size: str = field(
        default_factory=lambda: _env("COLD_CACHE_SIZE", "auto"))
    cold_cache_policy: str = field(
        default_factory=lambda: _env("COLD_CACHE_POLICY", "clock"))
    cold_cache_admit: int = field(
        default_factory=lambda: _env("COLD_CACHE_ADMIT", 2, int))
    # paged store: "on" serves budgeted gathers through kernel B5;
    # page_rows = 0 and page_pool = 0 size pages and pool automatically
    feature_paged: str = field(
        default_factory=lambda: _env("FEATURE_PAGED", "off"))
    feature_page_rows: int = field(
        default_factory=lambda: _env("FEATURE_PAGE_ROWS", 0, int))
    feature_page_pool: int = field(
        default_factory=lambda: _env("FEATURE_PAGE_POOL", 0, int))


_lock = threading.Lock()
_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    cfg = _config
    if cfg is None:
        with _lock:
            if _config is None:
                _config = Config()
            cfg = _config
    return cfg


@contextlib.contextmanager
def override(**changes) -> Iterator[Config]:
    """Run a block with some fields changed; the previous configuration
    comes back when the block ends, however it ends."""
    global _config
    prev = get_config()
    new = dataclasses.replace(prev, **changes)
    with _lock:
        _config = new
    try:
        yield new
    finally:
        with _lock:
            _config = prev
