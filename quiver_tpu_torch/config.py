"""Settings the port reads (counterpart of ``quiver_tpu/config.py``).

Kept: the bucketed batch shapes every serving pass is padded to, how many
queued requests one pass may coalesce, the sampler's element-gather mode,
and the feature-store knobs of the budgeted path (cold-row overlay and
paged store).  Defaults are the JAX package's, and each field that JAX
reads from the environment reads the same ``QUIVER_TPU_*`` name here, so
a deployment's setting means the same to both packages.  The one default
that differs is where ``gather_mode="auto"`` lands
(:func:`resolve_gather_mode`).

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

__all__ = ["Config", "get_config", "override", "resolve_gather_mode"]

# element-gather modes of the sampler's hops, besides "pwindow[:U]"
_GATHER_MODES = ("auto", "xla", "lanes", "lanes_fused", "pallas")


def _env(name: str, default, cast=str):
    v = os.environ.get(f"QUIVER_TPU_{name}")
    return default if v is None else cast(v)


@dataclass(frozen=True)
class Config:
    serving_buckets: Tuple[int, ...] = (
        8, 16, 32, 64, 128, 256, 512, 1024, 2048
    )
    max_coalesce: int = 8
    # sampler element gathers: "auto" resolves in resolve_gather_mode
    gather_mode: str = field(
        default_factory=lambda: _env("GATHER_MODE", "auto"))
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


def _check_u_mode(mode: str, prefix: str) -> None:
    """Accept ``"<prefix>"`` and ``"<prefix>:U"`` with U >= 1; anything
    else raises, as the JAX package's ``parse_u_mode`` does."""
    if mode == prefix:
        return
    if not mode.startswith(prefix + ":"):
        raise ValueError(f"{prefix} gather mode must be '{prefix}' or "
                         f"'{prefix}:U', got {mode!r}")
    if int(mode.split(":", 1)[1]) < 1:  # ValueError on a bad suffix too
        raise ValueError(f"{prefix}:U needs U >= 1, got {mode!r}")


def _validate_gather_mode(mode) -> None:
    if mode in _GATHER_MODES:
        return
    if isinstance(mode, str) and mode.startswith("pwindow"):
        _check_u_mode(mode, "pwindow")
        return
    if isinstance(mode, str) and mode.startswith("blocked"):
        _check_u_mode(mode, "blocked")
        raise NotImplementedError(
            f"gather_mode={mode!r} (ops/blockgather.py) is not ported yet "
            "(ROADMAP A8)")
    raise ValueError(
        f"gather_mode must be one of {_GATHER_MODES} or 'pwindow[:U]', got "
        f"{mode!r}")


def resolve_gather_mode(gather_mode: str) -> str:
    """The element-gather mode a sampler runs.

    An explicit mode wins, then ``QUIVER_TPU_GATHER_MODE``; ``"auto"``
    resolves to ``"pwindow"``, the fused hop of kernel B1.  (JAX resolves
    it to ``"lanes"`` on an accelerator, a choice made against the TPU's
    serialized scalar gather, which the card does not have.)  Every mode
    draws the same neighbours under the counter-hash RNG; ``pwindow``'s
    ``U`` sizes a TPU VMEM window and is accepted but unused.
    ``"blocked[:U]"`` raises ``NotImplementedError``.
    """
    _validate_gather_mode(gather_mode)
    if gather_mode != "auto":
        return gather_mode
    cfg = get_config().gather_mode
    _validate_gather_mode(cfg)
    return "pwindow" if cfg == "auto" else cfg
