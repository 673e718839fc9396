"""The ``"blocked[:U]"`` gather mode (counterpart of
``quiver_tpu/ops/blockgather.py``).

In the JAX package a seed whose CSR window spans at most ``U`` rows of the
``[rows, 128]`` table is read by one gather of those rows and a lane
select; the other seeds take a compacted per-draw fallback, and when more
than ``B * fallback_frac`` of them do not fit the whole batch takes the
classic per-draw read (``lax.cond``).  Both routes return the same values
bit for bit, the weighted CDF count included.

The port runs ``"blocked[:U]"`` as that classic route: the window reads
and the weighted CDF search go through kernel B3, as every scattered read
of ``"pwindow"`` does (``ops/sample.py::_gather``).  B3 reads each draw's
element once; a block gather beside it could only add reads.  ``U`` is
validated here and not used on the card, as ``"pwindow:U"``'s is not.
"""

from __future__ import annotations

__all__ = ["parse_blocked", "parse_u_mode"]

DEFAULT_U = 3


def parse_u_mode(mode: str, prefix: str, default: int = DEFAULT_U) -> int:
    """``"<prefix>"`` -> ``default``, ``"<prefix>:4"`` -> 4.  Anything
    else (the typo ``"blocked4"``, ``U < 1``) raises ``ValueError``.
    Shared by the ``blocked`` and ``pwindow`` gather modes."""
    if mode == prefix:
        return default
    if mode.startswith(prefix + ":"):
        u = int(mode.split(":", 1)[1])  # ValueError on a bad suffix
        if u < 1:
            raise ValueError(f"{prefix}:U needs U >= 1, got {mode!r}")
        return u
    raise ValueError(f"{prefix} gather mode must be '{prefix}' or "
                     f"'{prefix}:U', got {mode!r}")


def parse_blocked(mode: str) -> int:
    return parse_u_mode(mode, "blocked")
