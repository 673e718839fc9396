"""Joining worker threads with one deadline: :func:`join_and_reap` lives
in :mod:`quiver_tpu_torch.resilience.shutdown` (it ticks
``serving_thread_leak_total{component}``); this module re-exports it for
the modules that import it from here."""

from ..resilience.shutdown import join_and_reap

__all__ = ["join_and_reap"]
