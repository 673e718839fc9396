"""quiverlint v3 staging tier — residency dataflow + no-sync regions.

Two halves, one contract ("the frontier never leaves the device"):

* **Static** — :mod:`.dataflow` classifies every value DEVICE / HOST /
  EITHER interprocedurally over the :class:`Program` model; QT014 reads
  its instance typing.  Its residency sources are still the JAX
  package's (``jnp.*`` calls), which only QT013 would read; the torch
  sources come with that rule.  Import it explicitly
  (``from quiver_tpu_torch.analysis.staging import dataflow``) — it pulls
  in the whole-program machinery and has no business on a serving
  import path.
* **Runtime** — :mod:`.regions` exposes :func:`no_sync`, the region
  marker the hot paths wrap around their device-resident spans, and is
  what this package re-exports: the library-facing surface must stay a
  few dozen lines of stdlib with a one-global-read off switch.

The runtime enforcement lives in
:mod:`quiver_tpu_torch.analysis.transfer_witness` (``QUIVER_SANITIZE=1``).
"""

from .regions import active, no_sync, on

__all__ = ["active", "no_sync", "on"]
