"""Process hand-off of features and samplers (counterpart of
``quiver_tpu/multiprocessing``): importing this package registers
``ForkingPickler`` reducers, so a :class:`~quiver_tpu_torch.Feature` or
:class:`~quiver_tpu_torch.GraphSageSampler` can be passed to a process
started by ``torch.multiprocessing``/``multiprocessing``.

A feature travels as host copies of its hot and cold tiers and its row
order and is rebuilt lazily, on its device, at its first use; a sampler
travels as its host topology and options and places its tables on its
device when rebuilt.  Threads in one process (the mixed sampler, the
serving lanes) need none of this.
"""

from . import reductions  # noqa: F401  (registers the reducers)

__all__ = ["reductions"]
