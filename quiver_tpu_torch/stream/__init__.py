"""Graph mutation as a workload (counterpart of ``quiver_tpu/stream``).

The streaming tier layers a **delta-CSR overlay** (append-only edge
segment + tombstone table, ``stream.delta`` / ``stream.graph``) over the
frozen base CSR, samples through it on the device
(``ops.sample.sample_neighbors_overlay``, every read through kernel B3
under the default gather mode, optional time windows), folds it back into
a fresh base on cadence (``stream.compactor``), and admits edge updates
through a bounded lane with its own deadline class (``stream.ingest``).

Quick start::

    from quiver_tpu_torch.stream import StreamingGraph, IngestLane
    g = StreamingGraph(csr_topo, edge_ts=ts)       # ts optional
    sampler = GraphSageSampler(g, sizes=[10, 5])   # overlay-aware
    g.attach_feature(feature)                      # row invalidation
    lane = IngestLane(g).start()                   # serving ingestion
    lane.submit(src, dst, ts=now)                  # ack on lane.results
    batch = sampler.sample(seeds, time_window=(t0, t1))
"""

from .compactor import Compactor, compact
from .delta import DeltaStore
from .graph import DeltaSnapshot, StreamingGraph
from .ingest import EdgeUpdate, IngestLane

__all__ = [
    "StreamingGraph", "DeltaSnapshot", "DeltaStore",
    "Compactor", "compact", "EdgeUpdate", "IngestLane",
]
