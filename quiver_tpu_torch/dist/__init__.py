"""``quiver_tpu_torch.dist``: sharding across devices (counterpart of
``quiver_tpu/dist``).  Single-controller, as in JAX: one process drives a
mesh of devices, a sharded value is one tensor a shard, and the
collectives are in-process (``comm.py``); ``torch.distributed`` enters only
at the multi-process bootstrap (``init.py``) and under ``TpuComm`` over a
process group."""

from .comm import TpuComm, all_to_all, getNcclId, pmax, ppermute, psum
from .feature import DistFeature, PartitionInfo
from .hier import HierFeature
from .init import initialize, make_hybrid_mesh
from .ring import RingFeature
from .sampler import DistGraphSampler, plan_row_shards, shard_csr_by_rows

__all__ = ["TpuComm", "getNcclId", "psum", "pmax", "all_to_all", "ppermute",
           "DistFeature", "PartitionInfo", "HierFeature", "initialize",
           "make_hybrid_mesh", "RingFeature", "DistGraphSampler",
           "plan_row_shards", "shard_csr_by_rows"]
