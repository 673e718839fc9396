"""quiver_tpu_torch: the quiver_tpu graph-learning data layer in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100.

The module layout follows ``quiver_tpu``.  This package imports PyTorch,
numpy and the standard library only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.
"""

from .feature import Feature
from .models import GraphSAGE, SAGEConv, sage_params_from_flax
from .ops.sample import SampleOut, sample_neighbors, to_ragged
from .sampler import GraphSageSampler, LayerBlock, SampledBatch, run_pipeline
from .serving import (InferenceServer, InferenceServer_Debug, RequestBatcher,
                      ServingRequest)
from .utils import (CSRTopo, coo_to_csr, parse_size, reindex_by_config,
                    reindex_feature, synthetic_csr)

__all__ = [
    "CSRTopo", "Feature", "GraphSAGE", "GraphSageSampler",
    "InferenceServer", "InferenceServer_Debug", "LayerBlock",
    "RequestBatcher", "SAGEConv", "SampleOut", "SampledBatch",
    "ServingRequest", "coo_to_csr", "parse_size", "reindex_by_config",
    "reindex_feature", "run_pipeline", "sage_params_from_flax",
    "sample_neighbors", "synthetic_csr", "to_ragged",
]
