"""quiver_tpu_torch: the quiver_tpu graph-learning data layer in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100.

The module layout follows ``quiver_tpu``.  This package imports PyTorch,
numpy and the standard library only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead.
"""

from .feature import DeviceConfig, Feature
from .hetero import (HeteroCSRTopo, HeteroFeature, HeteroGraphSageSampler,
                     HeteroLayerBlock, HeteroSampledBatch)
from .loader import SeedLoader
from .models import (GAT, GATConv, GCN, GCNConv, RGAT, GraphSAGE, SAGEConv,
                     full_graph_inference, gat_params_from_flax,
                     gat_params_to_flax, gcn_params_from_flax,
                     gcn_params_to_flax, rgat_params_from_flax,
                     rgat_params_to_flax, sage_params_from_flax,
                     sage_params_to_flax)
from .parallel import Prefetcher, TrainState, make_train_step
from .pipeline import make_fused_eval_fn, make_fused_train_step, make_scan_epoch
from .ops.sample import SampleOut, sample_neighbors, to_ragged
from .sampler import GraphSageSampler, LayerBlock, SampledBatch, run_pipeline
from .serving import (HybridSampler, InferenceServer, InferenceServer_Debug,
                      RequestBatcher, ServingRequest, calibrate_threshold)
from .mixed import MixedGraphSageSampler, SampleJob
from .uva import UVAGraph
from .interop import TorchSampleLoader, to_torch_adjs
from .partition import (load_quiver_feature_partition,
                        partition_without_replication,
                        quiver_partition_feature)
from .neighbour_num import generate_neighbour_num
from . import multiprocessing  # registers the ForkingPickler reducers
from .utils import (CSRTopo, community_graph, coo_to_csr, parse_size,
                    reindex_by_config, reindex_feature, synthetic_csr,
                    synthetic_products, synthetic_reddit)
from .utils.rng import make_key
from .utils.mesh import MeshTopo, make_mesh
from .dist.feature import DistFeature, PartitionInfo
from .dist.comm import TpuComm
from .dist.sampler import DistGraphSampler
from .dist.ring import RingFeature
from .dist.init import initialize as distributed_initialize, make_hybrid_mesh
from .dist.hier import HierFeature

__all__ = [
    "CSRTopo", "DeviceConfig", "DistFeature", "DistGraphSampler", "Feature", "GAT", "GATConv", "GCN", "GCNConv", "GraphSAGE",
    "GraphSageSampler", "HeteroCSRTopo", "HeteroFeature",
    "HeteroGraphSageSampler", "HeteroLayerBlock", "HeteroSampledBatch",
    "HierFeature", "HybridSampler", "InferenceServer", "InferenceServer_Debug",
    "LayerBlock", "MeshTopo", "MixedGraphSageSampler", "PartitionInfo",
    "Prefetcher", "RGAT", "RingFeature",
    "RequestBatcher", "SAGEConv", "SampleJob", "SampleOut", "SampledBatch",
    "SeedLoader", "ServingRequest", "TorchSampleLoader", "TpuComm",
    "TrainState",
    "UVAGraph", "calibrate_threshold", "community_graph", "coo_to_csr",
    "distributed_initialize", "full_graph_inference", "gat_params_from_flax", "gat_params_to_flax",
    "gcn_params_from_flax", "gcn_params_to_flax", "generate_neighbour_num",
    "load_quiver_feature_partition", "make_fused_eval_fn",
    "make_fused_train_step", "make_hybrid_mesh", "make_key", "make_mesh",
    "make_scan_epoch",
    "make_train_step",
    "parse_size", "partition_without_replication", "quiver_partition_feature",
    "reindex_by_config", "reindex_feature", "rgat_params_from_flax",
    "rgat_params_to_flax", "run_pipeline", "sage_params_from_flax",
    "sage_params_to_flax", "sample_neighbors", "synthetic_csr",
    "synthetic_products", "synthetic_reddit", "to_ragged", "to_torch_adjs",
]
