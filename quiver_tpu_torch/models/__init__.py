from .convert import (gat_params_from_flax, gat_params_to_flax,
                      gcn_params_from_flax, gcn_params_to_flax,
                      rgat_params_from_flax, rgat_params_to_flax,
                      sage_params_from_flax, sage_params_to_flax)
from .gat import GAT
from .gcn import GCN, GCNConv
from .inference import full_graph_inference
from .layers import GATConv, SAGEConv
from .rgat import RGAT
from .sage import GraphSAGE

__all__ = ["GAT", "GATConv", "GCN", "GCNConv", "GraphSAGE", "RGAT",
           "SAGEConv", "full_graph_inference", "gat_params_from_flax",
           "gat_params_to_flax", "gcn_params_from_flax", "gcn_params_to_flax",
           "rgat_params_from_flax", "rgat_params_to_flax",
           "sage_params_from_flax", "sage_params_to_flax"]
