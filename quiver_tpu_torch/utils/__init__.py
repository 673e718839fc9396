from .device import resolve_device
from .synthetic import (community_graph, synthetic_csr, synthetic_products,
                        synthetic_reddit)
from .topology import (CSRTopo, coo_to_csr, parse_size, reindex_by_config,
                       reindex_feature)

__all__ = ["CSRTopo", "community_graph", "coo_to_csr", "parse_size",
           "reindex_by_config", "reindex_feature", "resolve_device",
           "synthetic_csr", "synthetic_products", "synthetic_reddit"]
