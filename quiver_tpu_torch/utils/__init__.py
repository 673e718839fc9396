from .device import resolve_device
from .synthetic import synthetic_csr
from .topology import (CSRTopo, coo_to_csr, parse_size, reindex_by_config,
                       reindex_feature)

__all__ = ["CSRTopo", "coo_to_csr", "parse_size", "reindex_by_config",
           "reindex_feature", "resolve_device", "synthetic_csr"]
