from .convert import sage_params_from_flax, sage_params_to_flax
from .layers import SAGEConv
from .sage import GraphSAGE

__all__ = ["GraphSAGE", "SAGEConv", "sage_params_from_flax",
           "sage_params_to_flax"]
