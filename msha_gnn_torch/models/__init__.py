from .convert import gcn_params_from_jax
from .gcn import GCN, GraphConvolution

__all__ = ["GCN", "GraphConvolution", "gcn_params_from_jax"]
