from .convert import (gcn_params_from_jax, linkpred_params_from_jax,
                      sparse_gat_layer_params_from_jax)
from .gat import SparseGAT, SparseGATLayer
from .gcn import GCN, GraphConvolution
from .mlp import MLP, LinkPredictor

__all__ = ["GCN", "GraphConvolution", "MLP", "LinkPredictor", "SparseGAT",
           "SparseGATLayer", "gcn_params_from_jax",
           "linkpred_params_from_jax", "sparse_gat_layer_params_from_jax"]
