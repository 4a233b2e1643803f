from .convert import (gcn_params_from_jax, linkpred_params_from_jax,
                      msha_layer_params_from_jax, msha_params_from_jax,
                      sparse_gat_layer_params_from_jax)
from .gat import MaskedGATLayer, SparseGAT, SparseGATLayer
from .gcn import GCN, GraphConvolution
from .mlp import MLP, LinkPredictor
from .msha import MSHA, MSHALayer

__all__ = ["GCN", "GraphConvolution", "MLP", "LinkPredictor",
           "MaskedGATLayer", "MSHA", "MSHALayer", "SparseGAT",
           "SparseGATLayer", "gcn_params_from_jax",
           "linkpred_params_from_jax", "msha_layer_params_from_jax",
           "msha_params_from_jax",
           "sparse_gat_layer_params_from_jax"]
