from .convert import (gat_params_from_jax, gcn_params_from_jax,
                      hgane_params_from_jax, linkpred_params_from_jax,
                      llp_params_from_jax,
                      msha_layer_params_from_jax, msha_params_from_jax,
                      sage_params_from_jax, scale_params_from_jax,
                      sparse_gat_layer_params_from_jax)
from .gat import GAT, MaskedGATLayer, SparseGAT, SparseGATLayer
from .gcn import GCN, GraphConvolution
from .hgane import HGANELayer
from .mlp import MLP, LinkPredictor
from .msha import MSHA, MSHALayer
from .sage import GraphSAGE, gather_dense_rows

__all__ = ["GAT", "GCN", "GraphConvolution", "GraphSAGE", "HGANELayer",
           "MLP", "LinkPredictor", "MaskedGATLayer", "MSHA", "MSHALayer",
           "SparseGAT", "SparseGATLayer", "gat_params_from_jax",
           "gather_dense_rows", "gcn_params_from_jax",
           "hgane_params_from_jax", "linkpred_params_from_jax",
           "llp_params_from_jax",
           "msha_layer_params_from_jax", "msha_params_from_jax",
           "sage_params_from_jax", "scale_params_from_jax",
           "sparse_gat_layer_params_from_jax"]
