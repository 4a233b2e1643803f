from .common import (BatchNorm, features_with_gdp, gdp_feature_init,
                     xavier_uniform)
from .convert import (gat_params_from_jax, gcn_params_from_jax,
                      hgane_params_from_jax, linkpred_params_from_jax,
                      llp_params_from_jax,
                      msha_layer_params_from_jax, msha_params_from_jax,
                      sage_params_from_jax, scale_params_from_jax,
                      sparse_gat_layer_params_from_jax,
                      temporal_msha_params_from_jax)
from .gat import GAT, MaskedGATLayer, SparseGAT, SparseGATLayer
from .gcn import GCN, GraphConvolution
from .hgane import HGANELayer
from .mlp import MLP, LinkPredictor
from .msha import MSHA, MSHALayer
from .sage import GraphSAGE, gather_dense_rows

__all__ = ["BatchNorm", "GAT", "GCN", "GraphConvolution", "GraphSAGE",
           "HGANELayer", "MLP", "LinkPredictor", "MaskedGATLayer", "MSHA",
           "MSHALayer",
           "SparseGAT", "SparseGATLayer", "features_with_gdp",
           "gat_params_from_jax", "gdp_feature_init",
           "gather_dense_rows", "gcn_params_from_jax",
           "hgane_params_from_jax", "linkpred_params_from_jax",
           "llp_params_from_jax",
           "msha_layer_params_from_jax", "msha_params_from_jax",
           "sage_params_from_jax", "scale_params_from_jax",
           "sparse_gat_layer_params_from_jax",
           "temporal_msha_params_from_jax", "xavier_uniform"]
