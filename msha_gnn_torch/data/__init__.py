from .flow import (
    load_flow_graph,
    load_flow_records,
    load_gdp,
    load_index_match,
    synthetic_flow,
    train_test_split_records,
)
from .ogb import load_ddi, load_ogbl_ddi, split_edges, synthetic_ddi

__all__ = [
    "load_ddi",
    "load_ogbl_ddi",
    "split_edges",
    "synthetic_ddi",
    "load_flow_graph",
    "load_flow_records",
    "load_gdp",
    "load_index_match",
    "synthetic_flow",
    "train_test_split_records",
]
