from .flow import (
    load_flow_graph,
    load_flow_records,
    load_gdp,
    load_index_match,
    synthetic_flow,
    train_test_split_records,
)

__all__ = [
    "load_flow_graph",
    "load_flow_records",
    "load_gdp",
    "load_index_match",
    "synthetic_flow",
    "train_test_split_records",
]
