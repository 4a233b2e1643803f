from .flow import (
    load_flow_graph,
    load_flow_records,
    load_gdp,
    load_index_match,
    synthetic_flow,
    train_test_split_records,
)
from .ogb import load_ddi, load_ogbl_ddi, split_edges, synthetic_ddi
from .raw import classify_major, derive_prefix_table, load_major_table
from .sampler import (
    neighbor_sample_subgraph,
    sample_negatives,
    sample_positives_nearby,
    sample_positives_rw,
)

__all__ = [
    "classify_major",
    "derive_prefix_table",
    "load_ddi",
    "load_ogbl_ddi",
    "split_edges",
    "synthetic_ddi",
    "load_flow_graph",
    "load_flow_records",
    "load_gdp",
    "load_index_match",
    "load_major_table",
    "neighbor_sample_subgraph",
    "sample_negatives",
    "sample_positives_nearby",
    "sample_positives_rw",
    "synthetic_flow",
    "train_test_split_records",
]
