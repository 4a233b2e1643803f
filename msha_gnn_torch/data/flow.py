"""Loaders for the anonymised yearly flow-graph dataset
(``msha_gnn_tpu/data/flow.py``), into the port's containers.

File schemas:

* ``Adjacent{year}.json`` (gbk): ``{"source_index": {"<idx>": [city_id,
  province_id]}, "recipient_index": {"<province name>": idx}}``.
* ``Flow{year}.csv``: a header row, then 4 int columns ``source,
  recipient, city, province``, one row per flow record.
* ``GDP{year}.json`` (gbk): ``{"GDP_embedding": {"<node idx>": float}}``.

:func:`synthetic_flow` builds a flow graph of any shape from a seed, with
the same numpy draws as the JAX package's synthetic builder, so both
packages get identical data from one seed.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..graph import BipartiteGraph, FlowGraph, Grouping

# relative to the working directory
DEFAULT_DATA_DIR = "anonymous_data"


def load_flow_records(path: str) -> np.ndarray:
    """Read ``Flow{year}.csv`` -> int array [num_records, 4]."""
    return np.loadtxt(path, dtype=np.int64, delimiter=",", skiprows=1,
                      ndmin=2)


def load_index_match(path: str):
    """Read ``Adjacent{year}.json`` -> (city_id [N], province_id [N],
    recipient_name_to_idx dict)."""
    with open(path, "r", encoding="gbk") as f:
        data = json.load(f)
    src = data["source_index"]
    n = len(src)
    city = np.zeros(n, np.int32)
    prov = np.zeros(n, np.int32)
    for k, v in src.items():
        i = int(k)
        city[i] = v[0]
        prov[i] = v[1]
    return city, prov, data["recipient_index"]


def load_gdp(path: str, n: Optional[int] = None) -> np.ndarray:
    with open(path, "r", encoding="gbk") as f:
        data = json.load(f)["GDP_embedding"]
    if n is None:
        n = len(data)
    out = np.zeros(n, np.float32)
    for k, v in data.items():
        out[int(k)] = v
    return out


def _flow_graph(edge_src, edge_dst, city, prov, gdp, n, m,
                pad_to_multiple) -> FlowGraph:
    inter = BipartiteGraph.from_coo(
        edge_src, edge_dst, np.ones(edge_src.shape[0], np.float32),
        n_src=n, n_dst=m, pad_to_multiple=pad_to_multiple,
    )
    return FlowGraph(
        inter=inter,
        city=Grouping.from_ids(city),
        province=Grouping.from_ids(prov),
        gdp=torch.from_numpy(np.asarray(gdp, np.float32)),
        edge_src=torch.from_numpy(np.asarray(edge_src, np.int32)),
        edge_dst=torch.from_numpy(np.asarray(edge_dst, np.int32)),
    )


def load_flow_graph(
    year: str = "2015",
    data_dir: str = DEFAULT_DATA_DIR,
    *,
    pad_to_multiple: int = 128,
) -> FlowGraph:
    """Load one year of the dataset into a :class:`FlowGraph` (on the CPU).

    A year without a Flow CSV gets an empty bipartite graph.
    """
    city, prov, recipient_index = load_index_match(
        os.path.join(data_dir, f"Adjacent{year}.json")
    )
    n = city.shape[0]
    m = len(recipient_index)
    gdp = load_gdp(os.path.join(data_dir, f"GDP{year}.json"), n)

    flow_path = os.path.join(data_dir, f"Flow{year}.csv")
    if os.path.exists(flow_path):
        records = load_flow_records(flow_path)
        edge_src = records[:, 0].astype(np.int32)
        edge_dst = records[:, 1].astype(np.int32)
    else:
        edge_src = np.zeros(0, np.int32)
        edge_dst = np.zeros(0, np.int32)
    return _flow_graph(edge_src, edge_dst, city, prov, gdp, n, m,
                       pad_to_multiple)


def synthetic_flow(n: int, m: int, n_city: int, n_prov: int, records: int,
                   seed: int = 0, pad: int = 128) -> FlowGraph:
    """A flow graph whose recipients follow the source's province.

    ``synthetic_flow(39179, 32, 291, 32, 233887)`` has the 2015 data's
    shape: 39,179 sources, 32 recipients, 233,887 records.
    """
    rng = np.random.default_rng(seed)
    prov = rng.integers(0, n_prov, n)
    city = rng.integers(0, n_city, n)
    src = rng.integers(0, n, records).astype(np.int32)
    dst = ((prov[src] + rng.integers(0, 3, records)) % m).astype(np.int32)
    gdp = rng.random(n).astype(np.float32)
    return _flow_graph(src, dst, city, prov, gdp, n, m, pad)


def train_test_split_records(
    num_records: int, train_fraction: float = 0.9, seed: int = 0
):
    """Deterministic 90/10 record split returning index arrays."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_records)
    n_train = int(train_fraction * num_records)
    return perm[:n_train], perm[n_train:]
