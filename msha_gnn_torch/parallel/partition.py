"""Host-side graph partitioners (``msha_gnn_tpu/parallel/partition.py``).

A 1-D edge partition by source range: shard ``i`` gets the senders of
``[i blk, (i + 1) blk)`` (``blk = ceil(n_src / k)``) and all their edges, so
each rank owns a contiguous row block of the adjacency.  Every shard keeps
the global ``(n_src, n_dst)`` coordinates, and its real edges are the
parent's CSR slice in the parent's order (no re-sort), so shard prefixes
concatenate to the parent's CSR order.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from ..graph import BipartiteGraph


def src_block_bounds(n_src: int, k: int) -> np.ndarray:
    """Uniform ``ceil(n_src / k)``-sized row-block bounds (length k + 1)."""
    blk = -(-n_src // k)
    return np.minimum(np.arange(k + 1, dtype=np.int64) * blk, n_src)


def _host_edges(graph: BipartiteGraph):
    e = graph.num_edges
    return (graph.senders[:e].cpu().numpy().astype(np.int64),
            graph.receivers[:e].cpu().numpy().astype(np.int64),
            graph.weight[:e].cpu().numpy().astype(np.float32))


def _piece(graph, s, r, w, pad_to_multiple):
    return BipartiteGraph.from_coo(s, r, w, n_src=graph.n_src,
                                   n_dst=graph.n_dst,
                                   pad_to_multiple=pad_to_multiple,
                                   assume_sorted=True)


def partition_edges_by_src(graph: BipartiteGraph, k: int, *,
                           pad_to_multiple: int = 128
                           ) -> List[BipartiteGraph]:
    """``k`` subgraphs over contiguous sender ranges (host graphs)."""
    s, r, w = _host_edges(graph)
    ptr = graph.row_ptr.cpu().numpy().astype(np.int64)
    bounds = src_block_bounds(graph.n_src, k)
    return [_piece(graph, s[ptr[lo]:ptr[hi]], r[ptr[lo]:ptr[hi]],
                   w[ptr[lo]:ptr[hi]], pad_to_multiple)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def balanced_edge_partition(graph: BipartiteGraph, k: int, *,
                            pad_to_multiple: int = 128
                            ) -> List[BipartiteGraph]:
    """``k`` subgraphs of (nearly) equal edge count, each a contiguous
    range of the CSR edges; a source row across a boundary gives partial
    rows that sum to the whole."""
    s, r, w = _host_edges(graph)
    bounds = np.linspace(0, graph.num_edges, k + 1).astype(np.int64)
    return [_piece(graph, s[lo:hi], r[lo:hi], w[lo:hi], pad_to_multiple)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


class Shard(NamedTuple):
    """Shard ``i``'s CSR row block: ``row_blk`` local rows, its edges ``[lo,
    hi)`` of the parent's CSR order, the senders localised to the block,
    the global receivers and the weights."""

    row_blk: int
    lo: int
    hi: int
    senders: np.ndarray
    receivers: np.ndarray
    weight: np.ndarray


def shard_rows(graph: BipartiteGraph, k: int, i: int) -> Shard:
    """Shard ``i`` of ``k`` of :func:`partition_edges_by_src`, as the
    arrays a rank keeps (the parent's CSR slice, senders made local)."""
    ptr = graph.row_ptr.cpu().numpy().astype(np.int64)
    bounds = src_block_bounds(graph.n_src, k)
    row_lo, row_hi = int(bounds[i]), int(bounds[i + 1])
    lo, hi = int(ptr[row_lo]), int(ptr[row_hi])
    return Shard(-(-graph.n_src // k), lo, hi,
                 graph.senders[lo:hi].cpu().numpy().astype(np.int64) - row_lo,
                 graph.receivers[lo:hi].cpu().numpy().astype(np.int64),
                 graph.weight[lo:hi].cpu().numpy().astype(np.float32))


def shard_graph(shard: Shard, n_cols: int) -> BipartiteGraph:
    """A shard as a host graph of ``row_blk`` local rows over ``n_cols``
    columns (the gathered destination rows), its edges in the parent's
    order."""
    return BipartiteGraph.from_coo(shard.senders, shard.receivers,
                                   shard.weight, n_src=shard.row_blk,
                                   n_dst=n_cols, assume_sorted=True)
