"""Edge samplers for link prediction (``msha_gnn_tpu/data/sampler.py``).

* :func:`sample_negatives`: uniform negative endpoints, ``ns_rate`` per
  positive.
* :func:`sample_positives_nearby` ('nb'): for each anchor, ``rw_step``
  positives drawn from its direct neighbours.
* :func:`sample_positives_rw` ('rw'): ``hops``-step random walks from each
  anchor; the walks' endpoints are the positives.
* :func:`neighbor_sample_subgraph`: the one-hop neighbour-sampled
  subgraph of per-epoch sampled link prediction.

All are host numpy on graphs that lie on the CPU.  From one
``np.random.Generator`` state they make the JAX package's calls in the
same order (``rng.random``, ``rng.integers``, ``np.lexsort``), so they give
the same arrays.
"""

from __future__ import annotations

import numpy as np

from ..graph import BipartiteGraph


def _csr_arrays(graph: BipartiteGraph):
    """The row pointer and the real edges' receivers, as numpy views of a
    host graph (a graph on the card raises: the samplers run every epoch,
    and a copy back from the device each time is not theirs to make)."""
    if graph.device.type != "cpu":
        raise ValueError(f"the samplers read a graph on the CPU, not on "
                         f"{graph.device}")
    return graph.row_ptr.numpy(), graph.receivers.numpy()[: graph.num_edges]


def sample_negatives(rng: np.random.Generator, num: int, n_nodes: int,
                     ns_rate: int = 1) -> np.ndarray:
    """[num * ns_rate] uniform random node ids (negative endpoints)."""
    return rng.integers(0, n_nodes, num * ns_rate).astype(np.int32)


def sample_positives_nearby(rng: np.random.Generator, graph: BipartiteGraph,
                            anchors: np.ndarray, rw_step: int = 3) -> tuple:
    """'nb' positive sampling: for each anchor, ``rw_step`` neighbours
    drawn uniformly from its adjacency row; anchors with no edges are
    dropped.  Returns ``(anchor_rep, positives)``."""
    ptr, recv = _csr_arrays(graph)
    deg = ptr[anchors + 1] - ptr[anchors]
    keep = deg > 0
    anchors = anchors[keep]
    deg = deg[keep]
    anchor_rep = np.repeat(anchors, rw_step)
    deg_rep = np.repeat(deg, rw_step)
    start_rep = np.repeat(ptr[anchors], rw_step)
    offs = (rng.random(anchor_rep.shape[0]) * deg_rep).astype(np.int64)
    return anchor_rep.astype(np.int32), recv[start_rep + offs].astype(np.int32)


def sample_positives_rw(rng: np.random.Generator, graph: BipartiteGraph,
                        reverse: BipartiteGraph, anchors: np.ndarray,
                        hops: int = 2, rw_step: int = 3) -> tuple:
    """'rw' positive sampling on a bipartite graph: forward (``graph``) and
    reverse (``reverse``, its transpose) steps alternate for ``hops`` hops,
    ``rw_step`` walks an anchor.  A walk that reaches a row with no edges
    is dropped.  Returns ``(anchor_rep, endpoints, on_src_side)``: the
    endpoints' side follows the parity of ``hops``.

    A dropped walk reads row 0 in place of its stale node, whose id
    belongs to the other side (the JAX function reads the stale id, and
    raises when it is past that side's rows); the draws and every live
    walk are the JAX function's."""
    fwd_ptr, fwd_recv = _csr_arrays(graph)
    rev_ptr, rev_recv = _csr_arrays(reverse)
    anchor_rep = np.repeat(anchors, rw_step).astype(np.int64)
    cur = anchor_rep.copy()
    alive = np.ones(cur.shape[0], bool)
    on_src_side = True
    for _ in range(hops):
        ptr, recv = (fwd_ptr, fwd_recv) if on_src_side else (rev_ptr,
                                                             rev_recv)
        row = np.where(alive, cur, 0)
        deg = ptr[row + 1] - ptr[row]
        alive &= deg > 0
        safe_deg = np.maximum(deg, 1)
        offs = (rng.random(cur.shape[0]) * safe_deg).astype(np.int64)
        nxt = recv[np.minimum(ptr[row] + offs, len(recv) - 1)]
        cur = np.where(alive, nxt, cur)
        on_src_side = not on_src_side
    return (anchor_rep[alive].astype(np.int32), cur[alive].astype(np.int32),
            on_src_side)


def neighbor_sample_subgraph(rng: np.random.Generator, graph: BipartiteGraph,
                             seed_nodes: np.ndarray, fanout: int, *,
                             pad_to_multiple: int = 128) -> BipartiteGraph:
    """One-hop neighbour-sampled subgraph (BASELINE config #4): at most
    ``fanout`` edges of each seed source node, drawn uniformly without
    replacement, with their weights.

    Every candidate edge gets a random key, the keys are ranked within
    their seed's segment (one ``np.lexsort``), and the ``min(deg,
    fanout)`` smallest win.  The result is a host graph with its own edge
    count, padded to ``pad_to_multiple``.
    """
    ptr, recv = _csr_arrays(graph)
    w = graph.weight.numpy()[: graph.num_edges]

    seeds = np.asarray(seed_nodes, np.int64)
    deg = ptr[seeds + 1] - ptr[seeds]
    keep = deg > 0
    seeds, deg = seeds[keep], deg[keep].astype(np.int64)
    if seeds.size == 0:
        return BipartiteGraph.from_coo(
            [], [], [], n_src=graph.n_src, n_dst=graph.n_dst,
            pad_to_multiple=pad_to_multiple)

    total = int(deg.sum())
    seg_start = np.cumsum(deg) - deg          # each seed's first candidate
    seg_id = np.repeat(np.arange(seeds.size), deg)
    # candidate c of seed i -> its CSR edge index
    within = np.arange(total, dtype=np.int64) - seg_start[seg_id]
    edge_idx = np.repeat(ptr[seeds], deg) + within

    order = np.lexsort((rng.random(total), seg_id))  # shuffled per segment
    chosen = edge_idx[order][within < fanout]

    # the lexsort is segment-major, so the senders are the seeds repeated
    # by their clipped degrees
    return BipartiteGraph.from_coo(
        np.repeat(seeds, np.minimum(deg, fanout)), recv[chosen], w[chosen],
        n_src=graph.n_src, n_dst=graph.n_dst,
        pad_to_multiple=pad_to_multiple, combine_duplicates=False)
