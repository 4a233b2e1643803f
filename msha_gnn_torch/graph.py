"""Graph containers, as ``msha_gnn_tpu/graph.py`` defines them, over torch
tensors.

* :class:`BipartiteGraph` — a padded COO + CSR edge set for the N -> M flow
  graph.  Edge order, padding and dtypes are those of the JAX package:
  edges sorted by (sender, receiver), pad edges with ``sender == n_src``,
  ``receiver == n_dst`` and weight 0, the edge arrays padded to a multiple
  of ``pad_to_multiple``.  The order matters beyond this slice: the
  training path's dropout hash keys on the edge slot.
* :class:`Grouping` — a union-of-cliques adjacency kept as per-node group
  ids (same-city / same-province).
* :class:`PairGrouping` — the joint index over the unique pairs of two
  groupings, which fuses MSHA's city and province broadcasts into one.
* :class:`FlowGraph` — the dataset bundle.

Graphs are built on the host and live on the CPU until their ``to``
moves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.segment import segment_sum


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class BipartiteGraph:
    """Padded COO + CSR edge set for an ``n_src -> n_dst`` bipartite graph.

    ``weight`` holds the flow count, or the normalised value after
    :func:`normalize_by_dst_degree`.
    """

    senders: torch.Tensor    # [E_pad] int32, sorted ascending; pad = n_src
    receivers: torch.Tensor  # [E_pad] int32; pad = n_dst
    weight: torch.Tensor     # [E_pad] float32; pad = 0
    row_ptr: torch.Tensor    # [n_src + 1] int32 CSR offsets
    n_src: int
    n_dst: int
    num_edges: int

    @property
    def edge_mask(self) -> torch.Tensor:
        """[E_pad] bool — True for real edges."""
        return self.senders < self.n_src

    @property
    def num_padded_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def to(self, device) -> "BipartiteGraph":
        return dataclasses.replace(
            self,
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            weight=self.weight.to(device),
            row_ptr=self.row_ptr.to(device),
        )

    def to_dense(self) -> torch.Tensor:
        """The dense [n_src, n_dst] weight matrix (tests, small graphs)."""
        dense = torch.zeros((self.n_src + 1, self.n_dst + 1),
                            dtype=self.weight.dtype, device=self.device)
        dense.index_put_((self.senders.long(), self.receivers.long()),
                         self.weight, accumulate=True)
        return dense[: self.n_src, : self.n_dst]

    def with_weight(self, weight: torch.Tensor) -> "BipartiteGraph":
        return dataclasses.replace(self, weight=weight)

    @staticmethod
    def from_coo(
        senders,
        receivers,
        weight,
        *,
        n_src: int,
        n_dst: int,
        pad_to_multiple: int = 128,
        combine_duplicates: bool = True,
        assume_sorted: bool = False,
    ) -> "BipartiteGraph":
        """Build a sorted, padded graph from host COO arrays.

        Duplicate ``(s, r)`` pairs are summed into one weighted edge.  The
        ``unique`` + ``lexsort`` build gives the (sender, receiver) order
        the JAX package's native builder gives.
        """
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        weight = np.asarray(weight, np.float32)
        if assume_sorted:
            combine_duplicates = False
        if combine_duplicates and senders.size:
            key = senders * n_dst + receivers
            uniq, inv = np.unique(key, return_inverse=True)
            w = np.zeros(uniq.shape[0], np.float32)
            np.add.at(w, inv, weight)
            senders, receivers, weight = uniq // n_dst, uniq % n_dst, w
        if not assume_sorted:
            order = np.lexsort((receivers, senders))
            senders, receivers, weight = (
                senders[order], receivers[order], weight[order]
            )

        e = senders.shape[0]
        e_pad = max(_round_up(max(e, 1), pad_to_multiple), pad_to_multiple)
        s = np.full(e_pad, n_src, np.int32)
        r = np.full(e_pad, n_dst, np.int32)
        w = np.zeros(e_pad, np.float32)
        s[:e], r[:e], w[:e] = senders, receivers, weight

        row_ptr = np.zeros(n_src + 1, np.int64)
        if e:
            row_ptr[1:] = np.bincount(senders, minlength=n_src)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)

        return BipartiteGraph(
            senders=torch.from_numpy(s),
            receivers=torch.from_numpy(r),
            weight=torch.from_numpy(w),
            row_ptr=torch.from_numpy(row_ptr),
            n_src=int(n_src),
            n_dst=int(n_dst),
            num_edges=int(e),
        )

    @staticmethod
    def from_dense(dense, *, pad_to_multiple: int = 128) -> "BipartiteGraph":
        dense = np.asarray(dense)
        s, r = np.nonzero(dense)
        return BipartiteGraph.from_coo(
            s, r, dense[s, r], n_src=dense.shape[0], n_dst=dense.shape[1],
            pad_to_multiple=pad_to_multiple, combine_duplicates=False,
        )

    def transpose(self, *, pad_to_multiple: int = 128) -> "BipartiteGraph":
        """CSC view: the same edges sorted by receiver (host rebuild)."""
        e = self.num_edges
        s = self.senders[:e].cpu().numpy()
        r = self.receivers[:e].cpu().numpy()
        w = self.weight[:e].cpu().numpy()
        return BipartiteGraph.from_coo(
            r, s, w, n_src=self.n_dst, n_dst=self.n_src,
            pad_to_multiple=pad_to_multiple, combine_duplicates=False,
        ).to(self.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Grouping:
    """Implicit union-of-cliques adjacency: nodes i, j are adjacent iff
    ``group_id[i] == group_id[j]`` (i == j included)."""

    group_id: torch.Tensor  # [N] int32 in [0, num_groups)
    counts: torch.Tensor    # [num_groups] int32 clique sizes
    num_groups: int

    @property
    def num_nodes(self) -> int:
        return int(self.group_id.shape[0])

    @staticmethod
    def from_ids(group_id) -> "Grouping":
        gid = np.asarray(group_id, np.int32)
        num_groups = int(gid.max()) + 1 if gid.size else 0
        counts = np.bincount(gid, minlength=num_groups).astype(np.int32)
        return Grouping(torch.from_numpy(gid), torch.from_numpy(counts),
                        num_groups)

    def to(self, device) -> "Grouping":
        return dataclasses.replace(self, group_id=self.group_id.to(device),
                                   counts=self.counts.to(device))

    def to_dense(self) -> torch.Tensor:
        """Dense 0/1 clique adjacency (tests only — O(N^2))."""
        gid = self.group_id
        return (gid[:, None] == gid[None, :]).to(torch.float32)

    def member_sizes(self) -> torch.Tensor:
        """[N] clique size of each node's group."""
        return self.counts[self.group_id.long()]


@dataclasses.dataclass(frozen=True, eq=False)
class PairGrouping:
    """Joint index over the unique ``(group_a, group_b)`` pairs of two
    groupings over the same nodes.

    MSHA's intra aggregation broadcasts a per-city table and a
    per-province table back to all N nodes (``C[city_id] + P[prov_id]``);
    summed in pair space first (K unique pairs), the two become one N-row
    gather.  Exact for any two groupings: K is the number of combinations
    that occur.
    """

    pair_id: torch.Tensor    # [N] int32 in [0, num_pairs)
    a_of_pair: torch.Tensor  # [K] int32: first grouping's id of each pair
    b_of_pair: torch.Tensor  # [K] int32: second grouping's id of each pair
    num_pairs: int

    @staticmethod
    def build(a: Grouping, b: Grouping) -> "PairGrouping":
        """The pairs of ``a`` and ``b`` in ascending ``(a, b)`` order, on
        the CPU."""
        nb = max(int(b.num_groups), 1)
        key = (a.group_id.cpu().numpy().astype(np.int64) * nb
               + b.group_id.cpu().numpy().astype(np.int64))
        uniq, pair_id = np.unique(key, return_inverse=True)
        return PairGrouping(
            pair_id=torch.from_numpy(pair_id.reshape(-1).astype(np.int32)),
            a_of_pair=torch.from_numpy((uniq // nb).astype(np.int32)),
            b_of_pair=torch.from_numpy((uniq % nb).astype(np.int32)),
            num_pairs=int(uniq.shape[0]),
        )

    def to(self, device) -> "PairGrouping":
        return dataclasses.replace(self, pair_id=self.pair_id.to(device),
                                   a_of_pair=self.a_of_pair.to(device),
                                   b_of_pair=self.b_of_pair.to(device))


@dataclasses.dataclass(frozen=True, eq=False)
class FlowGraph:
    """The flow dataset: the N -> M flow-count graph ``inter``, the
    same-city / same-province groupings, the [N] GDP feature and one
    (source, recipient) entry per flow record."""

    inter: BipartiteGraph
    city: Grouping
    province: Grouping
    gdp: torch.Tensor       # [N] float32
    edge_src: torch.Tensor  # [num_records] int32
    edge_dst: torch.Tensor  # [num_records] int32

    @property
    def n_src(self) -> int:
        return self.inter.n_src

    @property
    def n_dst(self) -> int:
        return self.inter.n_dst

    @property
    def num_records(self) -> int:
        return int(self.edge_src.shape[0])


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def dst_degrees(graph: BipartiteGraph) -> torch.Tensor:
    """[n_dst] column sums of the weight matrix."""
    return segment_sum(graph.weight, graph.receivers, graph.n_dst)


def src_degrees(graph: BipartiteGraph) -> torch.Tensor:
    """[n_src] row sums of the weight matrix."""
    return segment_sum(graph.weight, graph.senders, graph.n_src)


def _inv_padded(deg: torch.Tensor) -> torch.Tensor:
    """1/deg with 0 for empty rows, plus one trailing 0 that pad ids hit."""
    inv = torch.where(deg > 0, 1.0 / torch.where(deg > 0, deg, 1.0), 0.0)
    return torch.cat([inv, inv.new_zeros(1)])


def normalize_by_dst_degree(graph: BipartiteGraph) -> BipartiteGraph:
    """Column normalisation ``A @ D^-1`` (the reference's
    ``normalize_adjacency_matrix``).  Zero-degree columns keep weight 0."""
    inv = _inv_padded(dst_degrees(graph))
    return graph.with_weight(graph.weight * inv[graph.receivers.long()])


def normalize_rows(graph: BipartiteGraph) -> BipartiteGraph:
    """Row normalisation ``D^-1 @ A``."""
    inv = _inv_padded(src_degrees(graph))
    return graph.with_weight(graph.weight * inv[graph.senders.long()])


def from_scipy(sparse_mx, *, pad_to_multiple: int = 128) -> BipartiteGraph:
    """A scipy.sparse matrix -> :class:`BipartiteGraph` (duplicate entries
    summed), as ``msha_gnn_tpu/graph.py::from_scipy`` builds it."""
    coo = sparse_mx.tocoo()
    return BipartiteGraph.from_coo(
        coo.row, coo.col, coo.data.astype(np.float32),
        n_src=coo.shape[0], n_dst=coo.shape[1],
        pad_to_multiple=pad_to_multiple, combine_duplicates=True)
