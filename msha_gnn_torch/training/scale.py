"""Out-of-core and edge-partitioned large-graph training
(``msha_gnn_tpu/training/scale.py``, BASELINE config #5).

The model: learnable node features -> a projection -> rank-1 GAT
attention over each sender's edges -> the attention-weighted aggregation
-> ``elu(agg) + h`` -> Hadamard edge scores -> BCE on one batch of
positive and random negative edges, Adam.

:func:`train_chunked` runs it over host COO edges:

* ``fused=True``: the whole attention layer is one
  :class:`~msha_gnn_torch.ops.chunked_rank1.ChunkedRank1Gat` (a fused
  ``r1l_fwd`` / ``r1l_bwd`` a balanced edge slice, the cross-slice
  online-softmax merge), so no ``[E]`` logits or attention exist;
* ``fused=False``: the materialised pipeline, the sender term of the
  logits by ``SegmentSoftmaxOperator.broadcast_rows`` (``seg_expand_f32``,
  its adjoint ``seg_reduce_f32``), the receiver term by a gather, the row
  softmax (``seg_softmax_fwd_f32`` / ``seg_softmax_bwd_f32``) and the
  aggregation through :class:`~msha_gnn_torch.ops.chunked.ChunkedSpmm`
  (``csr_spmm_f32`` a slice; ``dx`` the transposed slices, ``dw``
  ``csr_sddmm_f32`` a slice).

* :func:`train_distributed` runs the same model over the ranks of a
  mesh (:mod:`msha_gnn_torch.parallel`), the edges partitioned by source
  row: ``fused=True`` through
  :class:`~msha_gnn_torch.parallel.rank1_dist.ShardedRank1Gat` (a rank's
  ``r1l_fwd_f32`` / ``r1l_bwd_f32``), ``fused=False`` the materialised
  encoding (the logits by gathers, the plain segment softmax) over
  :class:`~msha_gnn_torch.parallel.dist_spmm.DistributedSpmm`.  The
  parameters are replicated; the aggregation's input and output rows are
  each rank's block.

The JAX package's ``hoist`` (lifting the closure's constants into the
compiled step) is JAX-only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.segment import segment_softmax


@dataclasses.dataclass
class ScaleConfig:
    d: int = 32                # feature/embedding width
    lr: float = 1e-3
    steps: int = 20
    batch_edges: int = 8192    # positive edges scored per step
    seed: int = 0
    negative_slope: float = 0.2
    precision: str = "f32"     # 'bf16': the aggregation's rows in bfloat16
                               # (parameters and Adam stay float32)


def _init_params(generator: torch.Generator, n_nodes: int,
                 d: int) -> Dict[str, torch.Tensor]:
    """The JAX initial distributions, drawn from ``generator`` on its
    device: ``feat`` uniform [0, 1), ``W`` and ``a`` uniform in ``(-g,
    g)`` with ``g = 1.414 sqrt(6 / 2d)``."""
    g = 1.414 * (6.0 / (2 * d)) ** 0.5
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) \
            * (hi - lo) + lo

    return {"feat": uniform((n_nodes, d), 0.0, 1.0),
            "W": uniform((d, d), -g, g),
            "a": uniform((2 * d,), -g, g)}


def _encode(params, senders, receivers, n_nodes: int, aggregate, cfg,
            softmax=None, logits_fn=None, attention_fn=None):
    """The encoder: rank-1 GAT attention and a pluggable aggregation.

    ``aggregate(h, att)`` is the weighted SpMM (chunked); ``softmax`` a
    sorted-segment softmax operator (its ``broadcast_rows`` gives the
    sender term of the logits), else the plain ``segment_softmax`` over
    ``senders``; ``logits_fn(s_src, s_dst) -> [E]`` replaces the two
    gathers of the logits; ``attention_fn(c, a_dst, h) -> [N, d]`` is the
    fused layer (logits, softmax and aggregation in one operator, which
    streams its own payload) and supersedes the other hooks."""
    h = params["feat"] @ params["W"]                     # [N, d]
    d = cfg.d
    s_src = h @ params["a"][:d]                          # [N]
    if attention_fn is not None:
        agg = attention_fn(s_src, params["a"][d:], h).float()
        return F.elu(agg) + h
    s_dst = h @ params["a"][d:]
    if logits_fn is not None:
        logits = logits_fn(s_src, s_dst)                 # [E]
    else:
        src_term = (softmax.broadcast_rows(s_src) if softmax is not None
                    else s_src.index_select(0, senders))
        logits = F.leaky_relu(src_term + s_dst.index_select(0, receivers),
                              cfg.negative_slope)        # [E]
    if softmax is not None:
        att = softmax(logits)
    else:
        att = segment_softmax(logits, senders, n_nodes)
    h_agg = h.to(torch.bfloat16) if cfg.precision == "bf16" else h
    agg = aggregate(h_agg, att).float()
    return F.elu(agg) + h                                # residual


def _make_loss(senders, receivers, n_nodes: int, aggregate, cfg,
               softmax=None, logits_fn=None, attention_fn=None):
    """``loss_fn(params, pos_s, pos_r, neg_s, neg_r)``: BCE on the link
    scores ``<z[s], z[r]>`` of the positive and the negative pairs."""
    def loss_fn(params, pos_s, pos_r, neg_s, neg_r):
        z = _encode(params, senders, receivers, n_nodes, aggregate, cfg,
                    softmax=softmax, logits_fn=logits_fn,
                    attention_fn=attention_fn)
        pos = (z[pos_s] * z[pos_r]).sum(1)
        neg = (z[neg_s] * z[neg_r]).sum(1)
        return (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
                + F.binary_cross_entropy_with_logits(
                    neg, torch.zeros_like(neg)))

    return loss_fn


def draw_batch(rng: np.random.Generator, senders_np, receivers_np,
               n_nodes: int, batch_edges: int, device):
    """One step's ``(pos_s, pos_r, neg_s, neg_r)`` as the JAX ``_train`` draws
    them from ``rng`` (``scale.py:182-193``), int64 on ``device``."""
    ids = rng.integers(0, len(senders_np), batch_edges)
    neg_s = rng.integers(0, n_nodes, batch_edges, dtype=np.int64)
    neg_r = rng.integers(0, n_nodes, batch_edges, dtype=np.int64)
    return tuple(torch.from_numpy(np.asarray(v, np.int64)).to(device)
                 for v in (senders_np[ids], receivers_np[ids], neg_s, neg_r))


def _train(loss_fn, params, senders_np, receivers_np, n_nodes: int, cfg,
           log: Optional[Callable] = None) -> Dict:
    """``cfg.steps`` Adam steps (``optax.adam(cfg.lr)``'s defaults) of
    ``loss_fn`` from ``params`` (copied), one batch a step from
    ``np.random.default_rng(cfg.seed)``.  ``log`` gets ``{"step", "loss",
    "seconds"}`` a step, the seconds of the step through its loss on the
    host."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    dev = params["feat"].device
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    e = len(senders_np)
    rng = np.random.default_rng(cfg.seed)
    history: List[float] = []
    t_steps = []
    for i in range(cfg.steps):
        batch = draw_batch(rng, senders_np, receivers_np, n_nodes,
                           cfg.batch_edges, dev)
        t0 = time.perf_counter()
        loss = loss_fn(params, *batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        t_steps.append(time.perf_counter() - t0)
        history.append(loss)
        if log:
            log({"step": i, "loss": loss, "seconds": t_steps[-1]})
    steady = t_steps[2:] or t_steps
    return {
        "loss_history": history,
        "first_loss": history[0],
        "final_loss": history[-1],
        "loss_decreased": history[-1] < history[0],
        "step_seconds": float(np.mean(steady)),
        "edges_per_s": e / float(np.mean(steady)),
        "edges": e,
    }


def num_slices_for(num_edges: int, d: int) -> int:
    """Slices that bound a slice's ``[E_slice, d]`` float32 rows to about
    512 MiB (``scale.py:233-235``)."""
    return max(1, int(np.ceil(num_edges * d * 4 / (512 * 2**20))))


def build_chunked(senders, receivers, n_nodes: int, cfg: ScaleConfig, *,
                  num_slices: Optional[int] = None, fused: bool = True,
                  log: Optional[Callable] = None, device="cuda"):
    """The operators and loss of :func:`train_chunked` -> ``(loss_fn,
    senders, receivers, num_slices)``, the edges sorted by sender
    (stable) on the host."""
    dev = resolve_device(device)
    s = np.ascontiguousarray(senders, np.int32)
    r = np.ascontiguousarray(receivers, np.int32)
    order = np.argsort(s, kind="stable")
    s, r = s[order], r[order]
    if num_slices is None:
        num_slices = num_slices_for(len(s), cfg.d)
    t0 = time.perf_counter()
    if fused:
        from ..ops.chunked_rank1 import ChunkedRank1Gat

        r1 = ChunkedRank1Gat(s, r, n_src=n_nodes, n_dst=n_nodes,
                             num_slices=num_slices,
                             negative_slope=cfg.negative_slope,
                             assume_sorted=True, precision=cfg.precision,
                             device=dev)
        loss_fn = _make_loss(None, None, n_nodes, None, cfg,
                             attention_fn=lambda c, a_dst, h: r1(c, a_dst, h))
    else:
        from ..ops.chunked import ChunkedSpmm
        from ..ops.cuda.softmax import SegmentSoftmaxOperator

        op = ChunkedSpmm.from_host_coo(s, r, None, n_src=n_nodes,
                                       n_dst=n_nodes, num_slices=num_slices,
                                       assume_sorted=True, device=dev)
        row_ptr = np.zeros(n_nodes + 1, np.int64)
        row_ptr[1:] = np.cumsum(np.bincount(s, minlength=n_nodes))
        softmax_op = SegmentSoftmaxOperator(s, row_ptr, n_nodes, device=dev)
        senders_dev = torch.from_numpy(s).to(dev)
        receivers_dev = torch.from_numpy(r).to(dev)
        loss_fn = _make_loss(senders_dev, receivers_dev, n_nodes, op.apply,
                             cfg, softmax=softmax_op)
    if log:
        log({"event": "layout", "num_slices": num_slices,
             "seconds": round(time.perf_counter() - t0, 1)})
    return loss_fn, s, r, num_slices


def train_chunked(senders, receivers, n_nodes: int,
                  cfg: ScaleConfig = ScaleConfig(), *,
                  num_slices: Optional[int] = None, fused: bool = True,
                  log: Optional[Callable] = None, device="cuda") -> Dict:
    """Out-of-core training on one card over host COO edges (sorted by
    sender here; only the slices' arrays reach the device), from
    :func:`_init_params` of a CPU generator seeded ``cfg.seed``.
    ``num_slices`` defaults to :func:`num_slices_for`."""
    loss_fn, s, r, num_slices = build_chunked(
        senders, receivers, n_nodes, cfg, num_slices=num_slices,
        fused=fused, log=log, device=device)
    params = _init_params(torch.Generator().manual_seed(cfg.seed), n_nodes,
                          cfg.d)
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    out = _train(loss_fn, params, s, r, n_nodes, cfg, log)
    out["num_slices"] = num_slices
    out["topology"] = "single-chip out-of-core"
    out["attention"] = "fused-rank1-chunked" if fused else "materialized"
    return out


def sort_edges(senders, receivers, n_nodes: int):
    """``(senders, receivers)`` as int32 in (sender, receiver) order: one
    stable sort of the key ``s * n_nodes + r``, the permutation of
    ``np.lexsort((r, s))`` (``msha_gnn_tpu/graph.py:122-125``)."""
    s = np.ascontiguousarray(senders, np.int32)
    r = np.ascontiguousarray(receivers, np.int32)
    order = np.argsort(s.astype(np.int64) * n_nodes + r, kind="stable")
    return s[order], r[order]


def build_distributed(senders, receivers, n_nodes: int, mesh,
                      cfg: ScaleConfig, *, fused: bool = True):
    """The operators and loss of :func:`train_distributed` -> ``(loss_fn,
    senders, receivers, op)``, ``op`` the sharded attention operator
    (``ShardedRank1Gat``) or aggregation (``DistributedSpmm``), the edges
    in the (sender, receiver) order of the JAX function's graph
    (:func:`sort_edges`), from which both draw their batches.
    :func:`build_chunked` sorts by sender only, stably, as its JAX source
    does, so the two drivers draw the same batches from one seed only on
    edges already in (sender, receiver) order."""
    from ..graph import BipartiteGraph
    from ..parallel.comm import gather_rows, scatter_rows

    s, r = sort_edges(senders, receivers, n_nodes)
    g = BipartiteGraph.from_coo(s, r, np.ones(len(s), np.float32),
                                n_src=n_nodes, n_dst=n_nodes,
                                assume_sorted=True)
    d = cfg.d
    if fused:
        from ..parallel.rank1_dist import ShardedRank1Gat

        op = ShardedRank1Gat(g, mesh, negative_slope=cfg.negative_slope)

        def aggregate(h, s_src, params):
            return op(scatter_rows(s_src, mesh), params["a"][d:],
                      scatter_rows(h, mesh))
    else:
        from ..parallel.dist_spmm import DistributedSpmm

        op = DistributedSpmm(g, mesh)
        gd = g.to(mesh.device)
        senders_dev = gd.senders.long().clamp_max(n_nodes - 1)
        receivers_dev = gd.receivers.long().clamp_max(n_nodes - 1)
        mask = gd.edge_mask

        def aggregate(h, s_src, params):
            s_dst = h @ params["a"][d:]
            logits = F.leaky_relu(s_src.index_select(0, senders_dev)
                                  + s_dst.index_select(0, receivers_dev),
                                  cfg.negative_slope)
            att = segment_softmax(logits, gd.senders, n_nodes, mask=mask)
            return op(scatter_rows(h, mesh), edge_weight=att)

    def loss_fn(params, pos_s, pos_r, neg_s, neg_r):
        h = params["feat"] @ params["W"]
        s_src = h @ params["a"][:d]
        agg = gather_rows(aggregate(h, s_src, params), n_nodes, mesh)
        z = F.elu(agg) + h
        pos = (z[pos_s] * z[pos_r]).sum(1)
        neg = (z[neg_s] * z[neg_r]).sum(1)
        return (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
                + F.binary_cross_entropy_with_logits(
                    neg, torch.zeros_like(neg)))

    return loss_fn, s, r, op


def train_distributed(senders, receivers, n_nodes: int, mesh,
                      cfg: ScaleConfig = ScaleConfig(), *,
                      fused: bool = True,
                      log: Optional[Callable] = None) -> Dict:
    """Edge-partitioned training over the ranks of ``mesh`` (every rank
    calls it with the same edges), on the mesh's device, from
    :func:`_init_params` of a CPU generator seeded ``cfg.seed``; every
    rank draws the same batches.  ``fused=True``: the attention layer is
    ``ShardedRank1Gat``; ``fused=False``: the materialised encoding over
    ``DistributedSpmm``."""
    loss_fn, s, r, _ = build_distributed(senders, receivers, n_nodes,
                                         mesh, cfg, fused=fused)
    params = _init_params(torch.Generator().manual_seed(cfg.seed), n_nodes,
                          cfg.d)
    params = {k: v.to(mesh.device) for k, v in params.items()}
    out = _train(loss_fn, params, s, r, n_nodes, cfg, log)
    out["topology"] = f"edge-partitioned x{mesh.world}"
    out["attention"] = "fused-rank1-sharded" if fused else "materialized"
    return out
