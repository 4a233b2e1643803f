"""Sharded training steps over a mesh (``msha_gnn_tpu/parallel/sharded.py``).

The JAX package jits the single-device steps with declared shardings and
lets XLA insert the collectives.  Here each step runs the model's own
forward on the ranks of a mesh, given a :class:`MeshShard` (the
collectives of :mod:`.comm` behind the model's
:class:`~msha_gnn_torch.models.common.Shard` hooks), and equals the
single-device step on the whole batch: every rank gets the single-device
gradients of the replicated parameters, so Adam keeps them equal, and its
own rows of the node-sharded ones.

* :func:`make_sharded_msha_step`: ``Sfeatures`` is row-sharded (the rows
  ``[lo, hi)`` of :meth:`~.mesh.Mesh.block`), and with it every
  ``[N, ...]`` quantity of the MSHA layer: the projections, the inter
  attention rows and their aggregation.  What couples the rows is formed
  over all of them by collectives: ``att.T @ h2`` and ``bn2``'s
  statistics by all-reduces, the minibatch's rows (the intra channels'
  ``h2`` and attention rows, and the scored rows) by
  :func:`~.comm.take_global_rows`.  The intra channels and the scoring of
  the B batch rows then run replicated.
* :func:`make_sharded_linkpred_step`: the node ``features`` are
  row-sharded and all-gathered for the encoder, which runs replicated over
  the whole graph (the CSR replicated, as in the JAX layout; on CUDA its
  kernels); the edge minibatch is split over the ranks for the predictor
  and the loss, whose partial sums are all-reduced.

In both, each dropout mask of a sharded tensor is drawn for the whole
tensor and each rank takes its rows, so the masks are the single-device
step's for one generator seeded alike on every rank.
:func:`state_shardings` gives each parameter's :class:`~.mesh.Placement`:
the node-row tables the model names in ``node_rows`` (``MSHA.Sfeatures``,
``LinkPredModel.features``) rows over the ranks, every other parameter
and buffer replicated, whatever its shape.  JAX places by shape (any leaf
whose leading dim is ``n_nodes``), but there a placement is only a layout
and XLA computes on the whole value; here a row placement cuts the value
to the rank's rows, which is right only for the tensors the model's
:class:`~msha_gnn_torch.models.common.Shard` hooks treat as local rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..graph import PairGrouping
from ..models.common import Shard
from ..training.trainer import TrainState
from .comm import (copy_to_local, gather_rows, reduce_from_local,
                   scatter_rows, take_global_rows)
from .mesh import Mesh, Placement, data_sharded, replicated


def state_shardings(state: Union[TrainState, nn.Module], mesh: Mesh,
                    n_nodes: int) -> Dict[str, Placement]:
    """``{name: Placement}`` of the model's parameters and buffers (an
    optimiser moment follows its parameter): the tables named in the
    model's ``node_rows`` rows over the ranks, every other one
    replicated."""
    model = state.model if isinstance(state, TrainState) else state
    rows = set(getattr(model, "node_rows", ()))
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    for name in rows:
        if name not in named or named[name].shape[0] != n_nodes:
            raise ValueError(f"node-row table {name!r} is not "
                             f"[{n_nodes}, ...]")
    return {name: (data_sharded(mesh, t.dim()) if name in rows
                   else replicated(mesh)) for name, t in named.items()}


def _shard_parameters(model: nn.Module, placements: Dict[str, Placement]
                      ) -> None:
    """Replace each row-sharded parameter by its local rows."""
    for name, place in placements.items():
        if not place.rows:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        full = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(place.local(full.detach()).clone()))


class MeshShard(Shard):
    """The :class:`~msha_gnn_torch.models.common.Shard` of a mesh: this
    rank holds the rows ``[lo, hi)`` of :meth:`~.mesh.Mesh.block` of every
    ``[n, ...]`` tensor, and the collectives are those of :mod:`.comm`.
    A dropout mask is drawn for the whole tensor and cut to the rows, so
    the masks are the single-device ones for a generator seeded alike on
    every rank."""

    def __init__(self, mesh: Mesh, n: int):
        self.mesh, self.n = mesh, n
        self.lo, self.hi, _ = mesh.block(n)

    def local(self, t):
        return copy_to_local(t, self.mesh)

    def reduce(self, t):
        return reduce_from_local(t, self.mesh)

    def scatter(self, t):
        return scatter_rows(t, self.mesh, pad=False)

    def take(self, x, rows):
        return take_global_rows(x, rows, self.n, self.mesh)

    def dropout(self, x, rate, training, generator):
        if not training or rate <= 0.0:
            return x
        keep = torch.rand((self.n, *x.shape[1:]), generator=generator,
                          device=x.device) >= rate
        return torch.where(keep[self.lo:self.hi], x / (1.0 - rate), 0.0)

    def moments(self, x):
        mean = self.reduce(x.sum(0)) / self.n
        var = self.reduce((x - self.local(mean)).square().sum(0)) / self.n
        return mean, var


def make_sharded_msha_step(fg, mesh: Mesh, **model_kwargs):
    """``(step, state, placements)`` for the MSHA train step on ``mesh``:
    the model of ``msha_task(fg, **model_kwargs)`` on the mesh's device,
    its ``Sfeatures`` cut to this rank's rows.  ``step(state, batch_idx,
    labels, weights, generator)`` is one optimiser step on the whole
    batch (every rank passes the same batch and a generator seeded alike)
    and returns the replicated loss on the device."""
    from ..training.tasks import flow_inputs, msha_task

    dev = mesh.device
    task, model = msha_task(fg, device=dev, **model_kwargs)
    n = fg.n_src
    placements = state_shardings(model, mesh, n)
    _shard_parameters(model, placements)
    _, inter_mask = flow_inputs(fg, dev)
    city, prov = fg.city.to(dev), fg.province.to(dev)
    pair = (PairGrouping.build(fg.city, fg.province).to(dev)
            if model.attention.use_intra else None)
    state = TrainState.create(model, task.optimizer)
    shard = MeshShard(mesh, n)

    def step(state: TrainState, batch_idx, labels, weights,
             generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        batch = torch.as_tensor(batch_idx, device=dev).long()
        scores = state.model(inter_mask, city, prov, batch, train=True,
                             rows=batch, pair=pair, generator=generator,
                             shard=shard)
        loss = task.loss_fn(scores, torch.as_tensor(labels, device=dev),
                            torch.as_tensor(weights, device=dev))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step, state, placements


def _bce_sum(scores: torch.Tensor, target: float,
             eps: float = 1e-7) -> torch.Tensor:
    """The sum of :func:`~msha_gnn_torch.training.losses.bce_loss`'s terms."""
    s = scores.clamp(eps, 1.0 - eps)
    return -(target * torch.log(s) + (1.0 - target) * torch.log(1.0 - s)
             ).sum()


def sharded_linkpred_loss(model, graph, batch, mesh: Mesh, *, impl: str,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """``linkpred_loss``'s label loss (``0.5 (BCE(pos) + BCE(neg))``) with
    ``model.features`` this rank's rows and the batch ``(pos_s, pos_r,
    neg_s, neg_r)`` (whole, on every rank) split over the ranks: each side
    in blocks of its own length and averaged over it, its dropout masks
    drawn for the whole side (positives, then negatives)."""
    pos_s, pos_r, neg_s, neg_r = (t.long() for t in batch)
    n = graph.n_src
    feats = gather_rows(model.features, n, mesh)
    h = copy_to_local(model.encoder(graph, feats, train=True, impl=impl,
                                    generator=generator), mesh)
    part = h.new_zeros(())
    for s_idx, r_idx, target in ((pos_s, pos_r, 1.0), (neg_s, neg_r, 0.0)):
        shard = MeshShard(mesh, s_idx.shape[0])
        lo, hi = shard.lo, shard.hi
        scores = model.predictor(h[s_idx[lo:hi]], h[r_idx[lo:hi]],
                                 train=True, generator=generator, shard=shard)
        part = part + _bce_sum(scores, target) / shard.n
    return reduce_from_local(0.5 * part, mesh)


def make_sharded_linkpred_step(split, mesh: Mesh, *, hidden: int = 16,
                               n_heads: int = 2, num_layers: int = 2,
                               dropout: float = 0.0, lr: float = 5e-3,
                               seed: int = 0, impl: str = "auto"):
    """The sharded SparseGAT + LinkPredictor step -> ``(step, (model,
    optimizer, graph), placements)``: a ``LinkPredModel`` of a generator
    seeded ``seed`` on the mesh's device, its ``features`` cut to this
    rank's rows, Adam at ``lr``.  ``step(model, optimizer, graph, pos_s,
    pos_r, neg_s, neg_r, generator=None)`` is one optimiser step on the
    whole batch and returns the replicated loss on the device.  ``impl``
    is the encoder's (``auto``: the fused kernels on CUDA, the plain path
    on the CPU)."""
    from ..models.gat import resolve_impl
    from ..training.link_prediction import LinkPredConfig, LinkPredModel
    from ..training.optim import adam_l2

    dev = mesh.device
    n = split["n"]
    cfg = LinkPredConfig(hidden=hidden, n_heads=n_heads,
                         num_layers=num_layers, dropout=dropout, lr=lr,
                         seed=seed)
    model = LinkPredModel(n, cfg, generator=torch.Generator()
                          .manual_seed(seed)).to(dev)
    placements = state_shardings(model, mesh, n)
    _shard_parameters(model, placements)
    optimizer = adam_l2(model.parameters(), lr)
    graph = split["graph"].to(dev)
    impl = resolve_impl(impl, dev)

    def step(model, optimizer, graph, pos_s, pos_r, neg_s, neg_r,
             generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        batch = [torch.as_tensor(t, device=dev)
                 for t in (pos_s, pos_r, neg_s, neg_r)]
        loss = sharded_linkpred_loss(model, graph, batch, mesh, impl=impl,
                                     generator=generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, (model, optimizer, graph), placements


def run_one_sharded_step(fg, mesh: Mesh, batch_size: int = 16,
                         seed: int = 0, **model_kwargs):
    """One sharded MSHA train step on a batch of ``batch_size`` records
    drawn from ``np.random.default_rng(seed)`` -> ``(state, loss)``."""
    step, state, _ = make_sharded_msha_step(fg, mesh, **model_kwargs)
    rng = np.random.default_rng(seed)
    src = fg.edge_src.cpu().numpy()
    dst = fg.edge_dst.cpu().numpy()
    ids = rng.integers(0, len(src), batch_size)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = step(state, torch.as_tensor(src[ids], device=dev),
                torch.as_tensor(dst[ids], device=dev),
                torch.ones(batch_size, device=dev), gen)
    return state, float(loss)
