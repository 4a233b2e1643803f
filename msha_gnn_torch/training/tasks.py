"""Task builders: bind a model family to its static graph inputs
(``msha_gnn_tpu/training/tasks.py``).

Each builder returns ``(task, model)``: the port's model is an
``nn.Module`` that holds its own parameters, where the JAX builders return
``(task, variables, model)``.  The task's optimiser is Adam with coupled
L2 at ``lr`` and ``weight_decay`` (the reference's ``train.py:207``: 1e-3,
5e-4), as a factory of the model's parameters.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import resolve_device
from ..graph import FlowGraph, PairGrouping, normalize_by_dst_degree
from ..models import GAT, GCN, MSHA, GraphSAGE, HGANELayer
from .optim import adam_l2
from .trainer import Task


def _adam(lr: float, weight_decay: float):
    return functools.partial(adam_l2, lr=lr, weight_decay=weight_decay)


def flow_inputs(fg: FlowGraph, device="cuda"):
    """Static inputs shared by the flow models, on ``device``: the
    column-normalised graph and the dense [N, M] edge mask."""
    inter = fg.inter.to(resolve_device(device))
    return normalize_by_dst_degree(inter), inter.to_dense() > 0


def _batch(batch_idx, dev) -> torch.Tensor:
    return torch.as_tensor(batch_idx, device=dev).long()


def msha_task(
    fg: FlowGraph,
    *,
    in_features: int = 128,
    out_features: int = 64,
    n_heads: int = 2,
    dropout: float = 0.5,
    use_intra: bool = True,
    joint_softmax: bool = True,
    use_out_att: bool = True,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    seed: int = 42,
    device="cuda",
):
    """MSHA and its ablations on the flow graph.

    ``forward(model, batch_idx, *, train, generator=None)`` scores the
    rows ``batch_idx`` (its intra channels attend within that batch; both
    norms take their statistics over all N rows).  ``full_scores`` is set
    only without the intra channels (ablation3): with them the eval
    scores depend on the batch.  In training the norms update their
    running statistics in place, so ``mutated`` is {}.
    """
    dev = resolve_device(device)
    _, inter_mask = flow_inputs(fg, dev)
    city, prov = fg.city.to(dev), fg.province.to(dev)
    pair = PairGrouping.build(fg.city, fg.province).to(dev) \
        if use_intra else None
    gen = torch.Generator().manual_seed(seed)
    model = MSHA(in_features, out_features, fg.n_dst, n_heads, dropout,
                 use_intra=use_intra, joint_softmax=joint_softmax,
                 use_out_att=use_out_att, gdp=fg.gdp, generator=gen).to(dev)

    def forward(model, batch_idx, *, train,
                generator: Optional[torch.Generator] = None):
        batch = _batch(batch_idx, dev)
        return model(inter_mask, city, prov, batch, train=train, rows=batch,
                     pair=pair, generator=generator), {}

    full_scores = None
    if not use_intra:
        def full_scores(model):
            with torch.inference_mode():
                return model(inter_mask, city, prov,
                             torch.zeros(1, dtype=torch.long, device=dev),
                             train=False)

    return Task(forward=forward, optimizer=_adam(lr, weight_decay),
                full_scores=full_scores), model


def gcn_task(
    fg: FlowGraph,
    *,
    nfeat: int = 64,
    dropout: float = 0.5,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    seed: int = 42,
    impl: str = "auto",
    device="cuda",
):
    """GCN preset: nhid = n_classes so the round trip scores the M
    recipients.  ``impl="auto"`` is ``"cuda"`` (the CSR kernel) for a CUDA
    device and ``"torch"`` (the plain SpMM) for ``device="cpu"``."""
    dev = resolve_device(device)
    if impl == "auto":
        impl = "cuda" if dev.type == "cuda" else "torch"
    g_norm, _ = flow_inputs(fg, dev)
    if impl == "cuda":
        from ..ops.cuda.spmm import operator_for

        operator_for(g_norm)  # the CSR/CSC build is set-up, not a forward
    gen = torch.Generator().manual_seed(seed)
    model = GCN(nfeat, fg.n_dst, fg.n_dst, dropout, gdp=fg.gdp,
                generator=gen).to(dev)

    def forward(model, batch_idx, *, train,
                generator: Optional[torch.Generator] = None):
        return model(g_norm, train=train, impl=impl, rows=batch_idx,
                     generator=generator), {}

    def full_scores(model):
        with torch.inference_mode():
            return model(g_norm, train=False, impl=impl)

    return Task(forward=forward, optimizer=_adam(lr, weight_decay),
                full_scores=full_scores, graph=g_norm), model


def gat_task(
    fg: FlowGraph,
    *,
    n_features: Optional[int] = None,
    n_heads: int = 2,
    dropout: float = 0.5,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    seed: int = 42,
    device="cuda",
):
    """The reference's GAT on the flow graph: ``n_features`` defaults to
    the number of recipients M (the reference's output layer needs it).
    The model is row-local, so ``full_scores`` gives the [N, M] matrix in
    one forward."""
    dev = resolve_device(device)
    _, inter_mask = flow_inputs(fg, dev)
    gen = torch.Generator().manual_seed(seed)
    model = GAT(n_features or fg.n_dst, fg.n_dst, n_heads, dropout,
                gdp=fg.gdp, generator=gen).to(dev)

    def forward(model, batch_idx, *, train,
                generator: Optional[torch.Generator] = None):
        return model(inter_mask, train=train, rows=_batch(batch_idx, dev),
                     generator=generator), {}

    def full_scores(model):
        with torch.inference_mode():
            return model(inter_mask, train=False)

    return Task(forward=forward, optimizer=_adam(lr, weight_decay),
                full_scores=full_scores), model


def hgane_task(
    fg: FlowGraph,
    *,
    in_features: int = 128,
    out_features: int = 64,
    dropout: float = 0.5,
    intra: str = "city",
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    seed: int = 42,
    device="cuda",
):
    """HGANE, batch-sliced, its intra channel over ``intra`` (``"city"``
    or ``"province"``).  Its ELU scores get a log-softmax for the NLL
    loss, as every trained flow model feeds it.  The intra block makes the
    scores depend on the batch: no ``full_scores``.  In training the norms
    update their running statistics in place."""
    dev = resolve_device(device)
    _, inter_mask = flow_inputs(fg, dev)
    grouping = (fg.city if intra == "city" else fg.province).to(dev)
    gen = torch.Generator().manual_seed(seed)
    model = HGANELayer(in_features, out_features, fg.n_src, fg.n_dst,
                       dropout, generator=gen).to(dev)

    def forward(model, batch_idx, *, train,
                generator: Optional[torch.Generator] = None):
        batch = _batch(batch_idx, dev)
        scores = model(inter_mask[batch], grouping, batch, train=train,
                       generator=generator)
        return torch.log_softmax(scores, dim=-1), {}

    return Task(forward=forward, optimizer=_adam(lr, weight_decay)), model


def sage_task(
    fg: FlowGraph,
    *,
    in_features: int = 32,
    dropout: float = 0.5,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    seed: int = 42,
    device="cuda",
):
    """GraphSAGE with ``hidden == M`` (the gate is elementwise).  A batch's
    gate rows are its rows of the dense column-normalised adjacency, kept
    on the device ([N, M]).  The model has no dropout (``dropout`` is
    taken for the JAX signature) and no ``full_scores``."""
    dev = resolve_device(device)
    g_norm, _ = flow_inputs(fg, dev)
    dense_norm = g_norm.to_dense()
    gen = torch.Generator().manual_seed(seed)
    model = GraphSAGE(in_features, fg.n_dst, fg.n_dst, gdp=fg.gdp,
                      generator=gen).to(dev)

    def forward(model, batch_idx, *, train,
                generator: Optional[torch.Generator] = None):
        batch = _batch(batch_idx, dev)
        return model(batch, dense_norm[batch], train=train), {}

    return Task(forward=forward, optimizer=_adam(lr, weight_decay)), model
