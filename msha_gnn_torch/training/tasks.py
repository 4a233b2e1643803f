"""Task builders: bind a model family to its static graph inputs
(``msha_gnn_tpu/training/tasks.py``).

Each builder returns ``(task, model)``: the port's model is an
``nn.Module`` that holds its own parameters, where the JAX builders return
``(task, variables, model)``.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..graph import FlowGraph, normalize_by_dst_degree
from ..models import GCN
from .trainer import Task


def flow_inputs(fg: FlowGraph, device="cuda"):
    """Static inputs shared by the flow models, on ``device``: the
    column-normalised graph and the dense [N, M] edge mask."""
    inter = fg.inter.to(resolve_device(device))
    return normalize_by_dst_degree(inter), inter.to_dense() > 0


def gcn_task(
    fg: FlowGraph,
    *,
    nfeat: int = 64,
    dropout: float = 0.5,
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

    def forward(model, batch_idx, *, train):
        return model(g_norm, train=train, impl=impl, rows=batch_idx), {}

    def full_scores(model):
        with torch.inference_mode():
            return model(g_norm, train=False, impl=impl)

    return Task(forward=forward, full_scores=full_scores, graph=g_norm), model
