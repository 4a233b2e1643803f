"""Link prediction at ogbl-ddi scale: a SparseGAT encoder and a
LinkPredictor trained with BCE on train-edge positives and uniform
negatives, evaluated by OGB Hits@K and AUC
(``msha_gnn_tpu/training/link_prediction.py``).

On CUDA ``impl="auto"`` resolves to ``"fused"``: every ``SparseGATLayer``
runs the hand-written rank-1 GAT kernels, attention dropout included.
``impl="materialised"`` runs the materialised attention pipeline (the
row-softmax, SpMM and SDDMM kernels), ``impl="flash"`` flash-GAT (the
fused softmax-aggregation kernels over the plain logits).  On the CPU
``"auto"`` resolves to ``"torch"``, the plain path.  Training is a plain
loop of steps (:func:`train_step`); the JAX package's ``lax.scan`` over an
epoch is a dispatch device of its own and has no counterpart here.  The
numpy draws (the epoch's subgraph, batch order, negatives) are the JAX
package's, so one seed gives both the same batches.  Evaluation encodes
the full graph once and scores every pair from that encoding.

``neighbor_fanout > 0`` trains each epoch on a subgraph of at most that
many edges a node (:func:`~msha_gnn_torch.data.sampler.
neighbor_sample_subgraph`), drawn on the host and run through the same
``impl``: on CUDA the kernels walk the subgraph's own CSR / CSC, built once
an epoch from the host arrays and dropped at the epoch's end.  (The JAX
run sends sampled epochs to its XLA path, whose Pallas layout is per-graph
host work; the function is the same.)  ``use_kd`` adds an MLP student over
the learnable features, distilled from the encoder: ``true_label * label
+ kd_f * kd_cosine + kd_p * mse``, the encoder's embedding and scores
detached.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.sampler import neighbor_sample_subgraph
from ..graph import BipartiteGraph
from ..models import MLP, LinkPredictor, SparseGAT
from ..models.gat import resolve_impl
from .losses import bce_loss, kd_loss
from .metrics import binary_auc, hits_at_k
from .optim import adam_l2


@dataclasses.dataclass
class LinkPredConfig:
    hidden: int = 64
    n_heads: int = 2
    num_layers: int = 2
    dropout: float = 0.5
    lr: float = 5e-3
    epochs: int = 10
    batch_size: int = 4096
    ns_rate: int = 1              # the JAX run's field, which it never
                                  # reads: one negative pair a positive
    predictor: str = "mlp"
    neighbor_fanout: int = 0      # 0 = full graph; > 0 = sampled subgraph
    use_kd: bool = False          # distil into an MLP student
    true_label: float = 10.0      # the KD loss's weights
    kd_f: float = 0.1
    kd_p: float = 100.0
    seed: int = 42
    # auto | torch | fused | materialised | flash
    impl: str = "auto"


class LinkPredModel(nn.Module):
    """The learnable ``features`` [n, hidden] (N(0, 0.1^2)), the encoder,
    the predictor and, with ``use_kd``, the MLP ``student``: the
    ``{"features", "encoder", "predictor", "student"}`` tree of the JAX
    run, as one module."""

    # the tables whose rows are the graph's nodes: a sharded step holds a
    # rank's rows of them (``parallel/sharded.py::state_shardings``)
    node_rows = ("features",)

    def __init__(self, n: int, cfg: LinkPredConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = nn.Parameter(
            torch.randn((n, cfg.hidden), generator=generator) * 0.1)
        self.encoder = SparseGAT(cfg.hidden, cfg.hidden, cfg.hidden,
                                 n_heads=cfg.n_heads, dropout=cfg.dropout,
                                 generator=generator)
        self.predictor = LinkPredictor(cfg.predictor, cfg.hidden,
                                       num_layers=cfg.num_layers,
                                       dropout=cfg.dropout,
                                       generator=generator)
        self.student = None
        self.kd_weights = None
        if cfg.use_kd:
            self.student = MLP(cfg.num_layers, cfg.hidden, cfg.hidden,
                               cfg.hidden, cfg.dropout, generator=generator)
            self.kd_weights = dict(true_label_weight=cfg.true_label,
                                   kd_f=cfg.kd_f, kd_p=cfg.kd_p)

    def encode(self, graph: BipartiteGraph, *, train: bool, impl: str,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(graph, self.features, train=train, impl=impl,
                            generator=generator)


def linkpred_loss_parts(model: LinkPredModel, graph: BipartiteGraph, batch,
                        *, impl: str,
                        generator: Optional[torch.Generator] = None):
    """The training loss of one batch ``(pos_s, pos_r, neg_s, neg_r)`` and
    its parts: ``label``, the mean of the positives' and the negatives'
    BCE; with the student, also ``kd_cosine`` (the student's rows of the
    positive sources against the encoder's) and ``kd_mse`` (the student's
    positive scores, the predictor out of training, against the
    encoder's).  Returns ``(total, parts)``."""
    pos_s, pos_r, neg_s, neg_r = batch
    h = model.encode(graph, train=True, impl=impl, generator=generator)
    pos = model.predictor(h[pos_s], h[pos_r], train=True, generator=generator)
    neg = model.predictor(h[neg_s], h[neg_r], train=True, generator=generator)
    label = 0.5 * (bce_loss(pos, torch.ones_like(pos))
                   + bce_loss(neg, torch.zeros_like(neg)))
    if model.student is None:
        return label, {"label": label}
    h_s = model.student(model.features, train=True, generator=generator)
    pos_student = model.predictor(h_s[pos_s], h_s[pos_r], train=False)
    return kd_loss(label, h_s[pos_s], h[pos_s], pos_student, pos,
                   **model.kd_weights)


def linkpred_loss(model: LinkPredModel, graph: BipartiteGraph, batch, *,
                  impl: str, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The training loss of one batch (:func:`linkpred_loss_parts`'s
    total)."""
    return linkpred_loss_parts(model, graph, batch, impl=impl,
                               generator=generator)[0]


@dataclasses.dataclass
class LinkPredRun:
    """Everything one training run holds: the message graph on the device
    and on the host (the sampler's), the model, the optimiser, the dropout
    generator (on the device) and the numpy generator of the batches and
    subgraphs."""

    cfg: LinkPredConfig
    split: dict
    graph: BipartiteGraph
    host_graph: BipartiteGraph
    model: LinkPredModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    rng: np.random.Generator
    impl: str
    device: torch.device


def build_link_prediction(split, cfg: LinkPredConfig,
                          device="cuda") -> LinkPredRun:
    """Set-up of a run: the model initialised from ``cfg.seed`` (on the
    CPU, then moved), Adam, and, for the kernel paths, the graph's
    operators built once."""
    dev = resolve_device(device)
    impl = resolve_impl(cfg.impl, dev)
    host_graph = split["graph"].to("cpu")
    graph = host_graph.to(dev)
    model = LinkPredModel(split["n"], cfg,
                          generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(dev)
    prepare_operators(graph, impl, host_graph)
    return LinkPredRun(
        cfg=cfg, split=split, graph=graph, host_graph=host_graph, model=model,
        optimizer=adam_l2(model.parameters(), cfg.lr),
        generator=torch.Generator(device=dev).manual_seed(cfg.seed),
        rng=np.random.default_rng(cfg.seed), impl=impl, device=dev)


def prepare_operators(graph: BipartiteGraph, impl: str,
                      host: BipartiteGraph) -> None:
    """Build the kernel paths' operators of ``graph`` (the CSR / CSC sort,
    the copies to the device) from ``host``, the same graph on the CPU:
    set-up, not a step."""
    if impl in ("fused", "materialised", "flash"):
        from ..ops.cuda.spmm import operator_for

        operator_for(graph, host=host)
    if impl == "materialised":
        from ..ops.cuda.softmax import softmax_operator_for

        softmax_operator_for(graph, host=host)


# A sampled subgraph's edge slots are padded to a multiple of this.  The
# JAX run pads it to the full graph's slot count (with the full graph's
# edge count) so that XLA does not retrace; here the slots past the real
# edges would only be work: the plain path's gathers and their backward
# accumulate over every slot (on the CPU, 5% of the slots real at fanout 4
# made a step twice the full graph's).  The attention keep mask is hashed
# from (seed, slot), so a real edge's mask does not depend on the padding.
SUBGRAPH_PAD = 128


def epoch_graph(run: LinkPredRun) -> BipartiteGraph:
    """The epoch's message graph: the full graph, or with
    ``neighbor_fanout > 0`` a subgraph of the host graph drawn from the
    run's numpy generator (at most ``neighbor_fanout`` edges a node, with
    its own edge count), on the device with its operators built."""
    fanout = run.cfg.neighbor_fanout
    if fanout <= 0:
        return run.graph
    host = neighbor_sample_subgraph(
        run.rng, run.host_graph, np.arange(run.split["n"]), fanout,
        pad_to_multiple=SUBGRAPH_PAD)
    graph = host.to(run.device)
    prepare_operators(graph, run.impl, host)
    return graph


def end_epoch(run: LinkPredRun, graph: BipartiteGraph) -> None:
    """Drop a sampled epoch's cached operators (the full graph's stay)."""
    if graph is not run.graph:
        from ..ops.cuda.spmm import release

        release(graph)


def epoch_data(run: LinkPredRun):
    """``(graph, batches)`` of one epoch, drawn in the JAX run's order:
    the subgraph (:func:`epoch_graph`), then the batches
    (:func:`epoch_batches`)."""
    graph = epoch_graph(run)
    return graph, epoch_batches(run)


def epoch_batches(run: LinkPredRun) -> torch.Tensor:
    """One epoch's batches on the device, [steps, 4, batch]: a permutation
    of the train positives (remainder dropped) and uniform negatives, drawn
    from the run's numpy generator as the JAX run draws them."""
    train_s, train_r = run.split["train_pos"]
    b = run.cfg.batch_size
    perm = run.rng.permutation(len(train_s))
    steps = len(perm) // b
    if steps == 0:
        raise ValueError(f"batch_size {b} exceeds the {len(perm)} train "
                         "edges")
    ids = perm[: steps * b].reshape(steps, b)
    neg_s = run.rng.integers(0, run.split["n"], (steps, b))
    neg_r = run.rng.integers(0, run.split["n"], (steps, b))
    batches = np.stack([train_s[ids], train_r[ids], neg_s, neg_r], axis=1)
    return torch.from_numpy(batches.astype(np.int64)).to(run.device)


def step_parts(run: LinkPredRun, batch: torch.Tensor,
               graph: Optional[BipartiteGraph] = None) -> dict:
    """One optimiser step on ``batch`` [4, B] over ``graph`` (default: the
    run's full graph); returns ``{"loss", **parts}``, 0-d tensors on the
    device, not synchronised."""
    run.optimizer.zero_grad(set_to_none=True)
    loss, parts = linkpred_loss_parts(
        run.model, run.graph if graph is None else graph, batch,
        impl=run.impl, generator=run.generator)
    loss.backward()
    run.optimizer.step()
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in parts.items()}}


def train_step(run: LinkPredRun, batch: torch.Tensor,
               graph: Optional[BipartiteGraph] = None) -> torch.Tensor:
    """One optimiser step (:func:`step_parts`); returns the loss."""
    return step_parts(run, batch, graph)["loss"]


@torch.no_grad()
def evaluate(run: LinkPredRun, batch_size: int = 65536) -> dict:
    """Hits@20, Hits@50 and AUC of the test positives against the fixed
    negatives, from one encoding of the graph."""
    model = run.model
    h = model.encode(run.graph, train=False, impl=run.impl)

    def scores(s_idx, r_idx):
        s = torch.from_numpy(np.asarray(s_idx, np.int64)).to(run.device)
        r = torch.from_numpy(np.asarray(r_idx, np.int64)).to(run.device)
        return torch.cat([
            model.predictor(h[s[i:i + batch_size]], h[r[i:i + batch_size]],
                            train=False)
            for i in range(0, len(s), batch_size)])

    pos = scores(*run.split["test_pos"])
    neg = scores(*run.split["neg"])
    return {
        "hits@20": float(hits_at_k(pos, neg, 20)),
        "hits@50": float(hits_at_k(pos, neg, 50)),
        "auc": binary_auc(pos.cpu().numpy(), neg.cpu().numpy()),
    }


def run_link_prediction(split, cfg: LinkPredConfig, log=None,
                        device="cuda") -> dict:
    """Train and evaluate on a :func:`msha_gnn_torch.data.split_edges`
    split.  Returns ``{"hits@20", "hits@50", "auc", "final_train_loss",
    "impl", "dataset"}``."""
    log = log or (lambda r: None)
    run = build_link_prediction(split, cfg, device)
    history = []
    for epoch in range(cfg.epochs):
        t0 = time.time()
        graph, batches = epoch_data(run)
        steps = [step_parts(run, batch, graph) for batch in batches]
        end_epoch(run, graph)
        # the epoch's mean loss and its last step's parts, read at once
        last = {k: v for k, v in steps[-1].items() if k != "loss"}
        values = torch.stack([torch.stack([s["loss"] for s in steps]).mean(),
                              *last.values()]).tolist()
        history.append(values[0])
        log({"event": "linkpred_epoch", "epoch": epoch, "loss": values[0],
             "seconds": time.time() - t0, **dict(zip(last, values[1:]))})
    result = {
        **evaluate(run),
        "final_train_loss": history[-1] if history else float("nan"),
        "impl": run.impl,
        "dataset": split["name"],
    }
    log({"event": "linkpred_eval", **result})
    return result
