"""Joint multi-year MSHA training (``msha_gnn_tpu/training/temporal.py``;
BASELINE config #3: "4-year joint training + ablation variants").

Node ids are re-anonymised every year, so the years share only the
recipient provinces and the model's weights:

* **Shared across years**: the attention layer (``W1``, ``W2``, ``a``,
  ``a3``, ``a4`` and both norms, whose running statistics every year's
  steps move), the output layer ``out_att`` and the recipient features
  ``Rfeatures``, aligned by province *name* across the years'
  ``recipient_index`` maps (:func:`canonical_recipients`).
* **Per year**: the source features ``Sfeatures_<year>`` (GDP in the last
  column) and the city / province groupings.

Years interleave one batch at a time.  A step on one year leaves every
other year's table where it was, but its Adam moments move as the JAX
chain's do: there ``add_decayed_weights`` adds ``wd * param`` to the zero
gradient of every table and optax's single ``count`` advances, and only
the *update* of the other tables is zeroed.  ``torch.optim.Adam`` skips a
parameter whose ``.grad`` is None and counts steps per parameter, so
:func:`temporal_step` gives every parameter without a gradient a zero one
(torch then adds ``wd * p`` to its moments and advances its ``step``) and
puts the other years' tables back after the step.

Years without flow records are skipped with a ``temporal_skip_year`` log
line; their tables exist all the same and take the moments above.  The
evaluation scores each year's test records from one full forward with a
batch of node 0 (``batch = [0]``), so every row's intra term comes from
node 0's clique: the JAX package's quirk, kept.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..graph import FlowGraph, Grouping, PairGrouping
from ..models.common import gdp_feature_init
from ..models.msha import MSHABase
from .metrics import classification_report
from .optim import adam_l2
from .trainer import TrainState


def canonical_recipients(recipient_maps: Dict[str, Dict[str, int]]):
    """Align per-year ``{province name: local idx}`` maps to one canonical
    recipient order (the sorted union of the names).

    Returns ``(names, to_canon)``, ``to_canon[year][local_idx] =
    canonical_idx`` (int32).
    """
    names = sorted(set().union(*[set(m) for m in recipient_maps.values()]))
    canon = {n: i for i, n in enumerate(names)}
    to_canon = {}
    for y, m in recipient_maps.items():
        perm = np.zeros(len(m), np.int32)
        for name, local in m.items():
            perm[int(local)] = canon[name]
        to_canon[y] = perm
    return names, to_canon


def _canonicalize_mask(inter_mask: np.ndarray, perm: np.ndarray,
                       m_canon: int) -> np.ndarray:
    """A year's [N, M_y] mask with its columns moved to canonical order."""
    out = np.zeros((inter_mask.shape[0], m_canon), bool)
    out[:, perm] = np.asarray(inter_mask)
    return out


class TemporalMSHA(MSHABase):
    """MSHA with a source feature table per year and everything else
    shared: ``forward(year, ...)`` scores with ``Sfeatures_<year>`` and
    the one attention / output stack.  Every year's table is a parameter
    whatever the year of a call, so the optimiser's state covers them
    all."""

    def __init__(self, years: Sequence[str],
                 gdp_by_year: Dict[str, torch.Tensor], in_features: int,
                 out_features: int, n_classes: int, n_heads: int = 2,
                 dropout: float = 0.5, *, use_intra: bool = True,
                 joint_softmax: bool = True, use_out_att: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.years = tuple(years)
        for y in self.years:
            setattr(self, f"Sfeatures_{y}", nn.Parameter(gdp_feature_init(
                gdp_by_year[y], in_features, generator)))
        self._build(in_features, out_features, n_classes, n_heads, dropout,
                    use_intra, joint_softmax, use_out_att, generator)

    def table(self, year: str) -> nn.Parameter:
        """``Sfeatures_<year>``."""
        return getattr(self, f"Sfeatures_{year}")

    def forward(self, year: str, inter_mask: torch.Tensor, city: Grouping,
                province: Grouping, batch: torch.Tensor, *, train: bool,
                record: bool = False,
                rows: Optional[torch.Tensor] = None,
                pair: Optional[PairGrouping] = None,
                generator: Optional[torch.Generator] = None):
        """:meth:`MSHABase.scores` of ``year``'s table; ``inter_mask`` is
        the year's [N_year, M_canon] mask in canonical columns."""
        return self.scores(self.table(year), inter_mask, city, province,
                           batch, train=train, record=record, rows=rows,
                           pair=pair, generator=generator)


@dataclasses.dataclass
class TemporalRun:
    """A joint run's state and its static inputs on ``device``: per active
    year the canonical mask, the groupings (and their pair table), the
    records' sources and canonical labels (numpy) and the train / test
    split."""

    state: TrainState
    years: tuple
    active: list
    masks: Dict[str, torch.Tensor]
    groupings: Dict[str, tuple]
    src: Dict[str, np.ndarray]
    dst: Dict[str, np.ndarray]
    splits: Dict[str, tuple]
    device: torch.device


def build_temporal(
    fgs: Dict[str, FlowGraph],
    recipient_maps: Dict[str, Dict[str, int]],
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
    train_fraction: float = 0.9,
    seed: int = 42,
    log=None,
    device="cuda",
) -> TemporalRun:
    """The model (drawn from ``torch.Generator().manual_seed(seed)``), Adam
    with coupled L2, and each active year's inputs; logs and skips the
    years without flow records."""
    from ..data.flow import train_test_split_records

    log = log or (lambda r: None)
    dev = resolve_device(device)
    years = tuple(sorted(fgs))
    names, to_canon = canonical_recipients(recipient_maps)
    m_canon = len(names)
    gen = torch.Generator().manual_seed(seed)
    model = TemporalMSHA(
        years, {y: fgs[y].gdp for y in years}, in_features, out_features,
        m_canon, n_heads, dropout, use_intra=use_intra,
        joint_softmax=joint_softmax, use_out_att=use_out_att,
        generator=gen).to(dev)

    active, masks, groupings, src, dst, splits = [], {}, {}, {}, {}, {}
    for y in years:
        fg = fgs[y]
        if fg.num_records == 0:
            log({"event": "temporal_skip_year", "year": y,
                 "reason": "no flow records"})
            continue
        active.append(y)
        mask = _canonicalize_mask(fg.inter.to_dense().cpu().numpy() > 0,
                                  to_canon[y], m_canon)
        masks[y] = torch.from_numpy(mask).to(dev)
        pair = PairGrouping.build(fg.city, fg.province).to(dev) \
            if use_intra else None
        groupings[y] = (fg.city.to(dev), fg.province.to(dev), pair)
        src[y] = fg.edge_src.cpu().numpy().astype(np.int64)
        dst[y] = to_canon[y][fg.edge_dst.cpu().numpy()].astype(np.int64)
        splits[y] = train_test_split_records(len(src[y]), train_fraction,
                                             seed)
    if not active:
        raise ValueError("no year has flow records")
    state = TrainState.create(model, lambda p: adam_l2(p, lr, weight_decay))
    return TemporalRun(state=state, years=years, active=active, masks=masks,
                       groupings=groupings, src=src, dst=dst, splits=splits,
                       device=dev)


def temporal_loss(run: TemporalRun, year: str, batch: torch.Tensor,
                  labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The mean NLL of one training batch of ``year`` (``batch`` [B] source
    rows, ``labels`` [B] canonical recipients, both on the device)."""
    city, prov, pair = run.groupings[year]
    logp = run.state.model(year, run.masks[year], city, prov, batch,
                           train=True, rows=batch, pair=pair,
                           generator=generator)
    return F.nll_loss(logp, labels)


def temporal_step(run: TemporalRun, year: str, batch: torch.Tensor,
                  labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """One Adam step on a batch of ``year``; returns the loss on the
    device, not read.  Every parameter without a gradient (the other
    years' tables) gets a zero one, so its moments take ``wd * p`` and its
    step count advances, and the other years' tables are put back after
    the step: their values do not move."""
    state = run.state
    state.optimizer.zero_grad(set_to_none=True)
    loss = temporal_loss(run, year, batch, labels, generator)
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    frozen = [state.model.table(y) for y in run.years if y != year]
    kept = [t.detach().clone() for t in frozen]
    state.optimizer.step()
    with torch.no_grad():
        for t, k in zip(frozen, kept):
            t.copy_(k)
    state.step += 1
    return loss.detach()


def evaluate_temporal(run: TemporalRun, year: str) -> dict:
    """The metric block of ``year``'s test records, scored from one full
    forward in eval mode with ``batch = [0]`` (no pair table, all rows)."""
    city, prov, _ = run.groupings[year]
    test_ids = run.splits[year][1]
    with torch.inference_mode():
        scores = run.state.model(
            year, run.masks[year], city, prov,
            torch.zeros(1, dtype=torch.long, device=run.device), train=False)
        b = torch.from_numpy(run.src[year][test_ids]).to(run.device)
        labels = torch.from_numpy(run.dst[year][test_ids]).to(run.device)
        report = classification_report(scores[b], labels)
    return {k: float(v) for k, v in report.items()}


def fit_temporal(run: TemporalRun, epochs: int, batch_size: int = 64,
                 seed: int = 42, log=None) -> list:
    """The joint epoch loop over ``run``'s active years -> per epoch
    ``{year: {"train_loss", **metrics}}``.

    Each epoch draws every active year's permutation of its train records,
    in sorted-year order, from one ``np.random.default_rng(seed)`` made
    before the first epoch, then steps the years in turn one batch at a
    time until each runs out (the remainder that fills no batch is
    dropped); ``train_loss`` is the unweighted mean of the year's step
    losses.  The dropout masks come from one generator on the device,
    seeded with ``seed``.
    """
    log = log or (lambda r: None)
    dev = run.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        perms = {y: rng.permutation(run.splits[y][0]) for y in run.active}
        srcs = {y: torch.from_numpy(run.src[y][perms[y]]).to(dev)
                for y in run.active}
        dsts = {y: torch.from_numpy(run.dst[y][perms[y]]).to(dev)
                for y in run.active}
        offsets = dict.fromkeys(run.active, 0)
        totals = {y: torch.zeros((), device=dev) for y in run.active}
        counts = dict.fromkeys(run.active, 0)
        live = list(run.active)
        while live:
            for y in list(live):
                o = offsets[y]
                if o + batch_size > len(perms[y]):
                    live.remove(y)
                    continue
                offsets[y] = o + batch_size
                totals[y] += temporal_step(run, y, srcs[y][o:o + batch_size],
                                           dsts[y][o:o + batch_size],
                                           generator)
                counts[y] += 1
        report = {y: {"train_loss": float(totals[y]) / max(counts[y], 1),
                      **evaluate_temporal(run, y)} for y in run.active}
        history.append(report)
        log({"event": "temporal_epoch", "epoch": epoch, "report": report,
             "seconds": time.time() - t0})
    return history


def train_temporal_msha(
    fgs: Dict[str, FlowGraph],
    recipient_maps: Dict[str, Dict[str, int]],
    *,
    epochs: int = 5,
    batch_size: int = 64,
    seed: int = 42,
    log=None,
    device="cuda",
    **kwargs,
):
    """:func:`build_temporal` (``kwargs``: widths, flags, ``lr``,
    ``weight_decay``, ``train_fraction``), then :func:`fit_temporal`.
    Returns ``(run, history)``: ``run.state`` holds the model and the
    optimiser."""
    run = build_temporal(fgs, recipient_maps, seed=seed, log=log,
                         device=device, **kwargs)
    return run, fit_temporal(run, epochs, batch_size, seed, log)


def run_temporal_train(years=("2015", "2016", "2017", "2018"),
                       data_dir: Optional[str] = None, log=None,
                       device="cuda", **kwargs):
    """Load each year's graph and recipient map from ``data_dir`` (default
    ``data/flow.py::DEFAULT_DATA_DIR``) and run :func:`train_temporal_msha`
    on ``device``."""
    from ..data.flow import DEFAULT_DATA_DIR, load_flow_graph, load_index_match

    data_dir = data_dir or DEFAULT_DATA_DIR
    fgs, maps = {}, {}
    for y in years:
        fgs[y] = load_flow_graph(y, data_dir)
        _, _, maps[y] = load_index_match(
            os.path.join(data_dir, f"Adjacent{y}.json"))
    return train_temporal_msha(fgs, maps, log=log, device=device, **kwargs)
