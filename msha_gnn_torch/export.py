"""Deployment export (``msha_gnn_tpu/export.py``): a checkpoint's scoring
function as one ``torch.export`` program, with the trained weights inside.

:func:`export_scorer` traces the scorer with ``torch.export.export`` (where
the JAX package stages it out as StableHLO) and writes an artifact in the
JAX package's layout: a magic prefix of the port's own, a little-endian
u64 header length, a JSON header (``kind``, ``batch_size``,
``platforms``, ``format`` and the caller's metadata), then the bytes of
``torch.export.save``.  Two kinds, as :class:`~.serving.Predictor` has:

* ``kind='table'`` (models with ``Task.full_scores``): ``() -> [N, M]``,
  the whole score table, the variables and the graph's arrays held as
  constants of the program; a call gathers the asked rows from it.
* ``kind='batch'`` (batch-dependent models, whose scores depend on the
  batch by construction): ``[B] int64 -> [B, M]`` at a fixed B; a call
  pads the ids with node 0 to whole batches, as the JAX scorer does.

GCN's table runs its two SpMMs through the port's kernel ``csr_spmm_f32``:
its wrapper is registered as the operator
``torch.ops.msha_gnn_torch.csr_spmm`` (:mod:`msha_gnn_torch.ops.cuda.spmm`),
which the program calls by name.
So loading an artifact needs that operator registered, that is
``msha_gnn_torch`` importable: :func:`load_scorer` imports it.  The
artifact needs no model code beyond that, but it is not free of Python or
of this package, as the JAX package's StableHLO artifact is.

A program runs on the device it was exported on.  ``platforms=("cpu",
"cuda")`` (``cli export --portable 1``) stores it on the CPU and
:func:`load_scorer` moves it to the device asked for
(``torch.export.passes.move_to_device_pass``); the operator's
registration then follows the tensors' device, the kernel on CUDA and its
plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import resolve_device

MAGIC = b"MSHA_TORCH_EXPORT\x00"
_HDR = 8  # little-endian u64 header-length prefix
FORMAT = "torch.export/pt2"
PLATFORMS = ("cpu", "cuda")


class _Table(nn.Module):
    """``() -> [N, M]``: the task's full-graph scores."""

    def __init__(self, task, model: nn.Module):
        super().__init__()
        self.model, self._task = model, task

    def forward(self) -> torch.Tensor:
        return self._task.full_scores(self.model)


class _Batch(nn.Module):
    """``[B] int64 -> [B, M]``: the task's eval forward of a batch."""

    def __init__(self, task, model: nn.Module):
        super().__init__()
        self.model, self._task = model, task

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        scores, _ = self._task.forward(self.model, ids, train=False)
        return scores


@dataclasses.dataclass
class ExportedScorer:
    """A loaded artifact: its program on ``device`` and its header."""

    program: torch.export.ExportedProgram
    meta: dict
    device: torch.device

    def __post_init__(self):
        self._fn = self.program.module()

    def __call__(self, node_ids) -> torch.Tensor:
        """[len(node_ids), M] log-probabilities on :attr:`device`."""
        ids = torch.as_tensor(np.asarray(node_ids, np.int64),
                              device=self.device)
        with torch.no_grad():
            if self.meta["kind"] == "table":
                return self._fn().index_select(0, ids)
            b = self.meta["batch_size"]
            padded = torch.cat([ids, ids.new_zeros((-ids.shape[0]) % b)])
            out = [self._fn(padded[lo:lo + b])
                   for lo in range(0, padded.shape[0], b)]
            return torch.cat(out)[: ids.shape[0]]


def export_scorer(task, model: nn.Module, *, kind: str = "auto",
                  batch_size: int = 1024,
                  platforms: Optional[Sequence[str]] = None,
                  meta: Optional[dict] = None) -> bytes:
    """The artifact of ``model``'s scorer, traced on the model's device.

    ``kind``: ``'table'`` (needs ``task.full_scores``), ``'batch'``
    (``[batch_size] -> [batch_size, M]``) or ``'auto'`` (table when the
    task has one).  ``platforms`` defaults to the model's device type;
    ``("cpu", "cuda")`` makes a portable artifact (the module's
    docstring).
    """
    if kind == "auto":
        kind = "table" if task.full_scores is not None else "batch"
    dev = next(model.parameters()).device
    if kind == "table":
        if task.full_scores is None:
            raise ValueError("model has no full_scores; use kind='batch'")
        fn, args = _Table(task, model), ()
    elif kind == "batch":
        fn = _Batch(task, model)
        args = (torch.zeros(batch_size, dtype=torch.long, device=dev),)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    plats = list(platforms) if platforms else [dev.type]
    if dev.type not in plats or not set(plats) <= set(PLATFORMS):
        raise ValueError(f"platforms {plats} must be among {PLATFORMS} and "
                         f"hold the model's device, {dev.type}")
    with torch.no_grad():
        program = torch.export.export(fn, args)
    if len(plats) > 1 and dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, "cpu")
    header = dict(meta or {})
    header.update({"kind": kind, "batch_size": batch_size,
                   "platforms": plats, "format": FORMAT,
                   "exported_on": str(dev),
                   "stored_on": "cpu" if len(plats) > 1 else str(dev)})
    buf = io.BytesIO()
    torch.export.save(program, buf)
    hdr = json.dumps(header).encode()
    return (MAGIC + len(hdr).to_bytes(_HDR, "little") + hdr
            + buf.getvalue())


def load_scorer(blob: bytes, device=None) -> ExportedScorer:
    """An :func:`export_scorer` artifact, on ``device`` (default: the
    device it was exported on; another device only when the artifact
    lists its type in ``platforms``)."""
    # the program calls torch.ops.msha_gnn_torch.csr_spmm by name:
    # this import registers it
    from .ops.cuda import spmm  # noqa: F401

    if not blob.startswith(MAGIC):
        raise ValueError("not an msha_gnn_torch export artifact")
    off = len(MAGIC)
    n = int.from_bytes(blob[off:off + _HDR], "little")
    off += _HDR
    meta = json.loads(blob[off:off + n])
    if meta.get("format") != FORMAT:
        raise ValueError(f"unknown artifact format {meta.get('format')!r}")
    stored = torch.device(meta["stored_on"])
    target = torch.device(meta["exported_on"] if device is None else device)
    if target.type not in meta["platforms"]:
        raise ValueError(f"the artifact runs on {meta['platforms']}, not "
                         f"{target.type}; export it with portable=True")
    target = resolve_device(target)
    program = torch.export.load(io.BytesIO(blob[off + n:]))
    if target != stored:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
    return ExportedScorer(program=program, meta=meta, device=target)


def run_export(cfg, output: str, *, kind: str = "auto",
               batch_size: int = 1024, portable: bool = False,
               device="cuda") -> dict:
    """CLI glue: restore ``cfg.checkpoint_dir`` into ``cfg``'s model on
    ``device``, write the artifact to ``output`` and load it back once."""
    from .cli import _build_task
    from .data import load_flow_graph
    from .training.checkpoint import restore_checkpoint

    fg = load_flow_graph(cfg.year, cfg.data_dir)
    built = _build_task(cfg, fg, device)
    if built is None:
        raise ValueError(f"model {cfg.model!r} is not ported")
    task, model = built
    model, _, step = restore_checkpoint(cfg.checkpoint_dir, model)
    blob = export_scorer(
        task, model, kind=kind, batch_size=batch_size,
        platforms=PLATFORMS if portable else None,
        meta={"model": cfg.model, "year": cfg.year,
              "checkpoint_step": int(step), "n_src": fg.n_src,
              "n_dst": fg.n_dst})
    with open(output, "wb") as f:
        f.write(blob)
    scorer = load_scorer(blob)  # a round trip before reporting success
    return {"output": output, "bytes": len(blob), "kind": scorer.meta["kind"],
            "platforms": scorer.meta["platforms"],
            "checkpoint_step": int(step)}
