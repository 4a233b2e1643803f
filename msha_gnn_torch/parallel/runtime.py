"""Process-group runtime (``msha_gnn_tpu/parallel/runtime.py``).

* :func:`initialize` makes the default process group for ``device``:
  NCCL on CUDA, gloo on the CPU.  Under ``torchrun`` it reads
  ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (and the
  card from ``LOCAL_RANK``); without them it makes a world of one on an
  in-process store, which needs no port.  :func:`shutdown` destroys it.
* :func:`fault_tolerant_fit`: the checkpoint-resuming epoch loop; every
  ``checkpoint_every`` epochs the state is saved, and a restart restores
  the latest checkpoint and continues from its epoch, at the same
  topology.
* :func:`device_health_check` runs a tiny computation on every local card
  under a wall-clock deadline, in a daemon thread, so a device that hangs
  is reported rather than waited on.
* :func:`run_with_restarts` re-invokes a checkpoint-resuming fit after a
  failure, up to ``max_restarts`` times, and joins the lives' histories.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .mesh import backend_for

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return resolve_device(dev)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device="cuda",
               timeout_s: float = 600.0):
    """Make the default process group for ``device`` (NCCL for CUDA, gloo
    for the CPU) and return ``(rank, world_size)``.

    ``init_method`` (with ``world_size`` and ``rank``) names the rendezvous,
    e.g. ``"tcp://localhost:29500"`` or ``"file:///tmp/store"``; without it
    the torchrun variables are read (``env://``), and without those the
    world is this process alone, on a ``dist.HashStore``.  For NCCL the
    card is made current first and bound to the group.  A group that
    already exists is kept if its backend is the device's, else this
    raises."""
    dev = _device(device)
    backend = backend_for(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group exists; "
                               f"{dev} needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if init_method is not None:
        dist.init_process_group(init_method=init_method,
                                world_size=world_size, rank=rank, **kwargs)
    elif all(v in os.environ for v in TORCHRUN_VARS):
        dist.init_process_group(init_method="env://", **kwargs)
    else:
        dist.init_process_group(store=dist.HashStore(), world_size=1,
                                rank=0, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def fault_tolerant_fit(trainer, state, train_ids, test_ids, epochs: int,
                       checkpoint_dir: str, checkpoint_every: int = 1,
                       generator: Optional[torch.Generator] = None):
    """Resumable epoch loop: restores the latest checkpoint of
    ``checkpoint_dir`` (if any) into ``state`` and continues from its
    epoch; saves the state and the epoch every ``checkpoint_every`` epochs
    and after the last.  ``generator`` (default: seeded from the trainer's
    seed on the model's device) draws the dropout masks.  Returns
    ``(state, history)``, one record an epoch run in this life."""
    from ..training.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)

    start_epoch = 0
    step = latest_step(checkpoint_dir)
    if step is not None:
        state, extra, _ = restore_checkpoint(checkpoint_dir, state)
        start_epoch = int((extra or {}).get("epoch", step))
    if generator is None:
        generator = torch.Generator(device=state.device).manual_seed(
            trainer.seed)
    history = []
    for epoch in range(start_epoch, epochs):
        state, loss = trainer.train_epoch(state, train_ids, generator, epoch)
        report = trainer.evaluate(state, test_ids)
        history.append({"epoch": epoch, "train_loss": loss, **report})
        if (epoch + 1) % checkpoint_every == 0 or epoch + 1 == epochs:
            save_checkpoint(checkpoint_dir, state, step=epoch + 1,
                            extra={"epoch": epoch + 1})
    return state, history


def device_health_check(timeout_s: float = 30.0, device="cuda"):
    """Probe every local card (``device="cuda"``; ``"cpu"``: the CPU) with
    a tiny computation under a deadline -> ``{device: "ok" | "hung" |
    "error: ..."}``.  A wedged device hangs the synchronise rather than
    raising; the probe runs in a daemon thread joined with the deadline, so
    a hung probe is reported and does not block the interpreter's exit."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    results = {}
    for d in devices:
        outcome: List[str] = []

        def probe(d=d, outcome=outcome):
            try:
                x = torch.arange(8, dtype=torch.float32, device=d) * 2.0
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
                ok = float(x.sum()) == 56.0
                outcome.append("ok" if ok else "error: wrong sum")
            except Exception as exc:  # noqa: BLE001 - reported, not masked
                outcome.append(f"error: {type(exc).__name__}: {exc}")

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        t.join(timeout_s)
        results[str(d)] = outcome[0] if outcome else "hung"
    return results


def run_with_restarts(fit: Callable[[], tuple], *, max_restarts: int = 2,
                      retry_on: tuple = (Exception,),
                      backoff_s: float = 0.0,
                      on_failure: Optional[Callable] = None):
    """Restart orchestration around a checkpoint-resuming ``fit`` (a
    zero-argument callable returning ``(state, history)``, e.g. a
    :func:`fault_tolerant_fit`).  On a ``retry_on`` failure ``fit`` is
    called again, resuming from its last checkpoint.  Returns ``(state,
    history, report)``: the lives' histories joined, and ``{"restarts",
    "failures"}`` with one entry a failure.  Raises the last failure when
    ``max_restarts`` is spent.  Every rank of a group runs the same
    policy; a dead peer surfaces as a collective's error."""
    history: List[dict] = []
    failures: List[dict] = []
    for attempt in range(max_restarts + 1):
        try:
            state, life_history = fit()
            history.extend(life_history)
            return state, history, {"restarts": attempt,
                                    "failures": failures}
        except retry_on as exc:
            failures.append({"attempt": attempt,
                             "error": f"{type(exc).__name__}: {exc}",
                             "time": time.time()})
            if on_failure is not None:
                on_failure(attempt, exc)
            if attempt == max_restarts:
                raise
            if backoff_s:
                time.sleep(backoff_s)
