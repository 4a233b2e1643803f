"""Profiling utilities (``msha_gnn_tpu/utils/prof.py``), on
``torch.profiler``: a trace of a region written as a Chrome trace, named
phase annotations, and a steady-state step timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the region (host, and the card when CUDA is available) and
    write ``<log_dir>/trace.json``, a Chrome trace; no-op when None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as p:
        yield
    p.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named trace annotation for a phase (a context manager)."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Steady-state step timer.  The first step (the kernels' build and
    the allocator's first requests) is set aside as
    ``first_step_seconds``; ``times`` and the mean are over the rest.
    The clock is read after the device's queued work is done, so a step
    is timed by its work, not by its enqueue."""

    def __init__(self):
        self.first_step_seconds: Optional[float] = None
        self.times: list = []

    @contextlib.contextmanager
    def step(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        if self.first_step_seconds is None:
            self.first_step_seconds = dt
        else:
            self.times.append(dt)

    @property
    def mean_step_seconds(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
