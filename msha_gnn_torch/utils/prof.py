"""Profiling utilities (``msha_gnn_tpu/utils/prof.py``), on
``torch.profiler``: a trace of a region written as a Chrome trace, and the
port's named spans.

A span (:class:`span`) is the port's one timing mechanism.  It times the
port as it runs unprofiled: each call adds the host seconds it encloses
and one call to a process-wide registry under its name, and a span opened
with a CUDA ``device`` also records a pair of CUDA events on that device's
current stream, which adds to the name's device milliseconds.  The pairs
are read when a reader asks (:func:`device_ms`), which synchronises then;
the hot path never waits.  A name's first call is set aside: it holds the
one-time work (the kernel libraries' build and load, the allocator's
first requests).  While a ``torch.profiler`` records, a span is a
``record_function`` annotation instead, on the trace's timeline (a
``user_annotation`` event) beside the device's kernels, and adds nothing
to the registry: a profiled step is slowed, and its device time is the
trace's.

The spans of the port, ``msha.<layer>.<what>``, and what reads them
(``gnnbench/metrics/``):

=========================  ==============================================
``msha.scale.batch``       ``training/scale.py::draw_batch``, the whole
                           draw (``batch_draw_ms``)
``msha.scale.batch.copy``  inside it, the four copies to the device alone:
                           on the card, their CUDA events from the stream
                           reaching the first copy to the end of the last
                           (``batch_copy_ms``); on the host, also the wait
                           for the device's earlier work that a copy from
                           pageable memory makes (``batch_draw_ms``
                           leaves it out)
``msha.r1gat.fwd``         ``ops/chunked_rank1.py``, the forward over
                           every slice and the merges (``attn_fwd_ms``)
``msha.r1gat.bwd``         the whole backward, on the autograd engine's
                           thread (``attn_bwd_ms``)
``msha.r1gat.bwd.dx``      each slice's ``dx``: the ``q`` gather, the two
                           transposed SpMMs with their fix-up grids, the
                           ``index_add_`` into ``dx`` (``attn_dx_ms``)
=========================  ==============================================

``Trainer.fit(profile_dir=)`` names its phases with spans too
(``train_epoch_<i>``, ``eval_<i>``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Set

import torch

# past this many unread CUDA event pairs, a span's exit folds the oldest
# ones that have completed into their names' device time, so the pairs
# held stay bounded and each exit folds about one
FOLD_AT = 4096

_lock = threading.Lock()
_seen: Set[str] = set()                 # names whose first call has run
_host: Dict[str, List[float]] = {}      # name -> [seconds, calls]
_device: Dict[str, List[float]] = {}    # name -> [milliseconds, calls]
_pending: Deque[tuple] = collections.deque()  # (name, start, end) events


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


class span:
    """``with span(name[, device]):`` -- a named span (see the module's
    docstring).  ``device``: the :class:`torch.device` whose work the span
    encloses; on a CUDA device, its current stream gets a CUDA event at
    the entry and at the exit of each unprofiled call."""

    __slots__ = ("name", "device", "_t0", "_record", "_start", "_first")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name = name
        self.device = device

    def __enter__(self) -> "span":
        self._record = self._start = None
        # the profiler's own check, for this thread: the autograd engine's
        # device threads inherit the state of the thread that called
        # backward()
        if torch.autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
            return self
        # the host time encloses the span's own events and folding, so
        # that an enclosing span less this one holds none of them
        self._t0 = time.perf_counter()
        self._first = self.name not in _seen
        if (not self._first and self.device is not None
                and self.device.type == "cuda"):
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> None:
        if self._record is not None:
            self._record.__exit__(*exc)
            return
        end = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        with _lock:
            if self._first:
                _seen.add(self.name)
                return
            if end is not None:
                _pending.append((self.name, self._start, end))
                _fold(wait=False)
            seconds = time.perf_counter() - self._t0
            rec = _host.get(self.name)
            if rec is None:
                _host[self.name] = [seconds, 1]
            else:
                rec[0] += seconds
                rec[1] += 1


def _fold(wait: bool) -> None:
    """Adds event pairs to their names' device time, oldest first: every
    pair, waiting for each, with ``wait``; else while more than
    :data:`FOLD_AT` are held and the oldest has completed.  Under
    ``_lock``."""
    while _pending and (wait or len(_pending) > FOLD_AT):
        name, start, end = _pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        rec = _device.setdefault(name, [0.0, 0])
        rec[0] += start.elapsed_time(end)
        rec[1] += 1


def host_seconds(name: str) -> Optional[float]:
    """Host seconds spent in the unprofiled calls of the spans ``name``
    after the first; None if none ran."""
    with _lock:
        rec = _host.get(name)
        return None if rec is None else rec[0]


def calls(name: str) -> Optional[int]:
    """How many calls :func:`host_seconds` covers; None if none."""
    with _lock:
        rec = _host.get(name)
        return None if rec is None else rec[1]


def device_ms(name: str) -> Optional[float]:
    """Device milliseconds between the CUDA events of the unprofiled calls
    of the spans ``name`` after the first; None if none ran on a card.
    Waits for the device to reach the last of them."""
    with _lock:
        _fold(wait=True)
        rec = _device.get(name)
        return None if rec is None else rec[0]


def device_calls(name: str) -> Optional[int]:
    """How many calls :func:`device_ms` covers; None if none."""
    with _lock:
        _fold(wait=True)
        rec = _device.get(name)
        return None if rec is None else rec[1]


def reset() -> None:
    """Forgets every span recorded so far.  A name that has run stays
    seen: its next call is counted."""
    with _lock:
        _host.clear()
        _device.clear()
        _pending.clear()
