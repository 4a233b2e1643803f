"""Profiled spans of steps and what the device did in them.

:func:`profile_steps` runs steps under ``torch.profiler`` and writes the
Chrome traces.  :func:`summarize` reads a trace: the device's operations
(kernels, copies, sets) that start inside the window, the union of their
intervals (``busy_s``), the window's length (``window_s``), each kernel by
name, the idle gaps between device operations, each named by the
innermost host operation running at its middle, and the host time of the
benchmark's own spans less the CUDA calls inside them (``host_spans``).
"""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

import torch

WINDOW = "gnnbench.traced_window"
SPAN = "gnnbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class MeasurementFault(RuntimeError):
    """A trace that cannot be true (device time beyond the wall)."""


def profile_steps(step: Callable[[], object], steps: int, warm: int,
                  path: Path, cuda: bool = True) -> Dict:
    """Two profiled spans of ``steps`` steps after ``warm`` more, the
    traces written beside ``path``.  The first records the device alone
    (recording every host operation slows a host-paced step about
    twofold): its device operations, their union (``busy_s``) and the
    host's wall from a synchronise before the first step to one after the
    last (``window_s``).  The second records the host too, inside the
    annotation :data:`WINDOW`, for the idle gaps' names.  On the CPU (no
    ``cuda``) both record the host alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device_only = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    for _ in range(warm):
        step()
    sync()
    with profile(activities=device_only) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall = time.perf_counter() - t0
    out = summarize(_export(prof, path.with_suffix(".device.json")), steps,
                    window_s=wall)

    both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=both) as prof:
        for _ in range(warm):
            step()
        sync()
        with record_function(WINDOW):
            for _ in range(steps):
                step()
            sync()
    host = summarize(_export(prof, path.with_suffix(".host.json")), steps)
    out.update(idle_gaps=host["idle_gaps"], host_spans=host["host_spans"])
    return out


def _export(prof, path: Path) -> dict:
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(m) for m in merged]


def short_name(name: str, width: int = 96) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name[:width]


def summarize(trace: dict, steps: int, window_s=None) -> Dict:
    """The device's operations in the window: the annotation
    :data:`WINDOW`, or, given ``window_s`` (a trace of the window alone),
    every device operation of the trace and that wall."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if window_s is None:
        windows = [e for e in events if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]
        if len(windows) != 1:
            raise MeasurementFault(f"{len(windows)} traced windows in the "
                                   "trace")
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        starts = [float(e["ts"]) for e in events
                  if e.get("cat") in DEVICE_CATS] or [0.0]
        w0, w1 = min(starts), min(starts) + window_s * 1e6
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and w0 <= float(e["ts"]) < w1]
    kernels = [(e["name"], float(e["dur"]) * 1e-6) for e in device
               if e["cat"] == "kernel"]
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1))
             for e in device]
    busy = _union(spans)
    busy_s = sum(hi - lo for lo, hi in busy) * 1e-6
    window_s = (w1 - w0) * 1e-6
    kernel_s = sum(s for _, s in kernels)
    if kernel_s > window_s:
        raise MeasurementFault(f"kernels take {kernel_s} s of a {window_s} "
                               "s window")

    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[short_name(e["name"])] += float(e["dur"]) * 1e-6

    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e["name"] != WINDOW),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        name = "none"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 400, -1), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        gaps[short_name(name)] += (hi - lo) * 1e-6

    # the benchmark's spans (``gnnbench.<name>``) in the window, each less
    # the CUDA runtime and driver calls on its thread inside it: a copy
    # from pageable memory waits there for the device's earlier work
    cuda_calls = [e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    host_spans: Dict[str, float] = defaultdict(float)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or name == WINDOW or \
                not name.startswith(SPAN):
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if not w0 <= lo < w1:
            continue
        inside = sum(float(c["dur"]) for c in cuda_calls
                     if c.get("tid") == e.get("tid")
                     and lo <= float(c["ts"]) < hi)
        host_spans[name[len(SPAN):]] += (hi - lo - inside) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"steps": steps, "window_s": window_s, "busy_s": busy_s,
            "kernels": kernels, "kernel_s": kernel_s,
            "device_ops": top(by_name), "idle_gaps": top(gaps),
            "host_spans": dict(host_spans)}
