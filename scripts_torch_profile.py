"""Where the time of the port's paths goes, on one CUDA card.

    python3 scripts_torch_profile.py [--fills 20] [--requests 200] \
        [--steps 10] [--trace build/profile/fill_trace.json] \
        [--step-trace build/profile/step_trace.json]

GCN serving, on a synthetic flow graph of the 2015 data's shape (39,179
sources, 32 recipients, 233,887 records) with the GCN at full width
(nfeat 128):

* one full-score fill (``Task.full_scores``) under ``torch.profiler``:
  device time by kernel, device time per fill, host wall time per fill, and
  the device's idle share of that wall time;
* a request of 64 nodes (``/v1/predict``, k = 5): p50 of the in-process
  ``ModelService.predict`` and of the same request over HTTP on loopback.

Link-prediction training at ``LinkPredConfig()`` (hidden 64, 2 heads,
dropout 0.5, batch 4096) on synthetic ogbl-ddi (seed 42):

* ``--steps`` training steps (``train_step``: forward, backward, Adam)
  under ``torch.profiler``: device time by kernel per step, host wall time
  per step, and the device's idle share.

Prints the card's name and power limit first and one JSON summary last;
the Chrome traces go to ``--trace`` and ``--step-trace``.
Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch


def _device_us(evt, self_only: bool) -> float:
    """An event's device time in us, by the name this torch version uses."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_kernels(prof, per: int):
    """``[(name, device us per unit, launches per unit)]`` of the CUDA
    events of ``prof``, largest first.  User annotations on the device
    timeline (``Optimizer.step#Adam.step``) span kernels that are listed
    on their own, so they are left out."""
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt, self_only=True)
        if getattr(evt, "is_user_annotation", False):
            continue
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.key, us / per, evt.count / per))
    kernels.sort(key=lambda k: -k[1])
    return kernels


def profile_linkpred(steps: int, trace: str) -> dict:
    """Device time by kernel and the idle share of ``steps`` full-width
    linkpred training steps."""
    from torch.profiler import ProfilerActivity, profile

    from msha_gnn_torch.data import load_ddi, split_edges
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    split = split_edges(load_ddi(seed=42), seed=42)
    run = build_link_prediction(split, LinkPredConfig(), device="cuda")
    batches = epoch_batches(run)
    for batch in batches[:3]:
        train_step(run, batch)
    torch.cuda.synchronize()
    wall = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches[3: 3 + steps]:
            t0 = time.perf_counter()
            train_step(run, batch)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
    prof.export_chrome_trace(trace)
    kernels = device_kernels(prof, len(wall))
    device_ms = sum(k[1] for k in kernels) / 1e3
    wall_ms = statistics.median(wall)
    print(f"linkpred training step ({run.impl}), device time per step, "
          "by kernel:")
    for name, us, calls in kernels:
        print(f"  {us:9.2f} us  x{calls:g}  {name[:110]}")
    return {
        "step_wall_ms_p50": wall_ms,
        "step_device_ms": device_ms,
        "step_device_idle_share": max(0.0, 1 - device_ms / wall_ms),
        "step_kernels_per_step": sum(k[2] for k in kernels),
        "step_top_kernels_us": {k[0][:80]: k[1] for k in kernels[:12]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fills", type=int, default=20)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default="build/profile/fill_trace.json")
    ap.add_argument("--step-trace", default="build/profile/step_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scripts_torch_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.server import ModelService, make_server
    from msha_gnn_torch.serving import Predictor
    from msha_gnn_torch.training import gcn_task

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    fg = synthetic_flow(39179, 32, 291, 32, 233887, seed=0)
    task, model = gcn_task(fg, nfeat=128, seed=0, device="cuda")
    for _ in range(3):
        task.full_scores(model)
    torch.cuda.synchronize()

    wall = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.fills):
            t0 = time.perf_counter()
            task.full_scores(model)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    kernels = device_kernels(prof, args.fills)
    device_ms = sum(k[1] for k in kernels) / 1e3
    wall_ms = statistics.median(wall)
    print("device time per fill, by kernel:")
    for name, us, calls in kernels:
        print(f"  {us:9.2f} us  x{calls:g}  {name[:110]}")

    service = ModelService(Predictor.from_state(task, model),
                           n_src=fg.n_src,
                           class_names={i: f"P{i}" for i in range(fg.n_dst)})
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, fg.n_src, 64).tolist()
               for _ in range(args.requests)]
    service.predict(batches[0], k=5)  # fills the cache
    local = []
    for nodes in batches:
        t0 = time.perf_counter()
        service.predict(nodes, k=5)
        local.append((time.perf_counter() - t0) * 1e3)
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/predict"
    http = []
    try:
        for nodes in batches:
            body = json.dumps({"nodes": nodes, "k": 5}).encode()
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()
            http.append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    linkpred = profile_linkpred(args.steps, args.step_trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "fill_wall_ms_p50": wall_ms,
        "fill_device_ms": device_ms,
        "fill_device_idle_share": max(0.0, 1 - device_ms / wall_ms),
        "fill_kernels_per_fill": sum(k[2] for k in kernels),
        "predict_64_in_process_ms_p50": statistics.median(local),
        "predict_64_http_ms_p50": statistics.median(http),
        "top_kernels_us": {k[0][:80]: k[1] for k in kernels[:8]},
        "linkpred": linkpred,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
