"""Where the time of the port's paths goes, on one CUDA card.

    python3 scripts_torch_profile.py [--fills 20] [--requests 200] \
        [--steps 10] [--trace build/profile/fill_trace.json] \
        [--step-trace build/profile/step_trace.json] \
        [--materialised-step-trace build/profile/step_trace_mat.json] \
        [--flash-step-trace build/profile/step_trace_flash.json] \
        [--msha-trace build/profile/msha_forward_trace.json] \
        [--ablation3-trace build/profile/ablation3_fill_trace.json]

GCN serving, on a synthetic flow graph of the 2015 data's shape (39,179
sources, 32 recipients, 233,887 records) with the GCN at full width
(nfeat 128):

* one full-score fill (``Task.full_scores``) under ``torch.profiler``:
  device time by kernel, device time per fill, host wall time per fill, and
  the device's idle share of that wall time;
* a request of 64 nodes (``/v1/predict``, k = 5): p50 of the in-process
  ``ModelService.predict`` and of the same request over HTTP on loopback.

MSHA serving on the same graph at ``TrainConfig()`` (in 128, 64 a head,
2 heads) and ``--predict_batch`` 1024:

* ``--fills`` per-batch forwards of full MSHA (one padded batch of 1024)
  under ``torch.profiler``: device time and kernels per forward, host
  wall, idle share; the p50 of a 64-node ``/v1/predict`` (in process and
  over HTTP), each request one padded forward;
* ``--fills`` cache fills of ablation3 (``Task.full_scores``), the same
  readings.

Link-prediction training at ``LinkPredConfig()`` (hidden 64, 2 heads,
dropout 0.5, batch 4096) on synthetic ogbl-ddi (seed 42):

* ``--steps`` training steps (``train_step``: forward, backward, Adam)
  under ``torch.profiler``: device time by kernel per step, host wall time
  per step, and the device's idle share; once for the fused path
  (``impl="auto"``), once for the materialised attention pipeline
  (``impl="materialised"``) and once for flash-GAT (``impl="flash"``);
* the three ways' unprofiled step wall side by side: ``ROUNDS`` rounds
  of ``--steps`` synchronised steps of each, the order of materialised and
  flash alternating from round to round; per way the median step of each
  round, the median and quartiles of those, and the rounds flash won.

Prints the card's name and power limit first and one JSON summary last;
the Chrome traces go to ``--trace``, ``--step-trace``,
``--materialised-step-trace``, ``--flash-step-trace``, ``--msha-trace``
and ``--ablation3-trace``.
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

from msha_gnn_torch.server import make_server

# rounds of the side-by-side step timing: the pair count at which flash is
# read against materialised (PERF.md counts it faster if it wins 9 of 10)
ROUNDS = 10


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


def profile_calls(fn, calls: int, trace: str, title: str) -> dict:
    """Device time by kernel, kernels, host wall p50 and the device's idle
    share of ``calls`` synchronised calls of ``fn`` (after 3 of warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
    prof.export_chrome_trace(trace)
    kernels = device_kernels(prof, calls)
    device_ms = sum(k[1] for k in kernels) / 1e3
    wall_ms = statistics.median(wall)
    print(f"{title}, device time per call, by kernel:")
    for name, us, n in kernels:
        print(f"  {us:9.2f} us  x{n:g}  {name[:110]}")
    return {"wall_ms_p50": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "kernels_per_call": sum(k[2] for k in kernels),
            "top_kernels_us": {k[0][:80]: k[1] for k in kernels[:10]}}


def request_p50(service, batches) -> dict:
    """p50 of a ``/v1/predict`` (k = 5) of each of ``batches``, in process
    and over HTTP on loopback (after one warm-up request)."""
    service.predict(batches[0], k=5)
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
    return {"predict_64_in_process_ms_p50": statistics.median(local),
            "predict_64_http_ms_p50": statistics.median(http)}


def profile_msha(fg, calls: int, requests: int, trace: str,
                 fill_trace: str) -> dict:
    """The MSHA per-batch forward and ablation3's fill at full width."""
    import dataclasses

    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.server import ModelService
    from msha_gnn_torch.serving import Predictor
    from msha_gnn_torch.utils import TrainConfig

    rng = np.random.default_rng(1)
    batches = [rng.integers(0, fg.n_src, 64).tolist()
               for _ in range(requests)]
    task, model = _build_task(TrainConfig(), fg, "cuda")
    padded = torch.from_numpy(np.concatenate(
        [np.asarray(batches[0]), np.zeros(1024 - 64, np.int64)]))

    def forward():
        with torch.inference_mode():
            task.forward(model, padded, train=False)

    out = {"msha_batch_forward": profile_calls(
        forward, calls, trace, "msha per-batch forward (1024 rows)")}
    out["msha_batch_forward"].update(request_p50(ModelService(
        Predictor.from_state(task, model), n_src=fg.n_src), batches))
    task3, model3 = _build_task(
        dataclasses.replace(TrainConfig(), model="ablation3"), fg, "cuda")
    out["ablation3_fill"] = profile_calls(
        lambda: task3.full_scores(model3), calls, fill_trace,
        "ablation3 cache fill")
    out["ablation3_fill"].update(request_p50(ModelService(
        Predictor.from_state(task3, model3), n_src=fg.n_src), batches))
    print(f"msha serving: {json.dumps(out)}", flush=True)
    return out


def profile_linkpred(steps: int, trace: str, impl: str = "auto") -> dict:
    """Device time by kernel and the idle share of ``steps`` full-width
    linkpred training steps of ``impl`` (after 3 of warm-up)."""
    from msha_gnn_torch.data import load_ddi, split_edges
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    split = split_edges(load_ddi(seed=42), seed=42)
    run = build_link_prediction(split, LinkPredConfig(impl=impl),
                                device="cuda")
    batches = iter(epoch_batches(run))
    return profile_calls(lambda: train_step(run, next(batches)), steps,
                         trace, f"linkpred training step ({run.impl})")


def compare_steps(steps: int) -> dict:
    """Unprofiled wall time of ``train_step`` for fused, materialised and
    flash from one process: ``ROUNDS`` rounds of ``steps`` synchronised
    steps of each way (fused first, then materialised and flash in an order
    that alternates), each way's median step per round."""
    from msha_gnn_torch.data import load_ddi, split_edges
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    split = split_edges(load_ddi(seed=42), seed=42)
    impls = ("fused", "materialised", "flash")
    runs = {impl: build_link_prediction(
        split, LinkPredConfig(impl="auto" if impl == "fused" else impl),
        device="cuda") for impl in impls}
    batches = {impl: epoch_batches(run) for impl, run in runs.items()}
    for impl in impls:  # warm-up
        for batch in batches[impl][:3]:
            train_step(runs[impl], batch)
    torch.cuda.synchronize()
    medians = {impl: [] for impl in impls}
    for r in range(ROUNDS):
        pair = ["materialised", "flash"][::1 if r % 2 == 0 else -1]
        for impl in ["fused", *pair]:
            wall = []
            for i in range(steps):
                batch = batches[impl][(3 + r * steps + i)
                                      % len(batches[impl])]
                t0 = time.perf_counter()
                train_step(runs[impl], batch)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            medians[impl].append(statistics.median(wall))
    summary = {"rounds": ROUNDS, "steps_per_round": steps,
               "round_medians_ms": medians,
               "flash_faster_than_materialised_rounds": sum(
                   f < m for f, m in zip(medians["flash"],
                                         medians["materialised"]))}
    for impl, meds in medians.items():
        q = statistics.quantiles(meds, n=4) if len(meds) > 1 else meds * 3
        summary[f"{impl}_ms_p50"] = statistics.median(meds)
        summary[f"{impl}_ms_quartiles"] = [q[0], q[2]]
    print(f"linkpred step wall, unprofiled, {ROUNDS} rounds of {steps} "
          f"steps: {json.dumps(summary)}", flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fills", type=int, default=20)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default="build/profile/fill_trace.json")
    ap.add_argument("--step-trace", default="build/profile/step_trace.json")
    ap.add_argument("--materialised-step-trace",
                    default="build/profile/step_trace_mat.json")
    ap.add_argument("--flash-step-trace",
                    default="build/profile/step_trace_flash.json")
    ap.add_argument("--msha-trace",
                    default="build/profile/msha_forward_trace.json")
    ap.add_argument("--ablation3-trace",
                    default="build/profile/ablation3_fill_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scripts_torch_profile: CUDA is not available", file=sys.stderr)
        return 1
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.server import ModelService
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
    gcn = profile_calls(lambda: task.full_scores(model), args.fills,
                        args.trace, "GCN cache fill")
    service = ModelService(Predictor.from_state(task, model),
                           n_src=fg.n_src,
                           class_names={i: f"P{i}" for i in range(fg.n_dst)})
    rng = np.random.default_rng(0)
    gcn.update(request_p50(service, [rng.integers(0, fg.n_src, 64).tolist()
                                     for _ in range(args.requests)]))

    msha = profile_msha(fg, args.fills, args.requests, args.msha_trace,
                        args.ablation3_trace)
    linkpred = profile_linkpred(args.steps, args.step_trace)
    materialised = profile_linkpred(args.steps, args.materialised_step_trace,
                                    impl="materialised")
    flash = profile_linkpred(args.steps, args.flash_step_trace, impl="flash")
    steps_side_by_side = compare_steps(args.steps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "gcn_fill": gcn,
        "msha": msha,
        "linkpred": linkpred,
        "linkpred_materialised": materialised,
        "linkpred_flash": flash,
        "linkpred_steps_side_by_side": steps_side_by_side,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
