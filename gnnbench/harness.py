"""One run of one cell: set-up, the measured window, the traced steps, the
check against the plain reference, and the result line.

A run:

1. draws the cell's inputs from the seed (``drivers/<driver>.py``
   ``inputs`` and ``initial_params``: the benchmark's work, before the
   memory peak is reset);
2. builds the program (``build``) and drives it through its first
   :data:`PRE_STEPS` steps with the window's own step, reading each
   loss, the first gradient from Adam's state after one step and each
   parameter's change after the first step and after the last (the
   program's readings);
3. measures for ``seconds``: a CUDA event after every step, one
   synchronise at the end;
4. with ``trace``, profiles :data:`TRACE_WARM` plus the configuration's
   ``trace_steps`` more steps and reads the per-layer metrics
   (``metrics/<metric>.py``) from that trace and the window;
5. frees the program, runs ``reference/<driver>.py`` over the same
   inputs for :data:`PRE_STEPS` steps in float64 and compares
   (``compare.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from . import compare

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "msha_gnn_tpu")
PRE_STEPS = 3
TRACE_WARM = 2
NORM_CHUNK = 1 << 22


def prepare_env() -> None:
    """Every kernel cache under the checkout's ``build/``, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "gnnbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "gnnbench"
                                             / "torch_extensions")


def forbidden_modules(modules=None):
    """The loaded modules' top-level names that are JAX or the JAX
    package, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(held: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held``, also the cells held out of it
    (``held/<cell>.json``: their ``workloads`` and ``configs`` entries),
    which the CPU tests and ``calibrate.py --held`` still drive."""
    spec = load_json(ROOT / "BENCHMARK.json")
    if held:
        for path in sorted((HERE / "held").glob("*.json")):
            extra = load_json(path)
            spec["workloads"] += extra["workloads"]
            spec["configs"] += extra["configs"]
    return spec


def cell(workload: str, spec: Optional[dict] = None):
    """``(entry, config, traffic)`` of a cell, each found by its name."""
    spec = spec or benchmark()
    entry = {w["name"]: w for w in spec["workloads"]}[workload]
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    if "edges" in config and config["edges"] != traffic.get("edges"):
        raise ValueError(f"{workload}: {conf['name']} states "
                         f"{config['edges']} edges, {entry['traffic']} has "
                         f"{traffic.get('edges')}")
    return entry, config, traffic


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_metric(name: str):
    """``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gnnbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spans:
    """Host seconds of named benchmark-side spans; while ``tracing``, each
    span is also a profiler annotation ``gnnbench.<name>``."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.tracing = False

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function

            with record_function(f"gnnbench.{name}"):
                yield
        else:
            yield
        self.total[name] += time.perf_counter() - t0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def norm64(a, b=None) -> float:
    """``|a|`` (or ``|a - b|``) accumulated in float64, in chunks."""
    a = a.detach().reshape(-1)
    b = None if b is None else b.detach().reshape(-1)
    total = 0.0
    for lo in range(0, a.numel(), NORM_CHUNK):
        x = a[lo:lo + NORM_CHUNK].double()
        if b is not None:
            x = x - b[lo:lo + NORM_CHUNK].double()
        total += float((x * x).sum())
    return math.sqrt(total)


def first_steps(driver, st, params0_fn) -> Dict:
    """The program's readings of its first :data:`PRE_STEPS` steps."""
    losses = [driver.step(st)]
    opt, leaves = driver.optimizer(st), driver.leaves(st)
    beta1 = opt.param_groups[0]["betas"][0]
    # a leaf the optimizer holds no moment of got no gradient
    grads = {k: norm64(opt.state[p]["exp_avg"]) / (1 - beta1)
             if "exp_avg" in opt.state.get(p, {}) else 0.0
             for k, p in leaves.items()}
    first = changes(leaves, params0_fn)
    for _ in range(PRE_STEPS - 1):
        losses.append(driver.step(st))
    return {"losses": [float(v) for v in losses], "grad_norms": grads,
            "first_change_norms": first,
            "change_norms": changes(leaves, params0_fn)}


def changes(leaves, params0_fn) -> Dict[str, float]:
    """Each leaf's change from its initial value, the initial values drawn
    anew and freed before the next step, so that they add nothing to the
    program's memory peak."""
    params0 = params0_fn()
    return {k: norm64(p, params0[k]) for k, p in leaves.items()}


def window(driver, st, seconds: float, dev) -> Dict:
    """Steps for ``seconds``: the wall from a synchronise before the first
    to the synchronise after the last, and each step's time between the
    CUDA events recorded at the step boundaries (host clock on the CPU)."""
    import torch

    cuda = dev.type == "cuda"
    losses, stamps = [], []
    _sync(dev)
    if cuda:
        stamps.append(torch.cuda.Event(enable_timing=True))
        stamps[0].record()
    t0 = time.perf_counter()
    host = [t0]
    while True:
        losses.append(driver.step(st))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
        else:
            host.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    wall = time.perf_counter() - t0
    if cuda:
        times = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    else:
        times = list(np.diff(host) * 1e3)
    return {"losses": losses, "steps": len(losses), "wall_s": wall,
            "step_times_ms": times}


class Cell:
    """A cell's files and the inputs of one seed: ``entry``, ``config``,
    ``traffic``, the ``driver`` and ``reference`` modules, the benchmark's
    ``inputs`` and :meth:`params0`, its initial parameters (drawn anew at
    each call, the same each time)."""

    def __init__(self, workload: str, seed: int, dev, traffic=None,
                 spec: Optional[dict] = None):
        self.spec = spec or benchmark()
        self.entry, self.config, mix = cell(workload, self.spec)
        self.traffic = traffic or mix
        self.name = self.config["driver"]
        self.driver = importlib.import_module(f"gnnbench.drivers.{self.name}")
        self.reference = importlib.import_module(
            f"gnnbench.reference.{self.name}")
        self.dev = dev
        self.shape = self.driver.shape(self.config, self.traffic)
        self.inputs = self.driver.inputs(self.config, self.traffic, seed, dev)

    def params0(self) -> dict:
        return self.driver.initial_params(self.config, self.traffic,
                                          self.inputs, self.dev)

    def build(self, params0: dict, spans: "Spans"):
        return self.driver.build(self.config, self.traffic, self.inputs,
                                 params0, self.dev, spans)

    def reference_readings(self, dtype=None, tf32: bool = False,
                           batch_hook=None) -> Dict:
        """The plain reference's readings of the first steps (float64 by
        default; the control: float32 with TF32 GEMMs)."""
        import torch

        return self.reference.run(
            self.inputs, self.params0(), self.config["model"],
            self.shape["batch"], PRE_STEPS,
            dtype=dtype or torch.float64, tf32=tf32, device=self.dev,
            batch_hook=batch_hook)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             traffic: Optional[dict] = None,
             spec: Optional[dict] = None) -> Dict:
    """One run of ``workload``; returns the result line's object.
    ``traffic`` replaces the cell's mix (the CPU tests' small graphs),
    ``spec`` the benchmark's entries (``benchmark(held=True)``)."""
    import torch

    from . import trace as tracing

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from msha_gnn_torch.ops.cuda import _build

        _build.BUILD_DIR = BUILD / "msha_gnn_torch"
    log(f"imports done at {time.perf_counter() - t_start:.3f} s")
    c = Cell(workload, seed, dev, traffic, spec)
    driver = c.driver
    p0 = c.params0()
    log(f"inputs at {time.perf_counter() - t_start:.3f} s")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans()
    with spans("build"):
        st = c.build(p0, spans)
    del p0
    setup_spans = dict(spans.total)
    log(f"program built at {time.perf_counter() - t_start:.3f} s")
    got = first_steps(driver, st, c.params0)
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; first losses {got['losses']}")

    win = window(driver, st, seconds, dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    step_ms = win["wall_s"] * 1e3 / win["steps"]
    q = np.percentile(win["step_times_ms"], [5, 50, 95])
    log(f"window {win['wall_s']:.3f} s, {win['steps']} steps, "
        f"{step_ms:.4f} ms a step (p5 / p50 / p95 {q[0]:.3f} / {q[1]:.3f} / "
        f"{q[2]:.3f}), peak {peak} B")

    tr = None
    if trace:
        spans.tracing = True
        path = BUILD / "gnnbench" / "traces" / f"{workload}.json"
        tr = tracing.profile_steps(lambda: driver.step(st),
                                   int(c.config["trace_steps"]), TRACE_WARM,
                                   path, cuda)
        spans.tracing = False
        per_step_ms = tr["kernel_s"] * 1e3 / tr["steps"]
        log(f"trace {path}: {tr['steps']} steps, kernels {per_step_ms:.4f} "
            f"ms a step, busy {tr['busy_s']:.6f} s of {tr['window_s']:.6f} s")
        if per_step_ms > step_ms:
            raise tracing.MeasurementFault(
                f"kernels take {per_step_ms} ms a step, the window's steps "
                f"{step_ms} ms")

    window_losses = torch.stack(win.pop("losses")).float().cpu()
    failed = int((~torch.isfinite(window_losses)).sum())
    del st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = c.reference_readings()
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    nums = compare.numbers(got, ref)
    log(f"numbers {json.dumps(nums)}")
    log(f"program {json.dumps(got)}")
    log(f"reference {json.dumps(ref)}")
    limits = c.config["limits"]
    checks = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    checks["nonfinite_losses"] = {"value": failed, "limit": 0}
    correct = compare.verdict(nums, limits) and failed == 0

    spec = c.spec
    if trace:
        ctx = {"trace": tr, "shape": c.shape, "driver": c.name,
               "device_name": device_name(dev), "step_ms": step_ms,
               "window_steps": win["steps"], "setup_spans": setup_spans}
        metrics = {}
        for m in spec["per_layer"]:
            if applies(m, workload):
                value = load_metric(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"step_ms": step_ms,
               "step_p95_ms": float(np.percentile(win["step_times_ms"], 95)),
               "peak_mem_gib": peak / 2**30,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if applies(m, workload)}

    result = {"correct": bool(correct), "attempted": win["steps"],
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": device_name(dev),
                         "count": int(c.entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def log(msg: str) -> None:
    print(f"[gnnbench] {msg}", file=sys.stderr, flush=True)


def print_checks(result: Dict) -> None:
    """The numbers compared, each beside its limit: the run's last lines
    on standard error."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
