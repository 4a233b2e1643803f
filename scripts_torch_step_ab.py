"""The step walls of the paths that run ``csr_spmm_f32`` in their steps,
for two trees side by side on one CUDA card.

    python3 scripts_torch_step_ab.py BASE_ROOT [--steps 40] \
        [--scale-steps 12] [--rounds 1] [--in-process-rounds 6]

``BASE_ROOT`` is another checkout's root (for example the parent commit's,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each tree's ``msha_gnn_torch`` runs in a process of its own,
builds every kernel under its own root before any timing, and the
processes run in the order base, this, this, base, ``--rounds`` times
over.  Each process times, every step ended by a synchronise, the median
step wall after warm-up of:

* the GCN flow-training step (``make_train_step`` of ``gcn_task`` at
  nfeat 128, ``TrainConfig()``'s batch of 64, on a synthetic flow graph of
  the 2015 data's shape: 39,179 sources, 32 recipients, 233,887 records):
  ``--steps`` timed after 5;
* the linkpred training step (``train_step`` at ``LinkPredConfig()``,
  synthetic ogbl-ddi seed 42) for ``impl`` fused, materialised and flash:
  ``--steps`` timed after 5, over as many epochs as that takes;
* the out-of-core step (``train_chunked`` at ``ScaleConfig()`` on
  ``build_edges`` of 2,000,000 nodes and 50,000,000 edges, seed 0), fused
  and materialised float32: ``--scale-steps`` steps, the median of steps
  2 to the last.

In a tree whose ``SpmmOperator`` launches through the operator
``torch.ops.msha_gnn_torch.csr_spmm``, each process then times the GCN
and linkpred steps again in ``--in-process-rounds`` rounds that alternate
the operator with the wrapper ``csr_spmm`` called directly (the order
swapped each round), which holds the operator's host cost apart from the
spread between processes.

Prints the card's name and power limit first, each process's JSON line
as it ends, and one JSON summary last: per reading, each tree's medians
in the order they ran, and this tree's in-process medians of each way.
Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the flow graph of the 2015 data's shape (scripts_torch_profile.py)
FLOW = (39179, 32, 291, 32, 233887)
SCALE_NODES, SCALE_EDGES = 2_000_000, 50_000_000
WARMUP = 5


def build_edges(n_nodes: int, n_edges: int, seed: int = 0):
    """``chip_smoke.py::build_edges``: sorted uniform senders, receivers
    drawn with p ~ k^-1.5."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n_nodes, n_edges).astype(np.int32))
    p = 1.0 / np.arange(1, n_nodes + 1) ** 1.5
    cdf = np.cumsum(p / p.sum())
    dst = np.minimum(
        np.searchsorted(cdf, rng.random(n_edges)), n_nodes - 1
    ).astype(np.int32)
    return src, dst


def timed(step, n):
    """Median wall in ms of ``n`` calls of ``step(i)`` after ``WARMUP``."""
    import torch

    times = []
    for i in range(WARMUP + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[WARMUP:]) * 1e3


def worker(root: str, steps: int, scale_steps: int, rounds: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from msha_gnn_torch.data import load_ddi, split_edges, synthetic_flow
    from msha_gnn_torch.ops.cuda import _build, spmm
    from msha_gnn_torch.training import (LinkPredConfig, TrainState,
                                         build_link_prediction, gcn_task,
                                         make_train_step, scale, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches
    from msha_gnn_torch.utils import TrainConfig

    if not spmm.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"{spmm.__file__} is not under {root}")
    _build.build()  # every kernel, in parallel, before any timing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"root": root,
           "through_operator": hasattr(spmm, "csr_spmm_op")}

    fg = synthetic_flow(*FLOW, seed=0)
    task, model = gcn_task(fg, nfeat=128, seed=0, device="cuda")
    state = TrainState.create(model, task.optimizer)
    step = make_train_step(task)
    rng = np.random.default_rng(0)
    b = TrainConfig().batch_size
    batches = [(torch.from_numpy(rng.integers(0, fg.n_src, b)).cuda(),
                torch.from_numpy(rng.integers(0, fg.n_dst, b)).cuda(),
                torch.ones(b, device="cuda"))
               for _ in range(WARMUP + steps)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = {"gcn step": lambda i: step(state, *batches[i], gen)}

    split = split_edges(load_ddi(seed=42), seed=42)
    for impl in ("fused", "materialised", "flash"):
        run = build_link_prediction(
            split, LinkPredConfig(impl="auto" if impl == "fused" else impl),
            device="cuda")
        lp = []
        while len(lp) < WARMUP + steps:
            lp.extend(epoch_batches(run))
        paths[f"linkpred {impl} step"] = (
            lambda i, run=run, lp=lp: train_step(run, lp[i]))
    for name, fn in paths.items():
        out[name] = timed(fn, steps)
    if out["through_operator"]:
        # the same steps with SpmmOperator launching through the operator
        # and through the wrapper directly, alternating in this process
        op = spmm.csr_spmm_op
        out["in process"] = {name: {"operator": [], "direct": []}
                             for name in paths}
        for r in range(rounds):
            for way in (("operator", "direct"), ("direct", "operator"))[r % 2]:
                spmm.csr_spmm_op = op if way == "operator" else spmm.csr_spmm
                for name, fn in paths.items():
                    out["in process"][name][way].append(timed(fn, steps))
        spmm.csr_spmm_op = op
    del paths

    src, dst = build_edges(SCALE_NODES, SCALE_EDGES, seed=0)
    for label, fused in (("fused", True), ("materialised", False)):
        walls = []
        scale.train_chunked(
            src, dst, SCALE_NODES, scale.ScaleConfig(steps=scale_steps),
            fused=fused, device="cuda",
            log=lambda ev: "event" in ev or walls.append(ev["seconds"]))
        out[f"out-of-core {label} f32 step"] = statistics.median(
            walls[2:]) * 1e3
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_root")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--scale-steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--in-process-rounds", type=int, default=6)
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scripts_torch_step_ab: CUDA is not available",
              file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.base_root, args.steps,
                                args.scale_steps, args.in_process_rounds)),
              flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    this = os.path.dirname(os.path.abspath(__file__))
    base = os.path.abspath(args.base_root)
    runs = {"base": [], "this": []}
    order = (("base", base), ("this", this), ("this", this), ("base", base))
    for name, root in order * args.rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--worker",
             "--steps", str(args.steps), "--scale-steps",
             str(args.scale_steps), "--in-process-rounds",
             str(args.in_process_rounds)],
            cwd=root, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: {json.dumps(line)}", flush=True)
        runs[name].append(line)
    keys = [k for k in runs["this"][0] if k.endswith("step")]
    summary = {k: {name: [r[k] for r in rs] for name, rs in runs.items()}
               for k in keys}
    for k in runs["this"][0]["in process"]:
        for way in ("operator", "direct"):
            summary[k][f"this, {way}, in process"] = [
                statistics.median(r["in process"][k][way])
                for r in runs["this"]]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
