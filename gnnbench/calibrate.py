"""The readings that the limits of ``correct`` are set from, for seeds
given, in one process:

    python -m gnnbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--variants program,control,half_batch] [--out F] [--held]

For each seed: the program's first steps against the float64 reference
(the lower readings), the control (the reference in float32 with TF32
GEMMs, put in the program's place) and the fault of half the batch left
out (the reference given the first half of each batch, the mean taken
over it); with ``--variants ...,stale_dropout``, link prediction's fault
of a dropout generator that does not advance between steps (planted in
the program).  A state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run.  One JSON line a seed and variant.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from . import compare, harness


def half_batch(batch):
    """The first half of each of a batch's index sets."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(v[: len(v) // 2] for v in batch)
    return batch[..., : batch.shape[-1] // 2]


@contextlib.contextmanager
def stale_dropout():
    """Link prediction's dropout generator set back, before every step, to
    where it stood before the first: each step draws the first step's
    masks and seeds (a fault of the program, planted in it)."""
    from msha_gnn_torch.training import link_prediction as lp

    step, first = lp.train_step, {}

    def stale(run, batch, graph=None):
        gen = run.generator
        gen.set_state(first.setdefault(id(gen), gen.get_state()))
        return step(run, batch, graph)

    lp.train_step = stale
    try:
        yield
    finally:
        lp.train_step = step


PROGRAM_FAULTS = {"stale_dropout": stale_dropout}


def program_readings(c, fault=None):
    """The program's readings of its first steps, with ``fault`` (a key of
    :data:`PROGRAM_FAULTS`) planted."""
    import torch

    with PROGRAM_FAULTS[fault]() if fault else contextlib.nullcontext():
        st = c.build(c.params0(), harness.Spans())
        got = harness.first_steps(c.driver, st, c.params0)
    del st
    gc.collect()
    if c.dev.type == "cuda":
        torch.cuda.empty_cache()
    return got


def readings(workload: str, seed: int, dev, traffic=None, *,
             variants=("program", "control", "half_batch"), spec=None):
    """``{variant: numbers}`` of one seed."""
    import torch

    c = harness.Cell(workload, seed, dev, traffic, spec)
    got, times = {}, {}
    for v in variants:
        if v == "program" or v in PROGRAM_FAULTS:
            t0 = time.perf_counter()
            got[v] = program_readings(c, None if v == "program" else v)
            times[v] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = c.reference_readings()
    times["reference"] = time.perf_counter() - t0
    out = {v: compare.numbers(g, ref) for v, g in got.items()}
    if "control" in variants:
        out["control"] = compare.numbers(
            c.reference_readings(dtype=torch.float32, tf32=True), ref)
    if "half_batch" in variants:
        out["half_batch"] = compare.numbers(
            c.reference_readings(batch_hook=half_batch), ref)
    return out, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gnnbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control,half_batch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--held", action="store_true",
                    help="also the cells held out of BENCHMARK.json")
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch

    if not torch.cuda.is_available():
        harness.log("calibration needs a CUDA card")
        return 2
    from msha_gnn_torch.ops.cuda import _build

    _build.BUILD_DIR = harness.BUILD / "msha_gnn_torch"
    dev = torch.device("cuda")
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(open(args.out, "a")) if args.out else None
        for seed in (int(s) for s in args.seeds.split(",")):
            nums, times = readings(args.workload, seed, dev,
                                   variants=tuple(args.variants.split(",")),
                                   spec=harness.benchmark(args.held))
            for variant, v in nums.items():
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "variant": variant, **v,
                                   "seconds": times})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
