"""Run one cell of ``BENCHMARK.json`` once:

    python -m gnnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the numbers compared for ``correct`` are the
last lines of standard error.  Without a CUDA card, with fewer cards than
the cell asks for, without the port, or with JAX or the JAX package
loaded once the window has closed, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gnnbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gnnbench import harness

    harness.prepare_env()
    import torch

    entry, _, _ = harness.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        harness.log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
                    f"{torch.cuda.device_count()} available")
        return 2
    port = importlib.util.find_spec("msha_gnn_torch")
    if port is None or not Path(port.origin).resolve().is_relative_to(
            harness.ROOT):
        harness.log("msha_gnn_torch is not in this checkout")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules loaded that the benchmark forbids: {found}")
        return 3
    print(json.dumps(result), flush=True)
    harness.print_checks(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
