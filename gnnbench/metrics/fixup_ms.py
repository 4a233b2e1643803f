"""Device milliseconds a step in ``runs::fixup_kernel<...>``
(``csrc/runs.cuh``): the grids that add up the rows crossing edge runs,
the hub rows' among them."""

LAYER = "kernels: csrc/runs.cuh"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    spent = sum(s for name, s in tr["kernels"] if "runs::fixup_kernel" in name)
    if spent <= 0:
        return None
    return spent * 1e3 / tr["steps"]
