"""Device kernels a step, counted in the traced window."""

LAYER = "step dispatch"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["kernels"]:
        return None
    return len(tr["kernels"]) / tr["steps"]
