"""Host milliseconds a step in the port's batch draw: the benchmark's span
around ``scale.draw_batch`` (every step) or ``link_prediction.epoch_batches``
(once an epoch) in the host-and-device trace, less the CUDA calls inside
it, over the traced steps.  ``draw_batch``'s copy from pageable memory
waits in ``cudaMemcpyAsync`` for the device's earlier work; without that
call the span is the host's own work (the draws, the indexing, the
tensors), as the profiler stretches it."""

LAYER = "loop: training/scale.py, training/link_prediction.py"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "step_ms"
BETTER = "lower"


def read(ctx):
    tr = ctx["trace"]
    if not tr or "batch" not in tr.get("host_spans", {}):
        return None
    return tr["host_spans"]["batch"] * 1e3 / tr["steps"]
