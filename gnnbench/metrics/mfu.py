"""The whole step's share of the card's float32 peak: the operations a
step needs (``counts/<driver>.py``, from the cell's shapes) over the
measured window's step time, against the peak of ``counts.PEAKS``."""

from gnnbench import counts

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "step_ms"
BETTER = "higher"


def read(ctx):
    peak = counts.peaks(ctx["device_name"])
    if peak is None or not ctx["step_ms"]:
        return None
    flops = counts.for_driver(ctx["driver"]).work(ctx["shape"])["flops"]
    return 100.0 * flops / (ctx["step_ms"] * 1e-3) / peak["f32_flops_per_s"]
