"""``r1l_bwd_f32``'s share of its roofline: the least time of the work
that a step's launches need (every attention layer's whole graph, its
inputs read once and outputs written once, ``counts.r1l_work``) over the
device time a step of the kernels it launches (``r1l_bwd_kernel`` and
``r1l_bwd_fixup_kernel``)."""

import re

from gnnbench import counts

LAYER = "kernels: csrc/rank1_gat.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "step_ms"
BETTER = "higher"

KERNEL = re.compile(r"\br1l_bwd_(fixup_)?kernel\b")


def read(ctx):
    tr, peak = ctx["trace"], counts.peaks(ctx["device_name"])
    if not tr or peak is None:
        return None
    spent = sum(s for name, s in tr["kernels"] if KERNEL.search(name))
    if spent <= 0:
        return None
    layers = counts.for_driver(ctx["driver"]).work(ctx["shape"])[
        "attention_layers"]
    least = sum(counts.bound_s(*counts.r1l_work(*layer)["r1l_bwd"], peak)[0]
                for layer in layers)
    return 100.0 * least / (spent / tr["steps"])
