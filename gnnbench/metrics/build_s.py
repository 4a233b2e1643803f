"""Seconds of the program's set-up inside ``setup_s``: the benchmark's
span around the driver's ``build`` (the graph's layout and the operators:
``scale.build_chunked``; ``data.split_edges`` and
``link_prediction.build_link_prediction``), before the first step."""

LAYER = "set-up: training/scale.py, data/ogb.py, training/link_prediction.py"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(ctx):
    return ctx["setup_spans"].get("build")
