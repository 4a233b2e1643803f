"""The yardstick's arithmetic: the chip's peaks, the least time of a piece
of work, and (in ``counts/<driver>.py``) the operations and attention
layers of a driver's step, all from shapes and never from the program.

Every input byte is counted read once and every output byte written once,
over the whole graph (never per slice, so that re-slicing cannot move a
bound), and the operations are those the function needs at float32.
"""

from __future__ import annotations

import importlib
from typing import Optional

# Published dense peaks (NVIDIA's H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.  The configurations
# state float32 and the port leaves TF32 off, so the float32 rate is the
# one a step is held to.
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

# Adam's operations a parameter element: the two moment updates (2 + 3),
# the square root, the bias-corrected denominator (2) and the update (2).
ADAM_FLOPS = 10


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of a card by its name (``torch.cuda.get_device_name``),
    None for a card the table lacks."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None


def bound_s(nbytes: float, flops: float, peak: dict):
    """Least seconds of moving ``nbytes`` and doing ``flops`` on a card
    with ``peak``, and which of the two bounds it."""
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    t_ops = flops / peak["f32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def r1l_work(n_src: int, n_dst: int, e: int, d: int, row_bytes: int = 4):
    """``(bytes, flops)`` of the rank-1 GAT forward and backward over one
    graph (``r1l_fwd_f32``, ``r1l_bwd_f32``), each input read once and
    each output written once.  Forward: ptr, col, c, a, x in, out and lse
    out; the aggregation's multiply-add (2 E d) and ``t = x a`` (2 n_dst
    d).  Backward: ptr, col, c, a, x, gout, out, lse in; q and dpre (8 B
    an edge), dc, da out; ``<gout, x>`` and ``da``'s multiply-add a feature
    of an edge (4 E d) and ``t``'s and ``<gout, out>``'s per node (4 n
    d)."""
    ptr = 4 * (n_src + 1)
    fwd = (ptr + 4 * e + 4 * n_src + 4 * d + row_bytes * n_dst * d
           + 4 * n_src * d + 4 * n_src,
           2 * n_dst * d + 2 * e * d)
    bwd = (ptr + 4 * e + 4 * n_src + 4 * d + row_bytes * n_dst * d
           + 2 * 4 * n_src * d + 4 * n_src + 8 * e + 4 * n_src + 4 * d,
           4 * n_src * d + 4 * e * d)
    return {"r1l_fwd": fwd, "r1l_bwd": bwd}


def spmm_work(n_rows: int, e: int, x_rows: int, d: int,
              weighted: bool = True, row_bytes: int = 4):
    """``(bytes, flops)`` of one CSR SpMM: pointer, columns (and weights),
    the ``x_rows`` rows the edges reference read once, ``[n_rows, d]``
    written once; a multiply-add an edge and feature (an add unweighted)."""
    per_edge = 8 if weighted else 4
    nbytes = (4 * (n_rows + 1) + per_edge * e + row_bytes * x_rows * d
              + 4 * n_rows * d)
    return nbytes, (2 if weighted else 1) * e * d


def for_driver(name: str):
    """The module ``counts/<name>.py``: ``work(shape)`` ->
    ``{"flops": per step, "attention_layers": [(n_src, n_dst, e, d)]}``."""
    return importlib.import_module(f"gnnbench.counts.{name}")
