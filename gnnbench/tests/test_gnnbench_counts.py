"""The yardstick's operation and byte counts against hand counts (CPU)."""

import pytest

from gnnbench import counts

H100 = counts.PEAKS["H100"]


def test_peaks_by_card_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3") is H100
    assert counts.peaks("cpu") is None


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert counts.bound_s(3.35e12, 1.0, H100) == (1.0, "bytes")
    assert counts.bound_s(1.0, 67e12 * 2, H100) == (2.0, "operations")


def test_r1l_work_by_hand():
    # n = 2 nodes, e = 3 edges, d = 4: forward reads ptr (3 ints), col (3),
    # c (2), a (4), x (2 x 4), writes out (2 x 4) and lse (2)
    fwd, bwd = (counts.r1l_work(2, 2, 3, 4)[k] for k in ("r1l_fwd",
                                                           "r1l_bwd"))
    assert fwd == (4 * (3 + 3 + 2 + 4 + 8 + 8 + 2), 2 * 2 * 4 + 2 * 3 * 4)
    # backward reads ptr, col, c, a, x, gout, out, lse; writes q and dpre
    # (2 floats an edge), dc (2) and da (4)
    assert bwd == (4 * (3 + 3 + 2 + 4 + 8 + 8 + 8 + 2) + 8 * 3 + 4 * 2
                   + 4 * 4, 4 * 2 * 4 + 4 * 3 * 4)


def test_r1l_bwd_bound_at_50m_edges():
    nbytes, flops = counts.r1l_work(2_000_000, 2_000_000, 50_000_000,
                                    32)["r1l_bwd"]
    t, what = counts.bound_s(nbytes, flops, H100)
    assert what == "bytes"
    assert t == pytest.approx(4.1791e-4, rel=1e-4)


def test_spmm_work_by_hand():
    assert counts.spmm_work(2, 3, 2, 4) == (
        4 * 3 + 8 * 3 + 4 * 2 * 4 + 4 * 2 * 4, 2 * 3 * 4)
    assert counts.spmm_work(2, 3, 2, 4, weighted=False)[1] == 3 * 4


def test_scale_flops_by_hand():
    n, e, d, b = 10, 40, 4, 6
    work = counts.for_driver("scale_chunked").work(
        {"nodes": n, "edges": e, "d": d, "batch": b})
    gemms = 3 * (2 * n * d * d)                  # h = feat W, dW, dfeat
    terms = 2 * n * d * 2 + 2 * n * d * 2 + 2 * n * d * 2   # c, t; dh; da
    attention = 2 * e * d + 4 * e * d
    scores = 2 * (2 * b * d) * 3                # pos and neg, fwd + bwd
    adam = 10 * (n * d + d * d + 2 * d)
    assert work["flops"] == gemms + terms + attention + scores + adam
    assert work["attention_layers"] == [(n, n, e, d)]


def test_linkpred_flops_by_hand():
    n, e, h, b = 10, 40, 4, 6
    work = counts.for_driver("linkpred_full").work(
        {"nodes": n, "edges": e, "hidden": h, "heads": 2,
         "predictor_layers": 2, "batch": b})
    head = 3 * 2 * n * h * h + 3 * 4 * n * h + 6 * e * h
    out = 3 * 2 * n * 2 * h * h + 3 * 4 * n * h + 6 * e * h
    pairs = 2 * (3 * b * h + 3 * 2 * b * h * h + 3 * 2 * b * h)
    params = n * h + 2 * (h * h + 2 * h) + (2 * h * h + 2 * h) \
        + (h * h + h) + (h + 1)
    assert work["flops"] == 2 * head + out + pairs + 10 * params
    assert work["attention_layers"] == [(n, n, e, h)] * 3
