"""Whole runs of the cell and of the cell held out of ``BENCHMARK.json``
on the CPU at small sizes (the look for a card skipped, the port's plain
kernel versions underneath): sound runs
come out correct, and runs with the timed path broken underneath come out
not correct; the trace's reading and the metric readers on a made-up
trace."""

import time

import pytest
import torch

from gnnbench import harness, trace
from gnnbench.calibrate import half_batch, stale_dropout

SMALL = {
    "scale-hub50m": {"nodes": 400, "edges": 4000,
                     "senders": {"law": "uniform", "order": "sorted"},
                     "receivers": {"law": "power", "alpha": 1.5},
                     "batch_edges": 128},
    "ddi-full": {"nodes": 120, "pairs": 1500,
                 "senders": {"law": "power", "alpha": 0.5},
                 "receivers": {"law": "power", "alpha": 0.5},
                 "split": [1200, 150, 150], "batch_size": 128},
}
CELLS = sorted(SMALL)


def run(workload, seed=11, trace_on=False, seconds=0.3, **traffic):
    return harness.run_cell(workload, seed, seconds, trace_on,
                            t_start=time.perf_counter(), device="cpu",
                            traffic=dict(SMALL[workload], **traffic),
                            spec=harness.benchmark(held=True))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    timed = {"step_ms", "step_p95_ms"} if workload == "scale-hub50m" \
        else set()
    assert set(res["metrics"]) == {"peak_mem_gib", "setup_s"} | timed
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_the_host_metrics(workload):
    # ddi: epochs of 4 steps, so that the window holds a batch draw
    extra = {"batch_size": 300} if workload == "ddi-full" else {}
    res = run(workload, seed=12, trace_on=True, seconds=1.0, **extra)
    assert res["correct"] is True
    assert res["metrics"]["build_s"]["value"] > 0
    if workload == "scale-hub50m":
        assert res["metrics"]["host_batch_ms"]["value"] > 0
    assert "breakdown" in res and "window_s" in res["device"]


def unchanged_state(monkeypatch, workload):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_of_the_batch(monkeypatch, workload):
    from msha_gnn_torch.training import link_prediction, scale

    if workload == "scale-hub50m":
        draw = scale.draw_batch
        monkeypatch.setattr(scale, "draw_batch",
                            lambda *a, **k: half_batch(draw(*a, **k)))
    else:
        step = link_prediction.train_step
        monkeypatch.setattr(link_prediction, "train_step",
                            lambda run, b, g=None: step(run, half_batch(b),
                                                        g))


def loss_altered(monkeypatch, workload):
    from msha_gnn_torch.training import link_prediction, scale

    if workload == "scale-hub50m":
        make = scale._make_loss

        def altered(*a, **k):
            fn = make(*a, **k)
            return lambda *b: fn(*b) * 1.001
        monkeypatch.setattr(scale, "_make_loss", altered)
    else:
        parts = link_prediction.linkpred_loss_parts

        def altered(*a, **k):
            total, p = parts(*a, **k)
            return total * 1.001, p
        monkeypatch.setattr(link_prediction, "linkpred_loss_parts", altered)


@pytest.mark.parametrize("fault", [unchanged_state, half_of_the_batch,
                                   loss_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    res = run(workload)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("seed", [11, 12])
def test_dropout_that_does_not_advance_is_not_correct(seed):
    """Step 1 is as sound; steps 2 and 3 draw step 1's masks again, which
    only ``loss_gap`` sees."""
    with stale_dropout():
        res = run("ddi-full", seed=seed)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["loss_gap"]["value"] > \
        res["checks"]["loss_gap"]["limit"]
    assert res["checks"]["first_change_gap"]["value"] <= \
        res["checks"]["first_change_gap"]["limit"]


def made_up_trace():
    """A 2-step window 0..1000 us: kernels at 100-300 (r1l_bwd_kernel),
    250-400 (runs::fixup_kernel<1>), a copy at 600-700; the host runs
    aten::index_select over 400-600 and a batch draw over 700-1000, which
    waits in a copy over 710-760."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return {"traceEvents": [
        x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
        x("void r1l_bwd_kernel<32>(int const*)", "kernel", 100.0, 200.0),
        x("void runs::fixup_kernel<1>(int const*)", "kernel", 250.0, 150.0),
        x("Memcpy HtoD", "gpu_memcpy", 600.0, 100.0),
        x("aten::index_select", "cpu_op", 400.0, 200.0),
        x("gnnbench.batch", "user_annotation", 700.0, 300.0),
        x("cudaMemcpyAsync", "cuda_runtime", 710.0, 50.0),
        x("outside", "kernel", 2000.0, 10.0),
    ]}


def test_summarize_a_made_up_trace():
    tr = trace.summarize(made_up_trace(), 2)
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx(400e-6)       # 100-400, 600-700
    assert len(tr["kernels"]) == 2
    gaps = dict(tr["idle_gaps"])
    assert gaps["aten::index_select"] == pytest.approx(200e-6)
    assert gaps["gnnbench.batch"] == pytest.approx(300e-6)
    assert gaps["none"] == pytest.approx(100e-6)          # 0-100
    assert tr["device_ops"][0][0].startswith("r1l_bwd_kernel")


def test_summarize_a_device_only_trace_against_its_wall():
    events = [e for e in made_up_trace()["traceEvents"]
              if e["cat"] != "user_annotation" and e["name"] != "outside"]
    tr = trace.summarize({"traceEvents": events}, 2, window_s=1e-3)
    # the window starts at the first device operation (100 us)
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx(400e-6)
    assert tr["kernel_s"] == pytest.approx(350e-6)


def test_a_trace_with_more_kernel_time_than_wall_is_refused():
    bad = made_up_trace()
    bad["traceEvents"].append({"ph": "X", "name": "k", "cat": "kernel",
                               "ts": 10.0, "dur": 900.0})
    with pytest.raises(trace.MeasurementFault):
        trace.summarize(bad, 2)


def test_metric_readers_on_the_made_up_trace():
    tr = trace.summarize(made_up_trace(), 2)
    shape = {"nodes": 2_000_000, "edges": 50_000_000, "d": 32, "batch": 8192}
    ctx = {"trace": tr, "shape": shape, "driver": "scale_chunked",
           "device_name": "NVIDIA H100 80GB HBM3", "step_ms": 50.0,
           "window_steps": 400, "setup_spans": {"build": 3.5}}
    read = {m: harness.load_metric(m).read(ctx) for m in (
        "launches_per_step", "fixup_ms", "device_idle_share",
        "host_batch_ms", "mfu", "r1l_bwd_roofline", "build_s")}
    assert read["build_s"] == 3.5
    assert read["launches_per_step"] == 1.0
    assert read["fixup_ms"] == pytest.approx(0.075)
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 0.2 / 50))
    # the draw's 300 us less the 50 us copy, over 2 steps
    assert tr["host_spans"] == {"batch": pytest.approx(250e-6)}
    assert read["host_batch_ms"] == pytest.approx(0.125)
    assert read["mfu"] == pytest.approx(
        100 * 23.299156608e9 / 0.05 / 67e12)
    # 0.4179 ms of least time against 0.1 ms a step: the made-up kernel is
    # faster than the bound, which a real trace cannot be
    assert read["r1l_bwd_roofline"] == pytest.approx(417.91, rel=1e-4)
    ctx["device_name"] = "cpu"
    ctx["trace"] = None
    assert all(harness.load_metric(m).read(ctx) is None for m in (
        "launches_per_step", "fixup_ms", "device_idle_share", "mfu",
        "r1l_bwd_roofline", "host_batch_ms"))
