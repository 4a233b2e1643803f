"""The port's spans (``msha_gnn_torch/utils/prof.py``), the spans of the
out-of-core step (``training/scale.py``, ``ops/chunked_rank1.py``) and the
benchmark's metrics that read them (``gnnbench/metrics/``).

This file imports nothing of JAX, so the card's machine runs its card test
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_prof.py

Everything else runs on the CPU.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnnbench import harness
from msha_gnn_torch.training import scale
from msha_gnn_torch.utils import prof

METRICS = ("batch_copy_ms", "batch_draw_ms", "attn_fwd_ms", "attn_bwd_ms",
           "attn_dx_ms")


@pytest.fixture(autouse=True)
def fresh_registry():
    prof.reset()
    prof._seen.clear()
    yield
    prof.reset()
    prof._seen.clear()


def annotations(p, tmp_path):
    """The ``user_annotation`` events of an exported trace, ``(name, start,
    end)`` in microseconds."""
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def refuse(*args, **kwargs):
    raise AssertionError("called with no profiler running")


@pytest.mark.parametrize("device", [None, torch.device("cpu"),
                                    torch.device("cuda", 0)])
def test_a_span_with_no_profiler_adds_host_time_alone(monkeypatch, device):
    """No annotation; CUDA events on a CUDA device alone; the first call
    set aside."""
    cuda = device is not None and device.type == "cuda"
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent if cuda else refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    for _ in range(4):
        with prof.span("a", device):
            sum(range(1000))
    assert prof.calls("a") == 3
    assert prof.host_seconds("a") > 0
    assert prof.device_calls("a") == (3 if cuda else None)
    assert prof.device_ms("a") == (pytest.approx(1.5) if cuda else None)
    assert prof.calls("b") is None and prof.host_seconds("b") is None


def test_nested_spans_are_annotations_of_the_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(2):
            with prof.span("outer"):
                for _ in range(3):
                    with prof.span("outer.inner"):
                        torch.ones(64).sum()
    got = annotations(p, tmp_path)
    outer = [a for a in got if a[0] == "outer"]
    inner = [a for a in got if a[0] == "outer.inner"]
    assert len(outer) == 2 and len(inner) == 6
    for _, lo, hi in inner:
        assert sum(o[1] <= lo and hi <= o[2] for o in outer) == 1
    for _, lo, hi in outer:
        assert sum(lo <= i[1] and i[2] <= hi for i in inner) == 3
    # a profiled span is the trace's alone
    assert (prof.calls("outer"), prof.calls("outer.inner")) == (None, None)
    for _ in range(3):
        with prof.span("outer"):
            with prof.span("outer.inner"):
                pass
    assert (prof.calls("outer"), prof.calls("outer.inner")) == (2, 2)
    assert prof.host_seconds("outer") >= prof.host_seconds("outer.inner")
    # the CPU records no device events
    assert prof.device_calls("outer") is None


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with prof.span("twice.bwd"):
            _Twice.threads.append(threading.get_ident())
            return 2 * g


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_inside_an_autograd_backward(tmp_path, profiled):
    _Twice.threads = []
    x = torch.ones(8, requires_grad=True)
    _Twice.apply(x).sum().backward()   # the first call, set aside
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            _Twice.apply(x).sum().backward()
        assert [a[0] for a in annotations(p, tmp_path)].count(
            "twice.bwd") == 1
    else:
        _Twice.apply(x).sum().backward()
    assert len(_Twice.threads) == 2
    assert prof.calls("twice.bwd") == (None if profiled else 1)
    assert torch.equal(x.grad, torch.full((8,), 4.0))


def test_spans_from_many_threads_lose_no_call():
    """More threads than cores, switching often: a lost update of the
    registry would lose calls."""
    threads, each = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with prof.span("shared"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert prof.calls("shared") == threads * each - 1


class FakeEvent:
    """A CUDA event of a device whose work is done once recorded (or, with
    ``lagging``, once waited for): 0.5 ms from each start to its end."""

    lagging = False

    def __init__(self, enable_timing=False):
        self.done = False

    def record(self, stream=None):
        self.done = not FakeEvent.lagging

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done   # and so the start, recorded before it
        return 0.5


@pytest.mark.parametrize("lagging", [False, True])
def test_device_spans_fold_their_events_past_a_bound(monkeypatch, lagging):
    """Pairs the device has completed are folded past the bound; a device
    that lags keeps them all until a reader waits."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(FakeEvent, "lagging", lagging)
    monkeypatch.setattr(prof, "FOLD_AT", 8)
    cuda = torch.device("cuda", 0)
    for i in range(31):
        with prof.span("dev", cuda):
            pass
        assert len(prof._pending) == (i if lagging else min(i, 8))
    with prof.span("host alone"):
        pass
    assert prof.device_calls("dev") == 30
    assert prof.device_ms("dev") == pytest.approx(15.0)
    assert prof.device_calls("host alone") is None
    assert prof.calls("dev") == 30 and not prof._pending


def test_reset_forgets_every_span(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    for _ in range(2):
        with prof.span("x", torch.device("cuda", 0)):
            pass
    assert prof.calls("x") == 1 and prof.device_calls("x") == 1
    prof.reset()
    assert prof.calls("x") is None and prof.host_seconds("x") is None
    assert prof.device_ms("x") is None and prof.device_calls("x") is None
    # the name stays seen: its next call counts
    with prof.span("x", torch.device("cuda", 0)):
        pass
    assert prof.calls("x") == 1 and prof.device_calls("x") == 1


N, E, SLICES = 120, 900, 3
CFG = scale.ScaleConfig(d=8, batch_edges=64, seed=3)


def scale_step(rng, loss_fn, params, s, r):
    batch = scale.draw_batch(rng, s, r, N, CFG.batch_edges, "cpu")
    loss_fn(params, *batch).backward()


def test_one_out_of_core_step_records_each_span(tmp_path):
    rng = np.random.default_rng(0)
    loss_fn, s, r, k = scale.build_chunked(
        rng.integers(0, N, E), rng.integers(0, N, E), N, CFG,
        num_slices=SLICES, device="cpu")
    assert k == SLICES
    params = {key: v.requires_grad_() for key, v in scale._init_params(
        torch.Generator().manual_seed(0), N, CFG.d).items()}
    scale_step(rng, loss_fn, params, s, r)   # the first calls, set aside
    prof.reset()
    scale_step(rng, loss_fn, params, s, r)
    want = {"msha.scale.batch": 1, "msha.scale.batch.copy": 1,
            "msha.r1gat.fwd": 1, "msha.r1gat.bwd": 1,
            "msha.r1gat.bwd.dx": SLICES}
    assert {name: prof.calls(name) for name in want} == want
    with profile(activities=[ProfilerActivity.CPU]) as p:
        scale_step(rng, loss_fn, params, s, r)
    assert {name: prof.calls(name) for name in want} == want
    names = [a[0] for a in annotations(p, tmp_path)]
    assert {name: names.count(name) for name in want} == want
    assert prof.host_seconds("msha.scale.batch") >= \
        prof.host_seconds("msha.scale.batch.copy")
    # the CPU times no device work: the four device metrics read nothing
    ctx = {"trace": None}
    got = {m: harness.load_metric(m).read(ctx) for m in METRICS}
    assert got["batch_draw_ms"] > 0
    assert [got[m] for m in METRICS if m != "batch_draw_ms"] == [None] * 4


def fill(host, device):
    for name, (seconds, calls) in host.items():
        prof._host[name] = [seconds, calls]
    for name, (ms, calls) in device.items():
        prof._device[name] = [ms, calls]


@pytest.mark.parametrize("metric,want", [
    ("batch_copy_ms", 1.2 / 4),
    ("batch_draw_ms", (0.048 - 0.040) * 1e3 / 4),
    ("attn_fwd_ms", 12.0 / 4),
    ("attn_bwd_ms", 160.0 / 4),
    ("attn_dx_ms", 94.0 / 47 * 12),
])
def test_a_metric_reads_the_registry(metric, want):
    """Four steps after the first, 12 slices (the first step's later 11
    passes counted); an empty registry reads nothing, and so does a port
    without spans."""
    module = harness.load_metric(metric)
    assert module.read({"trace": None}) is None
    fill({"msha.scale.batch": (0.048, 4), "msha.scale.batch.copy": (0.040, 4),
          "msha.r1gat.fwd": (0.002, 4), "msha.r1gat.bwd": (0.03, 4),
          "msha.r1gat.bwd.dx": (0.02, 59)},
         {"msha.scale.batch.copy": (1.2, 4), "msha.r1gat.fwd": (12.0, 4),
          "msha.r1gat.bwd": (160.0, 4), "msha.r1gat.bwd.dx": (94.0, 47)})
    assert module.read({"trace": None}) == pytest.approx(want)


@pytest.mark.parametrize("metric", METRICS)
def test_a_metric_reads_nothing_from_a_port_without_spans(monkeypatch,
                                                          metric):
    fill({"msha.scale.batch": (0.048, 4), "msha.scale.batch.copy": (0.04, 4)},
         {"msha.r1gat.bwd": (80.0, 2), "msha.r1gat.bwd.dx": (56.0, 24),
          "msha.r1gat.fwd": (6.0, 2)})
    for name in ("host_seconds", "calls", "device_ms", "device_calls"):
        monkeypatch.delattr(prof, name)
    assert harness.load_metric(metric).read({"trace": None}) is None


class _CardTwice(torch.autograd.Function):
    """``2 a @ b`` whose backward runs a product in a device span, on the
    autograd engine's device thread, between two CUDA events of its own
    (``pairs``)."""

    pairs = []

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(b)
        return 2 * (a @ b)

    @staticmethod
    def backward(ctx, g):
        (b,) = ctx.saved_tensors
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        with prof.span("card.bwd", g.device):
            da = 2 * (g @ b.T)
        pair[1].record()
        _CardTwice.pairs.append(pair)
        return da, None


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["forward", "backward"])
def test_device_ms_of_a_span_is_its_cuda_event_time(where):
    """A span around a 4096^3 product (a few ms) against CUDA events
    recorded just outside it on the same thread: the caller's, or the
    autograd engine's.  Profiled calls add nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.rand(4096, 4096, device=dev, generator=gen)
            for _ in range(2))
    a.requires_grad_(where == "backward")
    name = "card.fwd" if where == "forward" else "card.bwd"

    def work():
        if where == "backward":
            _CardTwice.apply(a, b).sum().backward()
            return
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        with prof.span(name, dev):
            a @ b
        pair[1].record()
        _CardTwice.pairs.append(pair)

    work()   # the first call, set aside
    with profile(activities=[ProfilerActivity.CUDA]):
        work()
    torch.cuda.synchronize()
    assert prof.device_calls(name) is None
    _CardTwice.pairs = []
    for _ in range(5):
        work()
    torch.cuda.synchronize()
    assert prof.device_calls(name) == len(_CardTwice.pairs) == 5
    outside = sum(s.elapsed_time(e) for s, e in _CardTwice.pairs)
    assert prof.device_ms(name) == pytest.approx(outside, rel=0.10)
