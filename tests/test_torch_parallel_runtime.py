"""The port's process-group runtime, mesh and placements, the resumable
fit and restarts (``tests/test_runtime.py:19-129`` with the port's
checkpoints), the device health check and ``bench --which scaling``, on
the CPU at world size 1.  The sharded operators at world size 1 over NCCL
on a card: ``tests/test_torch_cuda_kernels.py``."""

import json
import socket
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from msha_gnn_torch import bench, cli
from msha_gnn_torch.parallel import (Mesh, data_sharded, device_health_check,
                                     fault_tolerant_fit, initialize,
                                     make_mesh, replicated,
                                     run_with_restarts, shutdown,
                                     state_shardings)
from msha_gnn_torch.parallel import runtime
from msha_gnn_torch.training import Trainer, TrainState, msha_task
from tests.torch_parallel_workers import port_flow


@pytest.fixture
def group():
    """A world of one on the CPU, destroyed after the test."""
    yield initialize(device="cpu")
    shutdown()


def test_initialize_single_process(group):
    assert group == (0, 1)
    assert dist.get_backend() == "gloo"
    mesh = make_mesh()
    assert (mesh.rank, mesh.world) == (0, 1)
    assert mesh.device == torch.device("cpu")
    # a second call keeps the group
    assert initialize(device="cpu") == (0, 1)
    with pytest.raises(ValueError, match="one rank a device"):
        make_mesh(2)
    shutdown()
    assert not dist.is_initialized()


def test_initialize_reads_torchrun_variables(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(key, value)
    try:
        assert initialize(device="cpu") == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        shutdown()


def test_no_fallback_from_the_card():
    """Asked for CUDA without a card, the runtime raises: no group on the
    CPU stands in for it."""
    if torch.cuda.is_available():
        pytest.skip("the case of a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize(device="cuda")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 3), (3, 2), (1, 0)])
def test_placements(world, rank):
    mesh = Mesh(group=None, rank=rank, world=world,
                device=torch.device("cpu"))
    t = torch.arange(7 * 6).reshape(7, 6)
    blk = -(-7 // world)
    rows = slice(min(rank * blk, 7), min((rank + 1) * blk, 7))
    assert torch.equal(replicated(mesh).local(t), t)
    assert torch.equal(data_sharded(mesh, 2).local(t), t[rows])
    assert torch.equal(data_sharded(mesh).local(t[:, 0]), t[rows, 0])
    assert mesh.block(7) == (rows.start, rows.stop, blk)


def _tiny_msha(**kw):
    from tests.test_torch_gcn import flow_arrays

    a = flow_arrays(0)
    fg = port_flow(a)
    task, model = msha_task(fg, in_features=8, out_features=4, lr=0.01,
                            device="cpu", **kw)
    return fg, task, model, a["src"], a["dst"]


def _colliding(model, n, table):
    """The parameters and buffers other than the node-row ``table`` with
    ``n`` rows."""
    return {name for name, t in list(model.named_parameters())
            + list(model.named_buffers())
            if name != table and t.dim() and t.shape[0] == n}


def test_state_shardings_place_the_node_rows():
    from tests.test_torch_gcn import flow_arrays

    fg, task, model, _, _ = _tiny_msha()
    # 16 sources, 8 recipients, in_features 16, H d 16, M H 16: the norms
    # and out_att have as many rows as there are sources
    fg16 = port_flow(flow_arrays(0, n=16, m=8))
    task16, model16 = msha_task(fg16, in_features=16, out_features=8,
                                device="cpu")
    assert {"out_att.W", "out_att.a", "attention.bn1.scale",
            "attention.bn2.mean"} <= _colliding(model16, 16, "Sfeatures")
    for fg, task, model in ((fg, task, model), (fg16, task16, model16)):
        for world in (1, 2):
            mesh = Mesh(group=None, rank=0, world=world,
                        device=torch.device("cpu"))
            places = state_shardings(
                TrainState.create(model, task.optimizer), mesh, fg.n_src)
            assert set(places) == {n for n, _ in model.named_parameters()} | {
                n for n, _ in model.named_buffers()}
            assert places["Sfeatures"].rows
            assert not any(p.rows for n, p in places.items()
                           if n != "Sfeatures")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_state_shardings_place_the_linkpred_features(world):
    """n = hidden: the encoder's and predictor's [hidden, ...] weights stay
    whole, only ``features`` is cut to the ranks' rows."""
    from msha_gnn_torch.training.link_prediction import (LinkPredConfig,
                                                         LinkPredModel)

    cfg = LinkPredConfig(hidden=16)
    model = LinkPredModel(16, cfg, generator=torch.Generator().manual_seed(0))
    assert len(_colliding(model, 16, "features")) >= 3
    mesh = Mesh(group=None, rank=world - 1, world=world,
                device=torch.device("cpu"))
    places = state_shardings(model, mesh, 16)
    assert [n for n, p in places.items() if p.rows] == ["features"]
    t = torch.arange(16 * 3).reshape(16, 3)
    for name, p in places.items():
        want = t[16 - 16 // world:] if name == "features" else t
        assert torch.equal(p.local(t), want)


def test_state_shardings_check_the_node_rows():
    """A node-row table that does not have ``n_nodes`` rows is an error,
    not a replicated table."""
    fg, task, model, _, _ = _tiny_msha()
    mesh = Mesh(group=None, rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="Sfeatures"):
        state_shardings(model, mesh, fg.n_src + 1)


def test_fault_tolerant_fit_resumes(tmp_path):
    fg, task, model, src, dst = _tiny_msha()
    trainer = Trainer(task=task, src=src, labels=dst, batch_size=64, seed=0)
    ids = np.arange(len(src))
    ckpt = str(tmp_path / "ck")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, task.optimizer)
    state, hist1 = fault_tolerant_fit(trainer, state, ids[:256], ids[256:],
                                      epochs=2, checkpoint_dir=ckpt)
    assert [h["epoch"] for h in hist1] == [0, 1]
    # a fresh process: resume runs the remaining epochs only
    model.load_state_dict(init)
    state2 = TrainState.create(model, task.optimizer)
    state2, hist2 = fault_tolerant_fit(trainer, state2, ids[:256], ids[256:],
                                       epochs=4, checkpoint_dir=ckpt)
    assert [h["epoch"] for h in hist2] == [2, 3]
    assert all(np.isfinite(h["train_loss"]) for h in hist1 + hist2)


def test_run_with_restarts_injected_failure(tmp_path):
    """The worker dies after epoch 2's checkpoint in its first life; the
    second life resumes from the checkpoint (epoch 2, not 0) and ends."""
    fg, task, model, src, dst = _tiny_msha()
    trainer = Trainer(task=task, src=src, labels=dst, batch_size=64, seed=0)
    ids = np.arange(len(src))
    ckpt = str(tmp_path / "ck")
    lives = {"n": 0}

    class CrashOnce:
        def __getattr__(self, name):
            return getattr(trainer, name)

        def train_epoch(self, state, train_ids, generator, epoch):
            if lives["n"] == 0 and epoch == 2:
                lives["n"] += 1
                raise RuntimeError("injected worker failure")
            return trainer.train_epoch(state, train_ids, generator, epoch)

    def fit():
        return fault_tolerant_fit(CrashOnce(),
                                  TrainState.create(model, task.optimizer),
                                  ids[:256], ids[256:], epochs=4,
                                  checkpoint_dir=ckpt)

    seen = []
    state, history, report = run_with_restarts(
        fit, max_restarts=2, on_failure=lambda i, e: seen.append(i))
    assert report["restarts"] == 1 and seen == [0]
    assert "injected worker failure" in report["failures"][0]["error"]
    # the first life's history died with it; the second re-ran 2 and 3
    assert [h["epoch"] for h in history] == [2, 3]


def test_run_with_restarts_exhausted():
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError, match="permanent failure"):
        run_with_restarts(always_fails, max_restarts=2)
    assert calls["n"] == 3  # the first life and 2 restarts


def test_device_health_check_reports_ok_and_hung(monkeypatch):
    assert device_health_check(timeout_s=60.0, device="cpu") == {
        "cpu": "ok"}
    release = threading.Event()
    real = torch.arange

    def wedged(*a, **kw):
        release.wait(30.0)
        return real(*a, **kw)

    monkeypatch.setattr(runtime.torch, "arange", wedged)
    try:
        assert device_health_check(timeout_s=0.2, device="cpu") == {
            "cpu": "hung"}
    finally:
        release.set()


SMALL_SCALING = dict(n=64, records=256, batch_size=16, iters=2,
                     in_features=8, out_features=4)


def test_bench_scaling_at_world_size_one():
    out = bench.bench_scaling(device="cpu", **SMALL_SCALING)
    assert list(out) == ["1"]
    r = out["1"]
    assert set(r) == {"step_seconds", "records_per_s", "scaling_efficiency"}
    assert r["step_seconds"] > 0 and r["scaling_efficiency"] is None
    assert r["records_per_s"] == 16 / r["step_seconds"]
    assert not dist.is_initialized()  # the group it made is gone


def test_cli_bench_scaling(monkeypatch, capsys):
    real = bench.bench_scaling
    monkeypatch.setattr(bench, "bench_scaling",
                        lambda **kw: real(**kw, **SMALL_SCALING))
    assert cli.main(["bench", "--which", "scaling", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["device"] == "cpu" and list(out["scaling"]) == ["1"]
    r = out["scaling"]["1"]
    assert r["records_per_s"] == 16 / r["step_seconds"]
