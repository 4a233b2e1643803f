"""The port's serving surface: data loading, checkpoints, Predictor, the
HTTP server and the CLI, on the CPU at a tiny size (as
``tests/test_serving.py`` and ``tests/test_server.py`` cover the JAX
package's)."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import msha_gnn_torch.graph as tg
from msha_gnn_torch import cli
from msha_gnn_torch.data import load_flow_graph
from msha_gnn_torch.server import MAX_NODES, ModelService, make_server
from msha_gnn_torch.serving import Predictor, recipient_names, run_predict
from msha_gnn_torch.training import (Task, gcn_task, latest_step,
                                     msha_task, restore_checkpoint,
                                     save_checkpoint)
from msha_gnn_torch.utils import TrainConfig
from tests.test_torch_gcn import flow_arrays, make_flow

PROVINCES = ["北京", "上海", "广东", "四川", "湖北"]


def write_data_dir(path, a, year="2015"):
    """The dataset's three files for the flow arrays ``a``."""
    path.mkdir(parents=True, exist_ok=True)
    adj = {"source_index": {str(i): [int(a["city"][i]), int(a["prov"][i])]
                            for i in range(a["n"])},
           "recipient_index": {PROVINCES[j]: j for j in range(a["m"])}}
    (path / f"Adjacent{year}.json").write_bytes(
        json.dumps(adj, ensure_ascii=False).encode("gbk"))
    gdp = {"GDP_embedding": {str(i): float(a["gdp"][i])
                             for i in range(a["n"])}}
    (path / f"GDP{year}.json").write_bytes(json.dumps(gdp).encode("gbk"))
    rows = "\n".join(
        f"{s},{d},{a['city'][s]},{a['prov'][s]}"
        for s, d in zip(a["src"], a["dst"]))
    (path / f"Flow{year}.csv").write_text(
        "source,recipient,city,province\n" + rows + "\n")
    return str(path)


@pytest.fixture(scope="module")
def tiny():
    a = flow_arrays(4)
    task, model = gcn_task(make_flow(tg, a), nfeat=8, device="cpu")
    return a, task, model


def test_load_flow_graph_matches_jax_loader(tmp_path):
    from msha_gnn_tpu.data import load_flow_graph as jax_load
    from tests.test_torch_graph import assert_same_graph

    a = flow_arrays(5)
    data_dir = write_data_dir(tmp_path / "data", a)
    got = load_flow_graph("2015", data_dir, pad_to_multiple=32)
    want = jax_load("2015", data_dir, pad_to_multiple=32)
    assert_same_graph(got.inter, want.inter)
    np.testing.assert_array_equal(got.gdp.numpy(), np.asarray(want.gdp))
    np.testing.assert_array_equal(got.city.group_id.numpy(),
                                  np.asarray(want.city.group_id))
    np.testing.assert_array_equal(got.province.group_id.numpy(),
                                  np.asarray(want.province.group_id))
    assert got.num_records == len(a["src"])
    assert recipient_names(data_dir, "2015") == dict(enumerate(PROVINCES))


def test_predictor_gathers_the_full_matrix(tiny):
    a, task, model = tiny
    pred = Predictor.from_state(task, model)
    nodes = np.asarray([0, 3, 17, 59, 3], np.int32)
    log_p = pred.log_scores(nodes)
    full = task.full_scores(model).numpy()
    np.testing.assert_array_equal(log_p, full[nodes])
    np.testing.assert_allclose(np.exp(log_p).sum(axis=1), 1.0, rtol=1e-5)
    top = pred.top_k(nodes, k=3, class_names=dict(enumerate(PROVINCES)))
    assert [t["node"] for t in top] == nodes.tolist()
    for t, row in zip(top, np.exp(full[nodes])):
        ps = [e["p"] for e in t["top"]]
        assert ps == sorted(ps, reverse=True) and len(ps) == 3
        assert [e["class"] for e in t["top"]] == np.argsort(-row)[:3].tolist()
        assert t["top"][0]["name"] == PROVINCES[t["top"][0]["class"]]
        np.testing.assert_allclose(ps, np.sort(row)[::-1][:3], rtol=1e-6)


def test_predictor_without_full_scores_raises(tiny):
    """A task without ``full_scores`` takes the per-batch path: chunks of
    ``batch_size`` padded with node 0, only the real rows returned.  (The
    GCN is row-local, so its rows equal the full matrix's.)"""
    _, task, model = tiny
    calls = []

    def forward(model, batch_idx, *, train):
        calls.append((batch_idx.clone(), train))
        return task.forward(model, batch_idx, train=train)

    pred = Predictor(Task(forward=forward), model, batch_size=16)
    nodes = np.asarray([5, 0, 59, 17] * 9 + [3], np.int32)  # 37 nodes
    log_p = pred.log_scores(nodes)
    assert log_p.shape == (37, 5) and pred._full is None
    full = task.full_scores(model).numpy()
    np.testing.assert_allclose(log_p, full[nodes], rtol=1e-6, atol=1e-6)
    assert [len(b) for b, _ in calls] == [16, 16, 16]
    assert not any(train for _, train in calls)
    assert calls[2][0][:5].tolist() == nodes[32:].tolist()
    assert not calls[2][0][5:].any()  # padded with node 0
    assert pred.log_scores([]).shape == (0, 0)


def test_checkpoint_round_trip_is_bit_exact(tiny, tmp_path):
    a, _, model = tiny
    ckpt = str(tmp_path / "ckpt")
    assert latest_step(ckpt) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ckpt, model)
    for step in (1, 2, 3, 4):
        save_checkpoint(ckpt, model, step=step,
                        extra={"step": step} if step == 4 else None)
    assert latest_step(ckpt) == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == [
        "step_2", "step_3", "step_4"]  # max_to_keep = 3
    _, other = gcn_task(make_flow(tg, a), nfeat=8, seed=7, device="cpu")
    restored, extra, step = restore_checkpoint(ckpt, other)
    assert restored is other and step == 4 and extra == {"step": 4}
    for k, v in model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k
    _, _, step = restore_checkpoint(ckpt, other, step=2)
    assert step == 2


@pytest.fixture(scope="module")
def service(tiny):
    a, task, model = tiny
    return ModelService(
        Predictor.from_state(task, model, batch_size=16), n_src=a["n"],
        class_names={i: f"P{i}" for i in range(a["m"])},
        metadata={"model": "gcn", "year": "tiny", "n_dst": a["m"]},
    )


@pytest.fixture(scope="module")
def base_url(service):
    httpd = make_server(service, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_routes(base_url, service):
    code, body = _get(base_url + "/healthz")
    assert code == 200 and body == {"status": "ok"}
    code, body = _post(base_url + "/v1/predict", {"nodes": [0, 3, 17], "k": 2})
    assert code == 200
    res = body["results"]
    assert [r["node"] for r in res] == [0, 3, 17]
    for r in res:
        ps = [e["p"] for e in r["top"]]
        assert len(ps) == 2 and ps == sorted(ps, reverse=True)
        assert r["top"][0]["name"] == f"P{r['top'][0]['class']}"
    code, body = _post(base_url + "/v1/scores", {"nodes": [1, 2]})
    assert code == 200
    np.testing.assert_array_equal(
        np.asarray(body["log_scores"], np.float32),
        service.predictor.log_scores(np.asarray([1, 2], np.int32)))
    code, body = _get(base_url + "/v1/metadata")
    assert code == 200 and body["model"] == "gcn"
    assert body["n_src"] == service.n_src and body["batch_size"] == 16
    assert body["cached_full_scores"] is True
    assert body["requests_served"] >= 2


def test_server_rejects_bad_input(base_url, service):
    for payload in ({}, {"nodes": []}, {"nodes": "0,1"},
                    {"nodes": [0.5]}, {"nodes": [-1]},
                    {"nodes": [service.n_src]}, [1, 2], "nodes", 7,
                    {"nodes": [0], "k": []}):
        code, body = _post(base_url + "/v1/predict", payload)
        assert code == 400 and "error" in body, payload
    code, _ = _post(base_url + "/v1/nope", {"nodes": [0]})
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base_url + "/nope")
    assert exc.value.code == 404
    with pytest.raises(ValueError):
        service.predict(list(range(MAX_NODES + 1)))


def test_server_concurrent_requests_agree(base_url):
    results = [None] * 8

    def worker(i):
        _, body = _post(base_url + "/v1/scores", {"nodes": [5, 7, 11]})
        results[i] = np.asarray(body["log_scores"])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])


def _served_setup(tmp_path):
    a = flow_arrays(6)
    data_dir = write_data_dir(tmp_path / "data", a)
    cfg = TrainConfig(model="gcn", data_dir=data_dir, in_features=8,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    fg = load_flow_graph("2015", data_dir)
    task, model = gcn_task(fg, nfeat=8, seed=3, device="cpu")
    save_checkpoint(cfg.checkpoint_dir, model, step=5)
    return a, cfg, task.full_scores(model).numpy()


def test_run_predict_end_to_end(tmp_path):
    a, cfg, full = _served_setup(tmp_path)
    out = str(tmp_path / "pred.jsonl")
    summary = run_predict(cfg, nodes="0,5,9", top_k=2, output=out,
                          device="cpu")
    assert summary == {"nodes": 3, "checkpoint_step": 5, "output": out}
    lines = [json.loads(l) for l in open(out, encoding="utf-8")]
    assert [l["node"] for l in lines] == [0, 5, 9]
    for line, node in zip(lines, (0, 5, 9)):
        best = int(np.argmax(full[node]))
        assert line["top"][0]["class"] == best
        assert line["top"][0]["name"] == PROVINCES[best]
        assert len(line["top"]) == 2
    nodes_file = tmp_path / "nodes.txt"
    nodes_file.write_text("1\n2\n\n")
    assert run_predict(cfg, nodes=f"@{nodes_file}", top_k=1, output=out,
                       device="cpu")["nodes"] == 2
    assert run_predict(cfg, nodes="all", top_k=1, output=out,
                       device="cpu")["nodes"] == a["n"]
    with pytest.raises(ValueError, match="out of range"):
        run_predict(cfg, nodes="0,99999", top_k=2, output=None, device="cpu")


def test_cli_predict(tmp_path, capsys):
    _, cfg, _ = _served_setup(tmp_path)
    out = str(tmp_path / "cli.jsonl")
    args = ["predict", "--model", "gcn", "--data_dir", cfg.data_dir,
            "--in_features", "8", "--checkpoint_dir", cfg.checkpoint_dir,
            "--nodes", "0,1", "--top_k", "3", "--output", out,
            "--device", "cpu"]
    assert cli.main(args) == 0
    assert json.loads(capsys.readouterr().out)["nodes"] == 2
    assert len(open(out, encoding="utf-8").readlines()) == 2


@pytest.mark.parametrize("cmd", ["predict", "serve"])
def test_cli_refuses_unported_models_and_missing_checkpoint(cmd, capsys):
    assert cli.main([cmd, "--model", "gin", "--checkpoint_dir", "x",
                     "--device", "cpu"]) == 2
    assert ("msha_gnn_torch serves: msha, ours, ablation1, ablation2, "
            "ablation3, gat, gcn, hgane, sage") in capsys.readouterr().err
    assert cli.main([cmd, "--model", "gcn", "--device", "cpu"]) == 2
    assert "requires --checkpoint_dir" in capsys.readouterr().err


def _msha_setup(tmp_path, model):
    """A dataset, a checkpoint of ``model`` (an MSHA preset) at the CLI's
    widths below, and the Predictor of the saved model."""
    a = flow_arrays(7)
    data_dir = write_data_dir(tmp_path / "data", a)
    cfg = TrainConfig(model=model, data_dir=data_dir, in_features=8,
                      out_features=4, checkpoint_dir=str(tmp_path / "ckpt"))
    task, saved = cli._build_task(cfg, load_flow_graph("2015", data_dir),
                                  "cpu")
    save_checkpoint(cfg.checkpoint_dir, saved, step=3)
    return a, cfg, Predictor(task, saved, batch_size=32)


MSHA_ARGS = ["--in_features", "8", "--out_features", "4", "--predict_batch",
             "32", "--device", "cpu"]


@pytest.mark.parametrize("model", ["msha", "ablation3"])
def test_cli_predict_msha(tmp_path, capsys, model):
    """``cli predict --model msha`` takes the per-batch path (chunks of
    ``--predict_batch``), ``--model ablation3`` the cached full matrix."""
    _, cfg, pred = _msha_setup(tmp_path, model)
    assert (pred.task.full_scores is None) == (model == "msha")
    out = str(tmp_path / "cli.jsonl")
    nodes = [0, 7, 33, 59, 2]
    args = ["predict", "--model", model, "--data_dir", cfg.data_dir,
            "--checkpoint_dir", cfg.checkpoint_dir, "--nodes",
            ",".join(map(str, nodes)), "--top_k", "3", "--output", out,
            *MSHA_ARGS]
    assert cli.main(args) == 0
    assert json.loads(capsys.readouterr().out) == {
        "nodes": 5, "checkpoint_step": 3, "output": out}
    lines = [json.loads(l) for l in open(out, encoding="utf-8")]
    want = pred.top_k(nodes, k=3, class_names=dict(enumerate(PROVINCES)))
    assert [l["node"] for l in lines] == nodes
    for line, w in zip(lines, want):
        assert [e["class"] for e in line["top"]] == \
            [e["class"] for e in w["top"]]
        assert line["top"][0]["name"] == w["top"][0]["name"]
        np.testing.assert_allclose([e["p"] for e in line["top"]],
                                   [e["p"] for e in w["top"]], rtol=1e-6)


@pytest.mark.parametrize("model", ["msha", "ablation3"])
def test_cli_serve_msha(tmp_path, monkeypatch, model):
    """``cli serve --model msha`` builds the service from the checkpoint;
    one ``/v1/predict`` and one ``/v1/scores`` over HTTP, then the server
    stops."""
    import msha_gnn_torch.server as server

    a, cfg, pred = _msha_setup(tmp_path, model)
    answers = {}

    def serve_once(service, host, port):
        httpd = make_server(service, host, 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://{host}:{httpd.server_address[1]}"
        try:
            answers["predict"] = _post(url + "/v1/predict",
                                       {"nodes": [1, 4], "k": 2})
            answers["scores"] = _post(url + "/v1/scores", {"nodes": [1, 4]})
            answers["meta"] = _get(url + "/v1/metadata")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        assert not thread.is_alive()

    monkeypatch.setattr(server, "serve", serve_once)
    args = ["serve", "--model", model, "--data_dir", cfg.data_dir,
            "--checkpoint_dir", cfg.checkpoint_dir, *MSHA_ARGS]
    assert cli.main(args) == 0
    code, body = answers["predict"]
    assert code == 200 and [r["node"] for r in body["results"]] == [1, 4]
    assert body["results"][0]["top"][0]["name"] in PROVINCES
    code, body = answers["scores"]
    assert code == 200
    np.testing.assert_allclose(np.asarray(body["log_scores"], np.float32),
                               pred.log_scores([1, 4]), rtol=1e-6,
                               atol=1e-6)
    code, body = answers["meta"]
    assert code == 200 and body["model"] == model
    assert body["batch_size"] == 32 and body["checkpoint_step"] == 3
    assert body["cached_full_scores"] is (model == "ablation3")


def test_entry_points_default_to_cuda_and_raise_without_it(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    from msha_gnn_torch import resolve_device
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator
    from msha_gnn_torch.training import flow_inputs

    a, _, _ = tiny
    fg = make_flow(tg, a)
    cfg = TrainConfig(model="gcn", checkpoint_dir=str(tmp_path),
                      data_dir=write_data_dir(tmp_path / "data", a))
    msha_cfg = dataclasses.replace(cfg, model="msha")
    for call in (lambda: resolve_device(),
                 lambda: gcn_task(fg),
                 lambda: msha_task(fg),
                 lambda: run_predict(msha_cfg, "0", 1, None),
                 lambda: flow_inputs(fg),
                 lambda: SpmmOperator(fg.inter),
                 lambda: run_predict(cfg, "0", 1, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
