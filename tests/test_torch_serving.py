"""The port's serving surface: data loading, checkpoints, Predictor, the
HTTP server and the CLI, on the CPU at a tiny size (as
``tests/test_serving.py`` and ``tests/test_server.py`` cover the JAX
package's)."""

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
                                     restore_checkpoint, save_checkpoint)
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
    _, task, model = tiny
    pred = Predictor(Task(forward=task.forward), model)
    with pytest.raises(NotImplementedError, match="not ported"):
        pred.log_scores([0])


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
    assert cli.main([cmd, "--model", "msha", "--checkpoint_dir", "x",
                     "--device", "cpu"]) == 2
    assert "msha_gnn_torch serves: gcn" in capsys.readouterr().err
    assert cli.main([cmd, "--model", "gcn", "--device", "cpu"]) == 2
    assert "requires --checkpoint_dir" in capsys.readouterr().err


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
    for call in (lambda: resolve_device(),
                 lambda: gcn_task(fg),
                 lambda: flow_inputs(fg),
                 lambda: SpmmOperator(fg.inter),
                 lambda: run_predict(cfg, "0", 1, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
