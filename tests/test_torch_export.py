"""The port's scorer export (``export.py``, ``cli export``) on the CPU, as
``tests/test_export.py`` holds the JAX package's, and against the JAX
package's exported scorer on converted parameters.

Tolerances: an artifact against the live ``Predictor`` of the same model
at rtol 1e-5, atol 1e-6 (JAX's bounds in ``tests/test_export.py``; on the
CPU the two run the same operators and agree exactly); against the JAX
package's exported scorer at rtol 1e-4, atol 1e-5 (float32 in another
summation order).  GCN's table runs ``csr_spmm_f32`` through the
registered operator, whose CPU registration is the plain SpMM.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import msha_gnn_tpu.export as jax_export
import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.training import gcn_task as jax_gcn_task
from msha_gnn_tpu.training import msha_task as jax_msha_task
from msha_gnn_torch import cli
from msha_gnn_torch.export import (MAGIC, ExportedScorer, export_scorer,
                                   load_scorer)
from msha_gnn_torch.models import gcn_params_from_jax, msha_params_from_jax
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from msha_gnn_torch.serving import Predictor
from msha_gnn_torch.training import (gcn_task, hgane_task, msha_task,
                                     save_checkpoint)
from tests.test_torch_gcn import flow_arrays, make_flow
from tests.test_torch_msha import redraw_norms
from tests.test_torch_serving import write_data_dir

RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flow():
    a = flow_arrays(12, n=70, m=5, records=500)
    return a, make_flow(jg, a), make_flow(tg, a)


def spmm_nodes(scorer: ExportedScorer):
    return [n for n in scorer.program.graph.nodes
            if n.op == "call_function"
            and "msha_gnn_torch.csr_spmm." in str(n.target)]


def test_table_export_matches_predictor_and_jax(flow):
    """ablation3's table: the artifact against the live predictor and
    against the JAX package's artifact of the same variables."""
    _, fg_j, fg_t = flow
    task_j, variables, _ = jax_msha_task(fg_j, in_features=8,
                                         out_features=4, use_intra=False)
    variables = redraw_norms(variables, 3)
    task, model = msha_task(fg_t, in_features=8, out_features=4,
                            use_intra=False, device="cpu")
    model.load_state_dict(msha_params_from_jax(variables))
    scorer = load_scorer(export_scorer(task, model,
                                       meta={"model": "ablation3"}))
    assert scorer.meta["kind"] == "table"
    assert scorer.meta["model"] == "ablation3"
    assert scorer.meta["platforms"] == ["cpu"]
    assert scorer.device == torch.device("cpu")
    nodes = np.asarray([0, 3, 17, 59, 69])
    got = scorer(nodes).numpy()
    np.testing.assert_allclose(got, Predictor(task, model).log_scores(nodes),
                               rtol=RTOL, atol=ATOL)
    want = jax_export.load_scorer(jax_export.export_scorer(
        task_j, variables))(nodes.astype(np.int32))
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_gcn_table_runs_the_registered_spmm(flow):
    """GCN at ``impl="cuda"``: the program calls the operator twice (gc1
    transposed, gc2 plain), on the CPU its plain registration, no kernel
    launch; scores against the predictor and the JAX artifact."""
    _, fg_j, fg_t = flow
    task_j, variables, _ = jax_gcn_task(fg_j, nfeat=8)
    task, model = gcn_task(fg_t, nfeat=8, impl="cuda", device="cpu")
    model.load_state_dict(gcn_params_from_jax(variables))
    before = cuda_spmm.launches
    scorer = load_scorer(export_scorer(task, model))
    assert scorer.meta["kind"] == "table"
    rows = [n.args[4] for n in spmm_nodes(scorer)]
    assert rows == [fg_t.n_dst, fg_t.n_src]
    nodes = np.arange(fg_t.n_src)
    got = scorer(nodes).numpy()
    assert cuda_spmm.launches == before
    np.testing.assert_allclose(got, Predictor(task, model).log_scores(nodes),
                               rtol=RTOL, atol=ATOL)
    want = jax_export.load_scorer(jax_export.export_scorer(
        task_j, variables))(nodes.astype(np.int32))
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_registered_spmm_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col = torch.from_numpy(rng.integers(0, 4, 5).astype(np.int32))
    w = torch.from_numpy(rng.random(5).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    before = cuda_spmm.launches, cuda_spmm.bf16_launches
    for rows in (x, x.to(torch.bfloat16)):
        for weights in (w, None):
            got = torch.ops.msha_gnn_torch.csr_spmm(ptr, col, weights, rows,
                                                    3)
            assert got.dtype == torch.float32
            torch.testing.assert_close(
                got, cuda_spmm.csr_spmm_plain(ptr, col, weights, rows, 3),
                rtol=0, atol=0)
        fake = torch.ops.msha_gnn_torch.csr_spmm(
            ptr.to("meta"), col.to("meta"), w.to("meta"), rows.to("meta"), 3)
        assert fake.shape == (3, 3) and fake.dtype == torch.float32
    assert (cuda_spmm.launches, cuda_spmm.bf16_launches) == before


def test_batch_export_pads_and_matches(flow):
    """HGANE (no full table): 40 ids at batch 16, a padded tail."""
    _, _, fg_t = flow
    task, model = hgane_task(fg_t, in_features=8, out_features=4,
                             device="cpu")
    assert task.full_scores is None
    scorer = load_scorer(export_scorer(task, model, batch_size=16))
    assert scorer.meta["kind"] == "batch"
    assert scorer.meta["batch_size"] == 16
    nodes = np.arange(40)
    got = scorer(nodes).numpy()
    assert got.shape == (40, fg_t.n_dst)
    np.testing.assert_allclose(
        got, Predictor(task, model, batch_size=16).log_scores(nodes),
        rtol=RTOL, atol=ATOL)


def test_batch_export_of_msha_matches_jax(flow):
    """Full MSHA's batch artifact against the JAX package's, the same 24
    ids at batch 16 (its intra channels attend within the padded batch in
    both)."""
    _, fg_j, fg_t = flow
    task_j, variables, _ = jax_msha_task(fg_j, in_features=8,
                                         out_features=4)
    variables = redraw_norms(variables, 4)
    task, model = msha_task(fg_t, in_features=8, out_features=4,
                            device="cpu")
    model.load_state_dict(msha_params_from_jax(variables))
    nodes = np.arange(5, 29)
    got = load_scorer(export_scorer(task, model, batch_size=16))(nodes)
    want = jax_export.load_scorer(jax_export.export_scorer(
        task_j, variables, batch_size=16))(nodes.astype(np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_artifact_validation(flow):
    _, _, fg_t = flow
    with pytest.raises(ValueError):
        load_scorer(b"garbage")
    task, model = hgane_task(fg_t, in_features=8, out_features=4,
                             device="cpu")
    with pytest.raises(ValueError):
        export_scorer(task, model, kind="table")  # no full_scores
    with pytest.raises(ValueError):
        export_scorer(task, model, kind="nope")
    with pytest.raises(ValueError):
        export_scorer(task, model, platforms=("tpu",))
    blob = export_scorer(task, model, batch_size=8)
    assert blob.startswith(MAGIC)
    with pytest.raises(ValueError, match="portable"):
        load_scorer(blob, device="cuda")   # a cpu-only artifact
    portable = load_scorer(export_scorer(task, model, batch_size=8,
                                         platforms=("cpu", "cuda")))
    assert portable.meta["platforms"] == ["cpu", "cuda"]
    np.testing.assert_array_equal(portable(np.arange(8)).numpy(),
                                  load_scorer(blob)(np.arange(8)).numpy())


def test_cli_export_and_a_fresh_interpreter(flow, tmp_path, capsys):
    """``cli export`` of a checkpoint (full MSHA: a batch artifact), then the
    artifact loaded in a fresh interpreter that imports nothing but
    ``msha_gnn_torch.export``, against the live predictor."""
    a, _, fg_t = flow
    data_dir = write_data_dir(tmp_path / "data", a)
    task, model = msha_task(fg_t, in_features=8, out_features=4,
                            device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model, step=3)
    out = str(tmp_path / "scorer.mshax")
    assert cli.main(["export", "--data_dir", data_dir, "--checkpoint_dir",
                     ckpt, "--in_features", "8", "--out_features", "4",
                     "--output", out, "--predict_batch", "32", "--device",
                     "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["checkpoint_step"] == 3 and summary["bytes"] > 0
    assert summary["kind"] == "batch" and summary["platforms"] == ["cpu"]
    scorer = load_scorer(open(out, "rb").read())
    assert scorer.meta["n_src"] == fg_t.n_src
    nodes = [0, 5, 9]
    want = Predictor(task, model, batch_size=32).log_scores(nodes)
    np.testing.assert_allclose(scorer(nodes).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    script = ("import sys, json; from msha_gnn_torch.export import "
              "load_scorer; s = load_scorer(open(sys.argv[1], 'rb').read()); "
              "print(json.dumps(s([0, 5, 9]).tolist()))")
    proc = subprocess.run([sys.executable, "-c", script, out], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.asarray(json.loads(proc.stdout)), want,
                               rtol=RTOL, atol=ATOL)


def test_cli_export_needs_a_checkpoint(tmp_path, capsys):
    assert cli.main(["export", "--device", "cpu"]) == 2
    assert "requires --checkpoint_dir" in capsys.readouterr().err
