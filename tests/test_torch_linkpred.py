"""The port's link-prediction slice against the JAX package's.

* data: ``synthetic_ddi`` / ``split_edges`` give identical arrays from
  one seed, the message graph included;
* the model: JAX parameters converted by ``linkpred_params_from_jax``
  give the same loss and gradients on a fixed batch.  The JAX model runs
  ``impl="fused"`` (its Pallas rank-1 GAT kernels in interpret mode) with
  dropout 0, so no PRNG takes part; the port runs ``fused`` (the kernels'
  plain versions on the CPU) and ``torch`` (the plain path).  Loss rtol
  1e-4; gradients rtol 2e-3, atol 1e-3, the JAX package's tolerances for
  the fused operator's gradients (its f32 path sums through a bf16 hi/lo
  split);
* Adam, Hits@K, AUC, BCE, the training loop and the CLI on the CPU.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msha_gnn_tpu.data import ogb as jax_ogb
from msha_gnn_tpu.models import MLP as JaxMLP
from msha_gnn_tpu.models import LinkPredictor as JaxLinkPredictor
from msha_gnn_tpu.models import SparseGAT as JaxSparseGAT
from msha_gnn_tpu.training.kd import _binary_auc_np
from msha_gnn_tpu.training.losses import bce_loss as jax_bce_loss
from msha_gnn_tpu.training.metrics import hits_at_k as jax_hits_at_k
from msha_gnn_tpu.training.optim import adam_l2 as jax_adam_l2
from msha_gnn_torch import cli
from msha_gnn_torch.data import ogb
from msha_gnn_torch.models import MLP, LinkPredictor, linkpred_params_from_jax
from msha_gnn_torch.training import (LinkPredConfig, LinkPredModel, adam_l2,
                                     bce_loss, binary_auc, hits_at_k,
                                     linkpred_loss, run_link_prediction)
from msha_gnn_torch.utils import JsonlLogger

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3


def tiny_split(pkg, seed=0):
    data = pkg.synthetic_ddi(n=200, n_edges=3000, seed=seed)
    return pkg.split_edges(data, num_neg=500, seed=seed, pad_to_multiple=64)


def test_data_split_is_identical():
    sj, st = tiny_split(jax_ogb), tiny_split(ogb)
    assert sj["n"] == st["n"] and sj["name"] == st["name"]
    for key in ("train_pos", "valid_pos", "test_pos", "neg"):
        for a, b in zip(sj[key], st[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
    gj, gt = sj["graph"], st["graph"]
    for name in ("senders", "receivers", "row_ptr", "weight"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, name)),
                                      getattr(gt, name).numpy(), name)
    assert (gj.n_src, gj.n_dst, gj.num_edges) == \
        (gt.n_src, gt.n_dst, gt.num_edges)


def test_load_ogbl_ddi_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 60
    edges = rng.integers(0, n, (400, 2)).astype(np.int64)
    raw = tmp_path / "ogbl_ddi" / "raw"
    raw.mkdir(parents=True)
    with gzip.open(raw / "edge.csv.gz", "wt") as f:
        f.writelines(f"{s},{d}\n" for s, d in edges)
    target = tmp_path / "ogbl_ddi" / "split" / "target"
    target.mkdir(parents=True)
    perm = rng.permutation(400)
    neg = rng.integers(0, n, (80, 2)).astype(np.int64)
    torch.save({"edge": torch.from_numpy(edges[perm[:300]])},
               target / "train.pt")
    torch.save({"edge": edges[perm[300:350]]}, target / "valid.pt")  # numpy
    torch.save({"edge": torch.from_numpy(edges[perm[350:]]),
                "edge_neg": torch.from_numpy(neg)}, target / "test.pt")
    sj = jax_ogb.split_edges(jax_ogb.load_ddi(str(tmp_path)))
    st = ogb.split_edges(ogb.load_ddi(str(tmp_path)))
    for key in ("train_pos", "valid_pos", "test_pos", "neg"):
        for a, b in zip(sj[key], st[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
    np.testing.assert_array_equal(np.asarray(sj["graph"].senders),
                                  st["graph"].senders.numpy())
    assert ogb.load_ddi(str(tmp_path / "absent"), n=50,
                        n_edges=300)["name"].startswith("synthetic")


@pytest.fixture(scope="module")
def jax_linkpred():
    """The JAX run's model at hidden 8, dropout 0: parameters, a batch,
    and the loss and gradients of ``impl="fused"``."""
    split = tiny_split(jax_ogb, seed=3)
    n, hidden = split["n"], 8
    encoder = JaxSparseGAT(in_features=hidden, hidden=hidden,
                           out_features=hidden, n_heads=2, dropout=0.0)
    predictor = JaxLinkPredictor(predictor="mlp", hidden_channels=hidden,
                                 num_layers=2, dropout=0.0)
    k_feat, k_e, k_p = jax.random.split(jax.random.key(0), 3)
    features = jax.random.normal(k_feat, (n, hidden)) * 0.1
    graph = split["graph"]
    params = {
        "encoder": encoder.init(k_e, graph, features, train=False,
                                impl="xla")["params"],
        "predictor": predictor.init(k_p, jnp.zeros((1, hidden)),
                                    jnp.zeros((1, hidden)),
                                    train=False)["params"],
        "features": features,
    }
    rng = np.random.default_rng(4)
    ps, pr = (a[:256] for a in split["train_pos"])
    ns, nr = rng.integers(0, n, (2, 256))
    batch = [np.asarray(v, np.int64) for v in (ps, pr, ns, nr)]

    def loss_fn(params):
        h = encoder.apply({"params": params["encoder"]}, graph,
                          params["features"], train=True, impl="fused")
        pos = predictor.apply({"params": params["predictor"]},
                              h[batch[0]], h[batch[1]], train=True)
        neg = predictor.apply({"params": params["predictor"]},
                              h[batch[2]], h[batch[3]], train=True)
        return 0.5 * (jax_bce_loss(pos, jnp.ones_like(pos))
                      + jax_bce_loss(neg, jnp.zeros_like(neg)))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return params, batch, float(loss), grads


@pytest.mark.parametrize("impl", ["fused", "torch"])
def test_loss_and_gradients_match_jax(jax_linkpred, impl):
    params, batch, want_loss, want_grads = jax_linkpred
    split = tiny_split(ogb, seed=3)
    cfg = LinkPredConfig(hidden=8, dropout=0.0, seed=0)
    model = LinkPredModel(split["n"], cfg)
    model.load_state_dict(linkpred_params_from_jax(params))
    loss = linkpred_loss(model, split["graph"],
                         [torch.from_numpy(b) for b in batch], impl=impl)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    loss.backward()
    want = linkpred_params_from_jax(want_grads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _dense_params(tree):
    """A flax Dense tree ``{"<name>_<i>": {"kernel", "bias"}}`` -> the
    ``nn.Linear`` state of a ``ModuleList`` named ``<name>``."""
    sd = {}
    for name, dense in tree.items():
        base, i = name.rsplit("_", 1)
        sd[f"{base}.{i}.weight"] = torch.from_numpy(
            np.asarray(dense["kernel"]).T.copy())
        sd[f"{base}.{i}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return sd


@pytest.mark.parametrize("predictor,final_linear", [("mlp", False),
                                                    ("inner", True)])
def test_predictor_variants_and_mlp_match_jax(predictor, final_linear):
    """The predictor modes the loss test does not reach, and the MLP
    student, forward on the same weights (no dropout: eval)."""
    rng = np.random.default_rng(9)
    x_i, x_j = (rng.standard_normal((32, 8)).astype(np.float32)
                for _ in range(2))
    jp = JaxLinkPredictor(predictor=predictor, hidden_channels=8,
                          num_layers=2, final_linear=final_linear)
    variables = jp.init(jax.random.key(1), jnp.asarray(x_i),
                        jnp.asarray(x_j), train=False)
    want = jp.apply(variables, jnp.asarray(x_i), jnp.asarray(x_j),
                    train=False)
    tp = LinkPredictor(predictor, 8, num_layers=2, final_linear=final_linear)
    tp.load_state_dict(_dense_params(variables.get("params", {})))
    got = tp(torch.from_numpy(x_i), torch.from_numpy(x_j), train=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    jm = JaxMLP(num_layers=3, hidden_dim=16, output_dim=4)
    variables = jm.init(jax.random.key(2), jnp.asarray(x_i), train=False)
    tm = MLP(3, 8, 16, 4)
    tm.load_state_dict(_dense_params(variables["params"]))
    np.testing.assert_allclose(
        tm(torch.from_numpy(x_i), train=False).detach().numpy(),
        np.asarray(jm.apply(variables, jnp.asarray(x_i), train=False)),
        rtol=1e-5, atol=1e-6)


def test_initialisers_follow_the_jax_distributions():
    """``W``/``a`` xavier bounds (gain 1.414) and the Dense kernels'
    truncated LeCun normal, from an explicit generator."""
    gen = torch.Generator().manual_seed(0)
    model = LinkPredModel(50, LinkPredConfig(hidden=64), generator=gen)
    w = model.encoder.attention_0.W.detach()
    bound = 1.414 * np.sqrt(6.0 / 128)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    k = model.predictor.lins[0].weight.detach()
    std = np.sqrt(1.0 / 64)
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(k.std()) - std) < 0.1 * std
    assert not model.predictor.lins[0].bias.any()
    again = LinkPredModel(50, LinkPredConfig(hidden=64),
                          generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_adam_matches_optax():
    """Four steps from identical gradients, in float64 on both sides:
    optax computes its bias corrections in the parameters' type, and in
    float32 ``1 - 0.999**t`` alone is off by about 6e-5 relative."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,), (2, 2)]
    init = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) for s in shapes] for _ in range(4)]
    p_t = [torch.from_numpy(v.copy()).requires_grad_() for v in init]
    opt = adam_l2(p_t, 5e-3)
    with jax.enable_x64(True):
        tx = jax_adam_l2(5e-3)
        p_j = [jnp.asarray(v) for v in init]
        state = tx.init(p_j)
        for g in grads:
            updates, state = tx.update([jnp.asarray(v) for v in g], state,
                                       p_j)
            p_j = optax.apply_updates(p_j, updates)
            for t, v in zip(p_t, g):
                t.grad = torch.from_numpy(v)
            opt.step()
        p_j = [np.asarray(v) for v in p_j]
    for t, j, v0 in zip(p_t, p_j, init):
        assert j.dtype == np.float64
        np.testing.assert_allclose(t.detach().numpy() - v0, j - v0,
                                   rtol=1e-6)


def test_metrics_and_bce_match_jax():
    rng = np.random.default_rng(6)
    # rounded scores: ties inside and across the classes
    pos = np.round(rng.random(300), 2).astype(np.float32)
    neg = np.round(rng.random(700) * 0.8, 2).astype(np.float32)
    for k in (20, 50, 1000):
        # the same count of hits; the float32 means round apart by an ulp
        np.testing.assert_allclose(
            float(hits_at_k(torch.from_numpy(pos), torch.from_numpy(neg), k)),
            float(jax_hits_at_k(jnp.asarray(pos), jnp.asarray(neg), k)),
            rtol=1e-6)
    assert binary_auc(pos, neg) == _binary_auc_np(pos, neg)
    assert np.isnan(binary_auc(pos, pos[:0]))
    scores = np.concatenate([pos, [0.0, 1.0]]).astype(np.float32)
    labels = (rng.random(scores.size) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(bce_loss(torch.from_numpy(scores), torch.from_numpy(labels))),
        float(jax_bce_loss(jnp.asarray(scores), jnp.asarray(labels))),
        rtol=1e-6)


def test_run_link_prediction_on_cpu(tmp_path):
    path = tmp_path / "log.jsonl"
    log = JsonlLogger(str(path), echo=False)
    cfg = LinkPredConfig(hidden=8, epochs=2, batch_size=256, seed=0)
    result = run_link_prediction(tiny_split(ogb), cfg, log=log, device="cpu")
    log.close()
    assert result["impl"] == "torch"
    for key in ("hits@20", "hits@50", "auc", "final_train_loss"):
        assert np.isfinite(result[key]), key
    assert 0.0 <= result["hits@20"] <= result["hits@50"] <= 1.0
    events = [json.loads(line)["event"] for line in path.read_text().split(
        "\n") if line]
    assert events == ["linkpred_epoch", "linkpred_epoch", "linkpred_eval"]
    with pytest.raises(NotImplementedError, match="sampler"):
        run_link_prediction(tiny_split(ogb), LinkPredConfig(
            neighbor_fanout=4), device="cpu")
    with pytest.raises(NotImplementedError, match="flash"):
        run_link_prediction(tiny_split(ogb), LinkPredConfig(impl="flash"),
                            device="cpu")


def test_cli_linkpred(tmp_path, capsys):
    rng = np.random.default_rng(8)
    raw = tmp_path / "ogbl_ddi" / "raw"
    raw.mkdir(parents=True)
    np.savetxt(raw / "edge.csv", rng.integers(0, 80, (600, 2)),
               delimiter=",", fmt="%d")
    rc = cli.main(["linkpred", "--ogb_root", str(tmp_path), "--hidden", "8",
                   "--epochs", "1", "--batch_size", "128", "--device",
                   "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["impl"] == "torch" and result["dataset"] == "ogbl-ddi"
    assert np.isfinite(result["auc"])
    for flags in (["--use_kd", "1"], ["--neighbor_fanout", "4"],
                  ["--impl", "pallas"]):
        assert cli.main(["linkpred", "--device", "cpu", *flags]) == 2
        assert "not ported" in capsys.readouterr().err
