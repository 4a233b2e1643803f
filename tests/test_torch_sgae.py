"""The port's SGAE pipeline (``msha_gnn_torch/training/sgae.py``) against
the JAX package's, and the ``llp`` / ``sgae`` commands, on the CPU at a
tiny size.

* the pretrain step's loss and gradients against JAX's at the same
  embeddings and batch (rtol 1e-5);
* the pretrain's batches and negatives, one year and the temporal
  round-robin over years (one of them without records, skipped), against
  the arrays the JAX run hands its step, recorded from the run itself;
* Adam over the temporal tree: a year's embeddings move on another
  year's batch, as optax moves them;
* ``finetune_with_pretrained`` puts ``z_src`` into ``Sfeatures``;
  ``run_sgae`` with and without ``years``; ``cli llp`` and ``cli sgae``
  on a data directory.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_torch.graph as tg
import msha_gnn_tpu.graph as jg
from msha_gnn_torch import cli
from msha_gnn_torch.training import sgae
from msha_gnn_torch.utils import SGAEConfig
from msha_gnn_tpu.training import sgae as jax_sgae
from msha_gnn_tpu.training.losses import bce_loss as jax_bce_loss
from msha_gnn_tpu.utils import SGAEConfig as JaxSGAEConfig
from tests import test_torch_serving
from tests.test_torch_gcn import flow_arrays, make_flow


def flows(seed, n=80, m=6, records=700):
    a = flow_arrays(seed, n=n, m=m, records=records)
    return make_flow(tg, a), make_flow(jg, a)


def test_pretrain_step_matches_jax():
    rng = np.random.default_rng(0)
    n, m, dim, b = 50, 6, 8, 64
    z_src = rng.random((n, dim)).astype(np.float32)
    z_dst = rng.random((m, dim)).astype(np.float32)
    batch = [rng.integers(0, k, b) for k in (n, m, n, m)]

    def loss_fn(p):
        pos = jax.nn.sigmoid(jnp.sum(p["z_src"][batch[0]]
                                     * p["z_dst"][batch[1]], axis=-1))
        neg = jax.nn.sigmoid(jnp.sum(p["z_src"][batch[2]]
                                     * p["z_dst"][batch[3]], axis=-1))
        return 0.5 * (jax_bce_loss(pos, jnp.ones_like(pos))
                      + jax_bce_loss(neg, jnp.zeros_like(neg)))

    want, grads = jax.value_and_grad(loss_fn)(
        {"z_src": jnp.asarray(z_src), "z_dst": jnp.asarray(z_dst)})
    zs = torch.from_numpy(z_src).requires_grad_()
    zd = torch.from_numpy(z_dst).requires_grad_()
    loss = sgae.ae_loss(zs, zd, *(torch.from_numpy(v) for v in batch))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(zs.grad.numpy(), np.asarray(grads["z_src"]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(zd.grad.numpy(), np.asarray(grads["z_dst"]),
                               rtol=1e-5, atol=1e-8)


class _Recorder:
    """``jnp`` for ``msha_gnn_tpu.training.sgae``, keeping a copy of every
    numpy array the run hands ``jnp.asarray``: its steps' four index
    arrays, in order."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, a, *args, **kw):
        if isinstance(a, np.ndarray):
            self.seen.append(a.copy())
        return jnp.asarray(a, *args, **kw)


def steps_of(arrays):
    return [arrays[i: i + 4] for i in range(0, len(arrays), 4)]


def assert_steps_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64),
                                          err_msg=f"step {i} array {j}")


def test_pretrain_draws_match_jax(monkeypatch):
    """Two epochs of 700 records in batches of 128 (5 whole batches an
    epoch, the rest left out), with 2 negatives a positive."""
    fg, fg_j = flows(1)
    kw = dict(dim=8, epochs=2, batch_size=128, neg_per_pos=2, seed=3)
    rec = _Recorder()
    monkeypatch.setattr(jax_sgae, "jnp", rec)
    jax_sgae.pretrain_autoencoder(fg_j, **kw)
    rng = np.random.default_rng(kw["seed"])
    src, dst = fg.edge_src.numpy(), fg.edge_dst.numpy()
    got = []
    for _ in range(2):
        ps, pr, ns, nr = sgae.pretrain_epoch_arrays(
            rng, src, dst, fg.n_src, fg.n_dst, 128, 2)
        assert ps.shape == (5, 128) and ns.shape == (5, 256)
        got += list(zip(ps, pr, ns, nr))
    assert_steps_equal(got, steps_of(rec.seen))
    z_src, z_dst, history = sgae.pretrain_autoencoder(fg, **kw,
                                                      device="cpu")
    assert z_src.shape == (fg.n_src, 8) and z_dst.shape == (fg.n_dst, 8)
    assert len(history) == 2 and history[1] < history[0]
    # the last column is the GDP scalar
    np.testing.assert_array_equal(
        sgae.pretrain_autoencoder(fg, **{**kw, "epochs": 0},
                                  device="cpu")[0][:, -1].numpy(),
        fg.gdp.numpy())


def year_graphs():
    """Three years on 6 recipients: two with records (different sizes),
    one without."""
    fg_a, fg_a_j = flows(2, n=80, records=700)
    fg_b, fg_b_j = flows(3, n=50, records=400)
    empty = flow_arrays(4, n=30, m=6, records=0)
    return ({"2015": fg_a, "2016": fg_b, "2017": make_flow(tg, empty)},
            {"2015": fg_a_j, "2016": fg_b_j, "2017": make_flow(jg, empty)})


def test_temporal_draws_match_jax(monkeypatch):
    """The round-robin over the years with records (700 and 400 records in
    batches of 128: 5 and 3 batches, so 2015 runs alone at the end), the
    year without records skipped with a log line."""
    fgs, fgs_j = year_graphs()
    kw = dict(dim=8, epochs=2, batch_size=128, seed=4)
    rec = _Recorder()
    monkeypatch.setattr(jax_sgae, "jnp", rec)
    jax_logs = []
    jax_sgae.pretrain_autoencoder_temporal(fgs_j, **kw, log=jax_logs.append)
    rng = np.random.default_rng(kw["seed"])
    active = ["2015", "2016"]
    edges = {y: (fgs[y].edge_src.numpy(), fgs[y].edge_dst.numpy())
             for y in active}
    n_src = {y: fgs[y].n_src for y in active}
    got, years = [], []
    for _ in range(2):
        sched = sgae.temporal_epoch_schedule(rng, edges, n_src, 6, 128)
        years += [s[0] for s in sched]
        got += [s[1:] for s in sched]
    assert years[:8] == ["2015", "2016"] * 3 + ["2015"] * 2
    assert_steps_equal(got, steps_of(rec.seen))
    logs = []
    z_by_year, z_dst, history = sgae.pretrain_autoencoder_temporal(
        fgs, **kw, log=logs.append, device="cpu")
    skips = [r for r in logs if r["event"] == "sgae_temporal_skip_year"]
    assert skips == [r for r in jax_logs
                     if r["event"] == "sgae_temporal_skip_year"]
    assert skips[0]["year"] == "2017" and set(history) == set(active)
    assert set(z_by_year) == set(fgs) and z_dst.shape == (6, 8)
    for y in active:
        assert len(history[y]) == 2 and np.isfinite(history[y]).all()
    with pytest.raises(ValueError, match="shared recipient set"):
        sgae.pretrain_autoencoder_temporal(
            {**fgs, "2018": make_flow(tg, flow_arrays(5, m=7))}, **kw,
            device="cpu")


def test_adam_steps_every_embedding_as_optax():
    """The temporal tree's update: a step on one year's loss moves the
    other year's embeddings too (its moments decaying on a zero gradient),
    as optax's Adam over the whole tree moves them; four steps on
    alternating losses, in float64 on both sides."""
    import optax

    rng = np.random.default_rng(3)
    init = [rng.standard_normal((5, 3)) for _ in range(2)]
    targets = [rng.standard_normal((5, 3)) for _ in range(4)]
    params = [torch.from_numpy(v.copy()).requires_grad_() for v in init]
    opt = torch.optim.Adam(params, lr=1e-2)
    with jax.enable_x64(True):
        tx = optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8)
        p_j = [jnp.asarray(v) for v in init]
        state = tx.init(p_j)
        for t, target in enumerate(targets):
            k = t % 2
            loss = ((params[k] - torch.from_numpy(target)) ** 2).sum()
            sgae._adam_step(opt, params, loss)
            grads = jax.grad(lambda p: jnp.sum(
                (p[k] - jnp.asarray(target)) ** 2))(p_j)
            updates, state = tx.update(grads, state, p_j)
            p_j = optax.apply_updates(p_j, updates)
        p_j = [np.asarray(v) for v in p_j]
    for got, want, v0 in zip(params, p_j, init):
        assert not np.allclose(want, v0)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10,
                                   atol=1e-12)


def test_finetune_sets_sfeatures():
    fg, _ = flows(6, m=6)
    z = torch.rand((fg.n_src, 12), generator=torch.Generator().manual_seed(0))
    cfg = SGAEConfig(epochs=0, batch_size=64, dropout=0.0)
    state, history = sgae.finetune_with_pretrained(fg, z, cfg, device="cpu")
    assert history == [] and torch.equal(state.model.Sfeatures.detach(), z)
    assert state.model.linear1.in_features == 12
    state, history = sgae.finetune_with_pretrained(
        fg, z, SGAEConfig(epochs=1, batch_size=64), device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])


def test_config_matches_jax():
    port = {f: v for f, v in SGAEConfig().__dict__.items()}
    want = dict(JaxSGAEConfig().__dict__)
    assert list(port) == list(want)
    assert port.pop("data_dir") == "anonymous_data"
    want.pop("data_dir")
    assert port == want


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two years of 32 recipients in the loader's format: 2015 with 9,000
    records (two 4,096-record pretrain batches), 2016 without its Flow
    CSV."""
    mp = pytest.MonkeyPatch()
    mp.setattr(test_torch_serving, "PROVINCES",
               [f"p{j}" for j in range(32)])
    path = tmp_path_factory.mktemp("data")
    test_torch_serving.write_data_dir(
        path, flow_arrays(7, n=400, m=32, records=9000), "2015")
    test_torch_serving.write_data_dir(
        path, flow_arrays(8, n=300, m=32, records=50), "2016")
    (path / "Flow2016.csv").unlink()
    mp.undo()
    return str(path)


@pytest.mark.parametrize("years", ["", "2015,2016"])
def test_run_sgae(data_dir, years):
    logs = []
    cfg = SGAEConfig(data_dir=data_dir, pretrain_epochs=1, epochs=1,
                     years=years)
    result = sgae.run_sgae(cfg, log=logs.append, device="cpu")
    events = [r["event"] for r in logs]
    if years:
        assert result["pretrain_loss"].keys() == {"2015"}
        assert "sgae_temporal_skip_year" in events
    else:
        assert len(result["pretrain_loss"]) == 1
        assert "sgae_pretrain" in events
    assert np.isfinite(result["finetune"]["train_loss"])
    assert "train_epoch" in events and "eval" in events


@pytest.mark.parametrize("argv", [
    ["llp", "--epochs", "1"],
    ["sgae", "--pretrain_epochs", "1", "--epochs", "1"],
    ["sgae", "--years", "2015,2016", "--pretrain_epochs", "1", "--epochs",
     "1"],
])
def test_cli_llp_and_sgae(data_dir, capsys, argv):
    assert cli.main([*argv, "--device", "cpu", "--data_dir", data_dir]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if argv[0] == "llp":
        assert 0.0 <= result["auc"] <= 1.0
        assert np.isfinite(result["final_train_loss"])
    else:
        assert np.isfinite(result["finetune"]["train_loss"])
        assert result["pretrain_loss"]
