"""The port's joint multi-year MSHA training (``training/temporal.py``,
``cli train --years``) against the JAX package's, on the CPU.

Two years of the same flow arrays (numpy, from seeds) go into both
packages, with different local recipient orders, beside a year without
records.  The JAX run's initial variables (``train_temporal_msha(...,
epochs=0)``) go into the port's model through
``temporal_msha_params_from_jax``; both then train 2 epochs at dropout 0
from the same numpy batches.  The JAX optimiser's last state is read
through a ``jax.debug.callback`` on the chain's update.

Tolerances: each epoch's per-year train loss at rtol 1e-4, atol 1e-5
(float32 in another summation order), and the final scores of every
year's rows at the same bounds; the report's rank and count metrics at an
absolute 1e-2: near-tied scores of different rows (3.5e-6 apart
relative) swap, and one swapped pair moves a class's AUC by 1 / (P N),
about 1e-2 on 26 test records, a fifth of that in the macro mean; the
parameters, running
statistics and Adam moments after 2 epochs at rtol 1e-4, atol 1e-4 of
each tensor's largest value (Adam divides by the root of the second
moment, so last-bit differences of small gradients move an update by a
fraction of ``lr``).  The forwards at rtol 1e-4, atol 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_tpu.training.temporal as jax_temporal
import msha_gnn_torch.graph as tg
from msha_gnn_torch import cli
from msha_gnn_torch.data.raw import (RawRecord, anonymize,
                                     write_anonymous_dataset)
from msha_gnn_torch.models import temporal_msha_params_from_jax
from msha_gnn_torch.training import (build_temporal, canonical_recipients,
                                     fit_temporal, temporal_loss,
                                     temporal_step, train_temporal_msha)
from msha_gnn_torch.training.temporal import _canonicalize_mask
from scripts_torch_convert_checkpoint import adam_state
from tests.test_torch_gcn import flow_arrays, make_flow

RTOL, ATOL = 1e-4, 1e-5
REPORT_ATOL = 1e-2
STATE_RTOL, STATE_ATOL_REL = 1e-4, 1e-4
NAMES = ["prov_a", "prov_b", "prov_c", "prov_d", "prov_e"]
DIMS = dict(in_features=8, out_features=4, n_heads=2)
BATCH = 16


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def empty_flow(pkg, n=20, m=5):
    """A year with a graph and GDP but no flow records."""
    arr = jnp.asarray if pkg is jg else torch.from_numpy
    inter = pkg.BipartiteGraph.from_coo(
        np.zeros(0, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.float32), n_src=n, n_dst=m, pad_to_multiple=32)
    zeros = np.zeros(n, np.int32)
    return pkg.FlowGraph(
        inter=inter, city=pkg.Grouping.from_ids(zeros),
        province=pkg.Grouping.from_ids(zeros),
        gdp=arr(np.linspace(0, 1, n).astype(np.float32)),
        edge_src=arr(np.zeros(0, np.int32)),
        edge_dst=arr(np.zeros(0, np.int32)))


@pytest.fixture(scope="module")
def years():
    """(JAX graphs, port graphs, recipient maps): 2015 and 2016 with
    different recipient orders, 2017 without records."""
    rng = np.random.default_rng(3)
    fgs_j, fgs_t, maps = {}, {}, {}
    for i, year in enumerate(["2015", "2016"]):
        a = flow_arrays(10 + i, n=40 + 10 * i, m=5, records=260)
        fgs_j[year], fgs_t[year] = make_flow(jg, a), make_flow(tg, a)
        order = rng.permutation(5)
        maps[year] = {n: int(order[j]) for j, n in enumerate(NAMES)}
    fgs_j["2017"], fgs_t["2017"] = empty_flow(jg), empty_flow(tg)
    maps["2017"] = maps["2015"]
    return fgs_j, fgs_t, maps


def jax_run(monkeypatch, fgs_j, maps, epochs, **kw):
    """``train_temporal_msha`` of the JAX package, and its optimiser's
    state after the last step."""
    captured = {}
    real = jax_temporal.adam_l2

    def recording(lr, wd):
        tx = real(lr, wd)

        def update(grads, state, params=None):
            updates, new = tx.update(grads, state, params)
            jax.debug.callback(
                lambda s: captured.__setitem__("state", s), new)
            return updates, new

        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(jax_temporal, "adam_l2", recording)
    params, stats, history = jax_temporal.train_temporal_msha(
        fgs_j, maps, epochs=epochs, **kw)
    jax.effects_barrier()
    return params, stats, history, captured.get("state")


def port_run(fgs_t, maps, params, stats, **kw):
    run = build_temporal(fgs_t, maps, device="cpu", **kw)
    run.state.model.load_state_dict(temporal_msha_params_from_jax(
        {"params": params, "batch_stats": stats}))
    return run


def close_rel(got, want, err_msg):
    got, want = _np(got), _np(want)
    atol = STATE_ATOL_REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=STATE_RTOL, atol=atol,
                               err_msg=err_msg)


def test_canonical_recipients_and_masks_match_jax(years):
    _, fgs_t, maps = years
    names, to_canon = canonical_recipients(maps)
    want_names, want_canon = jax_temporal.canonical_recipients(maps)
    assert names == want_names == NAMES
    for y in maps:
        np.testing.assert_array_equal(to_canon[y], want_canon[y])
        assert to_canon[y].dtype == want_canon[y].dtype
        mask = fgs_t[y].inter.to_dense().numpy() > 0
        np.testing.assert_array_equal(
            _canonicalize_mask(mask, to_canon[y], 5),
            jax_temporal._canonicalize_mask(mask, want_canon[y], 5))


@pytest.mark.parametrize("use_intra", [True, False],
                         ids=["msha", "ablation3"])
def test_forward_matches_jax_apply(years, use_intra):
    """``TemporalMSHA``'s forward per year with converted parameters, in
    eval mode over all rows and in training mode over a batch (the
    norms' statistics move the same way)."""
    fgs_j, fgs_t, maps = years
    kw = dict(DIMS, dropout=0.0, use_intra=use_intra)
    params, stats, _ = jax_temporal.train_temporal_msha(
        fgs_j, maps, epochs=0, **kw)
    variables = {"params": params, "batch_stats": stats}
    run = port_run(fgs_t, maps, params, stats, **kw)
    model = run.state.model
    model_j = jax_temporal.TemporalMSHA(
        years=tuple(sorted(fgs_j)),
        gdp_by_year={y: fgs_j[y].gdp for y in fgs_j}, n_classes=5, **kw)
    for y in ("2015", "2016"):
        mask = jnp.asarray(_np(run.masks[y]))
        city, prov, pair = run.groupings[y]
        fj = fgs_j[y]
        want = model_j.apply(variables, y, mask, fj.city, fj.province,
                             jnp.zeros((1,), jnp.int32), train=False)
        got = model(y, run.masks[y], city, prov,
                    torch.zeros(1, dtype=torch.long), train=False)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=ATOL, err_msg=y)
        batch = np.arange(0, 30, 2, dtype=np.int32)
        want, mutated = model_j.apply(
            variables, y, mask, fj.city, fj.province, jnp.asarray(batch),
            train=True, mutable=["batch_stats"], rows=jnp.asarray(batch),
            pair=jg.PairGrouping.build(fj.city, fj.province)
            if use_intra else None)
        b = torch.from_numpy(batch).long()
        got = model(y, run.masks[y], city, prov, b, train=True, rows=b,
                    pair=pair)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{y} train")
        for bn in ("bn1", "bn2"):
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    _np(getattr(getattr(model.attention, bn), k)),
                    _np(mutated["batch_stats"]["attention"][bn][k]),
                    rtol=RTOL, atol=ATOL, err_msg=f"{y} {bn}.{k}")
        model.load_state_dict(temporal_msha_params_from_jax(variables))


@pytest.mark.parametrize("wd", [5e-4, 0.0], ids=["l2", "no_l2"])
def test_two_epochs_match_jax_at_dropout_0(years, monkeypatch, wd):
    """Every epoch's per-year loss and report, then the parameters, the
    norms' statistics and every table's Adam moments (the other years'
    tables take ``wd * p`` each step, their ``step`` the global count)."""
    fgs_j, fgs_t, maps = years
    kw = dict(DIMS, dropout=0.0, weight_decay=wd, lr=1e-2)
    params0, stats0, _ = jax_temporal.train_temporal_msha(
        fgs_j, maps, epochs=0, **kw)
    params, stats, history_j, opt_j = jax_run(
        monkeypatch, fgs_j, maps, 2, batch_size=BATCH, **kw)
    logs = []
    run = port_run(fgs_t, maps, params0, stats0, log=logs.append, **kw)
    history = fit_temporal(run, 2, BATCH, seed=42, log=logs.append)

    assert [r["year"] for r in logs
            if r["event"] == "temporal_skip_year"] == ["2017"]
    assert len(history) == len(history_j) == 2
    for got, want in zip(history, history_j):
        assert set(got) == set(want) == {"2015", "2016"}
        for y in want:
            assert set(got[y]) == set(want[y])
            np.testing.assert_allclose(got[y]["train_loss"],
                                       want[y]["train_loss"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{y} train_loss")
            for k, v in want[y].items():
                np.testing.assert_allclose(got[y][k], v, atol=REPORT_ATOL,
                                           err_msg=f"{y} {k}")

    model, opt = run.state.model, run.state.optimizer
    model_j = jax_temporal.TemporalMSHA(
        years=tuple(sorted(fgs_j)),
        gdp_by_year={y: fgs_j[y].gdp for y in fgs_j}, n_classes=5,
        dropout=0.0, **DIMS)
    for y in ("2015", "2016"):
        city, prov, _ = run.groupings[y]
        want = model_j.apply(
            {"params": params, "batch_stats": stats}, y,
            jnp.asarray(_np(run.masks[y])), fgs_j[y].city,
            fgs_j[y].province, jnp.zeros((1,), jnp.int32), train=False)
        with torch.no_grad():
            got = model(y, run.masks[y], city, prov,
                        torch.zeros(1, dtype=torch.long), train=False)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{y} scores")
    want_sd = temporal_msha_params_from_jax(
        {"params": params, "batch_stats": stats})
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        if k == "out_att.a" and not wd:
            # its exact gradient is 0 (the output layer's self-concat
            # logits are constant per row, and a row softmax ignores a
            # constant), so at wd 0 Adam turns float noise into steps of
            # +-lr; the scores above show it changes nothing
            continue
        close_rel(got_sd[k], v, k)
    # the empty year's table never moves; its moments do
    np.testing.assert_array_equal(_np(model.table("2017")),
                                  _np(params0["Sfeatures_2017"]))
    adam = adam_state(opt_j)
    steps = run.state.step
    assert steps == int(adam.count) == 2 * (2 * (234 // BATCH))
    for y in ("2015", "2016", "2017"):
        st = opt.state[model.table(y)]
        assert int(st["step"]) == steps
        close_rel(st["exp_avg"], adam.mu[f"Sfeatures_{y}"], f"mu {y}")
        close_rel(st["exp_avg_sq"], adam.nu[f"Sfeatures_{y}"], f"nu {y}")
    if wd:
        assert float(opt.state[model.table("2017")]["exp_avg"].abs().max()) \
            > 0


def test_a_step_keeps_the_other_tables_and_moves_their_moments(years):
    """One step on 2015: 2016's and 2017's values are bit-equal before and
    after, their moments are ``(1 - b) wd p`` (and squared), every step
    count is 1."""
    _, fgs_t, maps = years
    wd = 5e-4
    run = build_temporal(fgs_t, maps, device="cpu", dropout=0.0,
                         weight_decay=wd, **DIMS)
    model = run.state.model
    before = {y: model.table(y).detach().clone() for y in run.years}
    b = torch.arange(16)
    temporal_step(run, "2015", b, torch.from_numpy(run.dst["2015"][:16]))
    assert not torch.equal(model.table("2015"), before["2015"])
    for y in ("2016", "2017"):
        assert torch.equal(model.table(y), before[y])
        st = run.state.optimizer.state[model.table(y)]
        assert int(st["step"]) == 1
        torch.testing.assert_close(st["exp_avg"], 0.1 * wd * before[y])
        torch.testing.assert_close(st["exp_avg_sq"],
                                   0.001 * (wd * before[y]) ** 2)
    assert all(int(s["step"]) == 1
               for s in run.state.optimizer.state.values())


def test_loss_falls_at_dropout_half(years):
    """As ``tests/test_training.py``'s joint test: 6 epochs at lr 0.01,
    each year's best later loss below its first."""
    _, fgs_t, maps = years
    logs = []
    run, history = train_temporal_msha(
        fgs_t, maps, in_features=16, out_features=8, epochs=6,
        batch_size=64, lr=0.01, log=logs.append, device="cpu")
    assert any(r.get("event") == "temporal_skip_year" for r in logs)
    assert set(history[-1]) == {"2015", "2016"}
    sd = run.state.model.state_dict()
    assert sd["Sfeatures_2015"].shape == (40, 16)
    assert "Sfeatures_2017" in sd and "attention.W1" in sd
    for y in ("2015", "2016"):
        first = history[0][y]["train_loss"]
        best = min(h[y]["train_loss"] for h in history[1:])
        assert np.isfinite(best) and best < first, f"{y}: {first} -> {best}"
        assert 0.0 <= history[-1][y]["accuracy"] <= 1.0


def test_loss_is_the_batch_mean_nll(years):
    _, fgs_t, maps = years
    run = build_temporal(fgs_t, maps, device="cpu", dropout=0.0, **DIMS)
    b = torch.arange(8)
    labels = torch.from_numpy(run.dst["2016"][:8])
    city, prov, pair = run.groupings["2016"]
    logp = run.state.model("2016", run.masks["2016"], city, prov, b,
                           train=True, rows=b, pair=pair)
    want = -logp[torch.arange(8), labels].mean()
    torch.testing.assert_close(temporal_loss(run, "2016", b, labels), want)


def raw_records(seed, n_records, provinces, n_nodes=30):
    """Synthetic raw records whose school province follows the home
    province."""
    rng = np.random.default_rng(seed)
    homes = [(f"H{p}", f"C{p}_{c}", f"K{p}_{c}")
             for p in range(4) for c in range(3)]
    nodes = [(*homes[rng.integers(len(homes))], "FM"[rng.integers(2)],
              f"major{rng.integers(6)}", "ab"[rng.integers(2)])
             for _ in range(n_nodes)]
    out = []
    for _ in range(n_records):
        node = nodes[rng.integers(n_nodes)]
        p = int(node[0][1:])
        school = provinces[(p + rng.integers(2)) % len(provinces)]
        out.append(RawRecord(*node, school))
    return out


def write_years(path):
    """2015 and 2016 through ``anonymize`` / ``write_anonymous_dataset``
    with different recipient orders, 2017 without a flow file."""
    gdp = {f"K{p}_{c}": 100.0 * p + c for p in range(4) for c in range(3)}
    write_anonymous_dataset(path, "2015", anonymize(
        raw_records(0, 300, NAMES), gdp))
    write_anonymous_dataset(path, "2016", anonymize(
        raw_records(1, 250, NAMES[::-1]), gdp))
    write_anonymous_dataset(path, "2017", anonymize(
        raw_records(2, 40, NAMES), gdp))
    (path / "Flow2017.csv").unlink()
    return str(path)


def test_cli_train_years(tmp_path, capsys):
    data_dir = write_years(tmp_path / "data")
    log_path = tmp_path / "log.jsonl"
    rc = cli.main(["train", "--years", "2015,2016,2017", "--device", "cpu",
                   "--data_dir", data_dir, "--epochs", "2",
                   "--in_features", "8", "--out_features", "4",
                   "--batch_size", "32", "--log_path", str(log_path)])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"2015", "2016"}
    for y in report:
        assert np.isfinite(report[y]["train_loss"])
        assert 0.0 <= report[y]["accuracy"] <= 1.0
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert {"event": "temporal_skip_year", "year": "2017",
            "reason": "no flow records"} in [
        {k: e[k] for k in ("event", "year", "reason")} for e in events
        if e["event"] == "temporal_skip_year"]
    assert sum(e["event"] == "temporal_epoch" for e in events) == 2


def test_cli_train_years_refuses_other_models(tmp_path, capsys):
    data_dir = write_years(tmp_path / "data")
    rc = cli.main(["train", "--years", "2015,2016", "--model", "gcn",
                   "--device", "cpu", "--data_dir", data_dir])
    assert rc == 2
    assert "MSHA family only" in capsys.readouterr().err
