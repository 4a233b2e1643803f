"""The port's attention explanation (``explain.py``, ``cli explain``) and
MSHA's ``record=True`` against the JAX package's, on the CPU.

The same arrays (numpy, from seeds) go into both packages.  The index
lists must equal JAX's exactly, ties included: the recorded attention of
a masked recipient is exactly 0, so most rows tie, and both packages keep
the lower index first.  The recorded attention and intra weights are held
to JAX's ``record=True`` at rtol 1e-4, atol 1e-5 (float32 in another
summation order), with the JAX variables converted by
``msha_params_from_jax``; the npz round trip is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.explain as jax_explain
import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.training import msha_task as jax_msha_task
from msha_gnn_torch import cli
from msha_gnn_torch.explain import (clique_members, extract_attention,
                                    reconstruct_intra_row, record_attention,
                                    run_explain, save_attcoeff_npz,
                                    top_k_per_row)
from msha_gnn_torch.models import msha_params_from_jax
from msha_gnn_torch.training import msha_task
from tests.test_torch_gcn import flow_arrays, make_flow
from tests.test_torch_msha import redraw_norms
from tests.test_torch_serving import PROVINCES, write_data_dir

RTOL, ATOL = 1e-4, 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def tied_attention(seed, n=40, m=6, heads=None):
    """Row softmaxes over a random mask: masked entries exactly 0, some
    rows with every entry masked (uniform), and repeated rows."""
    rng = np.random.default_rng(seed)
    shape = (n, m) if heads is None else (heads, n, m)
    logits = rng.normal(size=shape)
    mask = rng.random(shape) < 0.45
    mask[..., 3, :] = False                  # a row with no recipient
    logits[..., 7, :] = logits[..., 5, :]    # two equal rows
    mask[..., 7, :] = mask[..., 5, :]
    e = np.where(mask, np.exp(logits - logits.max(-1, keepdims=True)), 0.0)
    s = e.sum(-1, keepdims=True)
    att = np.where(s > 0, e / np.where(s > 0, s, 1.0), 1.0 / m)
    return att.astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 6, 40, 100])
def test_top_k_per_row_matches_jax_with_ties(k):
    att = tied_attention(0)
    assert (att == 0).sum() > 50          # ties are the common case
    for mat in (att, att.T):
        kk = min(k, mat.shape[1])
        idx, val = top_k_per_row(torch.from_numpy(mat), kk)
        want_idx, want_val = jax_explain.top_k_per_row(jnp.asarray(mat), kk)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(val, want_val)
        # and from a numpy array
        np.testing.assert_array_equal(top_k_per_row(mat, kk)[0], want_idx)


def test_clique_members_match_jax():
    gid = np.array([0, 1, 0, 2, 1, 0])
    grp = tg.Grouping.from_ids(gid)
    assert clique_members(grp)[0] == [0, 2, 5]
    assert clique_members(grp)[3] == [3]
    assert clique_members(grp, cap=2)[0] == [0, 2]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 9, 200)
    for cap in (None, 1, 5, 100):
        assert clique_members(tg.Grouping.from_ids(ids), cap) == \
            jax_explain.clique_members(jg.Grouping.from_ids(ids), cap)


@pytest.mark.parametrize("top_k", [1, 4, 100])
def test_extract_attention_matches_jax(top_k):
    att = tied_attention(2)
    rng = np.random.default_rng(2)
    city_ids, prov_ids = rng.integers(0, 5, 40), rng.integers(0, 3, 40)
    got = extract_attention(att, tg.Grouping.from_ids(city_ids),
                            tg.Grouping.from_ids(prov_ids), top_k=top_k,
                            member_cap=7)
    want = jax_explain.extract_attention(
        att, jg.Grouping.from_ids(city_ids), jg.Grouping.from_ids(prov_ids),
        top_k=top_k, member_cap=7)
    assert set(got) == set(want)
    for key in want:
        if key.endswith("members"):
            assert got[key] == want[key], key
        else:
            np.testing.assert_array_equal(got[key], want[key], key)
    np.testing.assert_array_equal(got["inter_src_top"][:, 0],
                                  att.argmax(1))


def test_npz_round_trip_matches_jax(tmp_path):
    """Both packages write the same arrays; every dense clique row rebuilt
    from the factored npz is the reference's (the last head's weight over
    the node's clique), per head too."""
    heads, n, m = 3, 12, 5
    rng = np.random.default_rng(4)
    att = tied_attention(4, n=n, m=m, heads=heads)
    city_ids, prov_ids = rng.integers(0, 4, n), rng.integers(0, 2, n)
    cw = rng.random((heads, n)).astype(np.float32) + 0.1
    pw = rng.random((heads, n)).astype(np.float32) + 0.1
    got_path = save_attcoeff_npz(
        str(tmp_path / "port.npz"), att, tg.Grouping.from_ids(city_ids),
        tg.Grouping.from_ids(prov_ids), city_w=cw, prov_w=pw)
    want_path = jax_explain.save_attcoeff_npz(
        str(tmp_path / "jax.npz"), att, jg.Grouping.from_ids(city_ids),
        jg.Grouping.from_ids(prov_ids), city_w=cw, prov_w=pw)
    got, want = np.load(got_path), np.load(want_path)
    assert set(got.files) == set(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], key)
    for i in range(n):
        for channel, gid, w in (("city", city_ids, cw),
                                ("province", prov_ids, pw)):
            dense = np.where(gid == gid[i], w[-1, i], 0.0).astype(np.float32)
            np.testing.assert_array_equal(
                reconstruct_intra_row(got, channel, i), dense)
            np.testing.assert_array_equal(
                reconstruct_intra_row(got, channel, i, head=0),
                jax_explain.reconstruct_intra_row(want, channel, i, head=0))
    # without intra weights: ones, as JAX writes them
    save_attcoeff_npz(str(tmp_path / "none.npz"), att[0],
                      tg.Grouping.from_ids(city_ids),
                      tg.Grouping.from_ids(prov_ids))
    none = np.load(str(tmp_path / "none.npz"))
    assert none["Coeff12_heads"].shape == (1, n, m)
    np.testing.assert_array_equal(none["city_w"], np.ones(n, np.float32))


@pytest.fixture(scope="module")
def flow():
    a = flow_arrays(6, n=80, m=6, records=600)
    return make_flow(jg, a), make_flow(tg, a)


@pytest.mark.parametrize("use_intra", [True, False],
                         ids=["msha", "ablation3"])
def test_record_matches_jax(flow, use_intra):
    """``MSHA(record=True)`` over all rows with ``batch = arange(N)``
    (:func:`record_attention`): log-scores, each head's attention and, with
    the intra channels, its city and province weights."""
    fg_j, fg_t = flow
    task_j, variables, model_j = jax_msha_task(
        fg_j, in_features=16, out_features=8, use_intra=use_intra)
    variables = redraw_norms(variables, 5)
    _, model = msha_task(fg_t, in_features=16, out_features=8,
                         use_intra=use_intra, device="cpu")
    model.load_state_dict(msha_params_from_jax(variables))
    mask = fg_j.inter.to_dense() > 0
    logp_j, aux_j = model_j.apply(
        variables, mask, fg_j.city, fg_j.province,
        jnp.arange(fg_j.n_src, dtype=jnp.int32), train=False, record=True)
    att, cw, pw = record_attention(model, fg_t)
    assert att.shape == (2, fg_t.n_src, fg_t.n_dst)
    np.testing.assert_allclose(att, np.stack([np.asarray(a["att_inter"])
                                              for a in aux_j]),
                               rtol=RTOL, atol=ATOL)
    # exact zeros where the mask is off, in both
    np.testing.assert_array_equal(att[:, ~np.asarray(mask)], 0.0)
    if use_intra:
        for got, key in ((cw, "intra_city_weight"),
                         (pw, "intra_province_weight")):
            np.testing.assert_allclose(
                got, np.stack([np.asarray(a[key]) for a in aux_j]),
                rtol=RTOL, atol=ATOL, err_msg=key)
    else:
        assert cw is None and pw is None and "intra_city_weight" not in \
            aux_j[0]
    mask_t = fg_t.inter.to_dense() > 0
    logp, auxes = model(mask_t, fg_t.city, fg_t.province, torch.arange(10),
                        train=False, record=True)
    assert len(auxes) == 2 and auxes[0]["att_inter"].shape == \
        tuple(mask_t.shape)
    # record=False is the same forward
    torch.testing.assert_close(
        model(mask_t, fg_t.city, fg_t.province, torch.arange(10),
              train=False), logp, rtol=0, atol=0)
    np.testing.assert_allclose(
        _np(model(mask_t, fg_t.city, fg_t.province,
                  torch.arange(fg_t.n_src), train=False, record=True)[0]),
        np.asarray(logp_j), rtol=RTOL, atol=ATOL)


def test_record_in_training_matches_jax_at_dropout_0(flow):
    """The intra weights of a training batch (after their dropout, at rate
    0 the softmax weights themselves)."""
    fg_j, fg_t = flow
    _, variables, model_j = jax_msha_task(fg_j, in_features=16,
                                          out_features=8, dropout=0.0)
    _, model = msha_task(fg_t, in_features=16, out_features=8, dropout=0.0,
                         device="cpu")
    model.load_state_dict(msha_params_from_jax(variables))
    batch = np.arange(3, 60, 4, dtype=np.int32)
    (logp_j, aux_j), _ = model_j.apply(
        variables, fg_j.inter.to_dense() > 0, fg_j.city, fg_j.province,
        jnp.asarray(batch), train=True, record=True, mutable=["batch_stats"],
        rows=jnp.asarray(batch))
    b = torch.from_numpy(batch).long()
    logp, aux = model(fg_t.inter.to_dense() > 0, fg_t.city, fg_t.province,
                      b, train=True, record=True, rows=b)
    np.testing.assert_allclose(_np(logp), np.asarray(logp_j), rtol=RTOL,
                               atol=ATOL)
    for h in range(2):
        for key in ("att_inter", "intra_city_weight",
                    "intra_province_weight"):
            np.testing.assert_allclose(_np(aux[h][key]),
                                       np.asarray(aux_j[h][key]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{h} {key}")


def test_run_explain_end_to_end(tmp_path):
    """``run_explain`` on a written data directory: every head in the npz,
    the JSON's lists the top-K of the recorded attention, names from
    ``Adjacent2015.json``, the reference field the last head's."""
    data_dir = write_data_dir(tmp_path / "data", flow_arrays(7, n=50))
    out, npz_path = str(tmp_path / "explain.json"), str(tmp_path / "a.npz")
    assert run_explain(year="2015", data_dir=data_dir, epochs=1, top_k=3,
                       output=out, batch_size=64, npz_path=npz_path,
                       device="cpu") == out
    npz = np.load(npz_path)
    assert npz["Coeff12_heads"].shape == (2, 50, 5)
    np.testing.assert_array_equal(npz["Coeff12"], npz["Coeff12_heads"][-1])
    assert npz["city_w_heads"].shape == (2, 50)
    data = json.loads(open(out).read())
    assert len(data["InterAttS_heads"]) == 2
    assert data["InterAttS"] == data["InterAttS_heads"][-1]
    idx, _ = top_k_per_row(npz["Coeff12"], 3)
    assert data["InterAttS"]["4"] == [PROVINCES[j] for j in idx[4]]
    rec, _ = top_k_per_row(npz["Coeff12"].T, 3)
    assert data["InterAttR"][PROVINCES[2]] == rec[2].tolist()
    assert len(data["CityAtt"]) == 50 and len(data["ProvinceAtt"]) == 50


def test_cli_explain(tmp_path, capsys):
    data_dir = write_data_dir(tmp_path / "data", flow_arrays(8, n=40))
    out = str(tmp_path / "x.json")
    assert cli.main(["explain", "--data_dir", data_dir, "--device", "cpu",
                     "--epochs", "0", "--output", out,
                     "--model", "ablation3"]) == 0
    assert json.loads(capsys.readouterr().out.strip()) == {"written": out}
    data = json.loads(open(out).read())
    # --top_k 100 by default, cut to the 5 recipients and the 40 sources
    assert len(data["InterAttS"]["0"]) == 5
    assert len(data["InterAttR"][PROVINCES[0]]) == 40
