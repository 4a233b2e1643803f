"""The port's benchmarks module (``msha_gnn_torch/bench.py``) against the
JAX package's (``msha_gnn_tpu/bench.py``), on the CPU at small sizes.

The same numpy draws go into both packages.  The kernel benchmarks are
held with ``_timeit`` patched to one constant in both, so every other
number (the byte formulas, the fractions, the CPU peaks) must be equal.
The dense baseline's forward at dropout 0 is held at 1e-5 on log-probs
and its loss's gradients at rtol 1e-4, atol 1e-6 (float32, other
summation orders; the JAX side at ``highest`` matmul precision).  The
sparse attention path runs the kernels' plain versions here; it is held
against the dense path at rtol 1e-5, atol 1e-5 of each value's largest.
The benchmarks that JAX runs only on its real dataset are held by their
keys, read from the JAX source.  Timed loops are cut to a few steps
(``*_SCAN_STEPS``).
"""

import ast
import functools
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.bench as jb
import msha_gnn_tpu.graph as jg
import msha_gnn_torch.bench as tb
import msha_gnn_torch.graph as tg
from msha_gnn_torch import cli
from msha_gnn_torch.models import MSHA, msha_params_from_jax
from tests.test_torch_gcn import make_flow
from tests.test_torch_serving import write_data_dir

IN, OUT, HEADS = 16, 8, 2
N, M, RECORDS = 60, 5, 400


def flow_without_empty_rows(seed, n=N, m=M, records=RECORDS):
    """``flow_arrays``' draws with every source given at least one record
    (a row without edges is uniform on the dense attention path and zero
    on the sparse one)."""
    rng = np.random.default_rng(seed)
    prov = rng.integers(0, 4, n)
    city = rng.integers(0, 8, n)
    src = np.concatenate([np.arange(n), rng.integers(0, n, records - n)]
                         ).astype(np.int32)
    dst = ((prov[src] + rng.integers(0, 2, records)) % m).astype(np.int32)
    gdp = rng.random(n).astype(np.float32)
    return dict(src=src, dst=dst, prov=prov, city=city, gdp=gdp, n=n, m=m,
                pad=32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_data_dir(tmp_path_factory.mktemp("bench"),
                          flow_without_empty_rows(3))


@pytest.fixture
def short_loops(monkeypatch):
    monkeypatch.setattr(tb, "FLAGSHIP_SCAN_STEPS", 4)
    monkeypatch.setattr(tb, "SWEEP_SCAN_STEPS", 3)
    monkeypatch.setattr(tb, "DENSE_SCAN_STEPS", 2)


def jax_keys(fn_name):
    """The string keys a JAX benchmark writes: its dict displays' and its
    ``out["..."] = ...`` stores'."""
    tree = ast.parse(pathlib.Path(inspect.getfile(jb)).read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == fn_name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name) and node.value.id == "out"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


# ---------------------------------------------------------------------------
# the power-law graph and the kernel benchmarks
# ---------------------------------------------------------------------------

def test_powerlaw_graph_matches_jax():
    g_j, x_j = jb.make_powerlaw_graph(300, 200, 5000, d=16)
    g_t, x_t = tb.make_powerlaw_graph(300, 200, 5000, d=16, device="cpu")
    for name in ("senders", "receivers", "weight", "row_ptr"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)),
                                      err_msg=name)
    assert g_t.num_padded_edges == g_j.num_padded_edges
    assert g_t.num_edges == g_j.num_edges == 5000
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    assert x_t.dtype == torch.float32


@pytest.mark.parametrize("kind,impl", [("spmm", "torch"), ("spmm", "cuda"),
                                       ("sddmm", "torch"),
                                       ("sddmm", "cuda")])
def test_kernel_benchmarks_match_jax(monkeypatch, kind, impl):
    """Port ``impl`` against JAX ``impl="xla"`` with both ``_timeit``s
    patched to one constant (each still calls the function once): every
    key but ``impl`` equal."""
    def fake_timeit(fn, *args, **kw):
        fn(*args)
        return 0.125

    monkeypatch.setattr(jb, "_timeit", fake_timeit)
    monkeypatch.setattr(tb, "_timeit", fake_timeit)
    size = dict(n_src=300, n_dst=200, n_edges=5000, d=16)
    want = getattr(jb, f"bench_{kind}")(impl="xla", **size)
    got = getattr(tb, f"bench_{kind}")(impl=impl, device="cpu", **size)
    assert want.pop("impl") == "xla" and got.pop("impl") == impl
    assert got == want
    assert got["seconds"] == 0.125


def test_kernel_benchmark_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="cuda | torch"):
        tb.bench_spmm(300, 200, 5000, d=16, impl="pallas", device="cpu")


def test_cpu_peaks_are_the_jax_packages():
    assert tb.device_peaks("cpu") == jb.device_peaks()
    assert tb.device_peak_flops("cpu") is None
    assert tb.device_name("cpu") == "cpu"
    # the H100 row: the HBM rate and the float32 rate of the kernels'
    # bounds, and the dense bf16 tensor-core peak for the MFU
    assert tb.DEVICE_PEAKS["h100 80gb hbm3"] == (3.35e12, 67e12)
    assert tb.DEVICE_PEAK_FLOPS["h100 80gb hbm3"] == 989.4e12


# ---------------------------------------------------------------------------
# the dense baseline
# ---------------------------------------------------------------------------

def jax_state(seed):
    """Flax-shaped ``{"params", "batch_stats"}`` of an MSHA at IN / OUT /
    HEADS (the tree ``msha_task`` initialises), drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return jnp.asarray(rng.uniform(-0.3, 0.3, shape), jnp.float32)

    bn = {"bias": u(HEADS * OUT), "scale": u(HEADS * OUT) + 1.0}
    params = {
        "Rfeatures": u(M, IN), "Sfeatures": u(N, IN),
        "attention": {"W1": u(HEADS, IN, OUT), "W2": u(HEADS, IN, OUT),
                      "a": u(HEADS, 2 * OUT, 1), "a3": u(HEADS, 2 * OUT, 1),
                      "a4": u(HEADS, 2 * OUT, 1), "bn1": dict(bn),
                      "bn2": dict(bn)},
        "out_att": {"W": u(HEADS * M, M), "a": u(2 * M, 1)},
    }
    stats = {"attention": {b: {"mean": u(HEADS * OUT),
                               "var": u(HEADS * OUT) + 1.0}
                           for b in ("bn1", "bn2")}}
    return {"params": params, "batch_stats": stats}


def jax_unpack(state_params):
    """``msha_gnn_tpu/bench.py:253-262``: the head-stacked ``attention``
    module into the per-head dicts of the dense reference."""
    p_np = jax.tree.map(np.asarray, state_params)
    n_heads = p_np["attention"]["W1"].shape[0]
    params = {
        f"attention_{i}": {
            k: jnp.asarray(v[i]) for k, v in p_np["attention"].items()
            if k in ("W1", "W2", "a", "a3", "a4")
        }
        for i in range(n_heads)
    }
    params["out_att"] = jax.tree.map(jnp.asarray, p_np["out_att"])
    return params


@pytest.fixture(scope="module")
def dense_case():
    """The JAX state and the port's MSHA holding it, their per-head
    unpackings, and the dense forward's inputs (numpy, from a seed)."""
    variables = jax_state(0)
    model = MSHA(IN, OUT, M, HEADS, gdp=torch.zeros(N))
    model.load_state_dict(msha_params_from_jax(variables))
    a = flow_without_empty_rows(5)
    rng = np.random.default_rng(7)
    batch = rng.integers(0, N, 12)
    dense = np.zeros((N, M), np.float32)
    np.add.at(dense, (a["src"], a["dst"]), 1.0)
    inputs = dict(
        s_feat=rng.standard_normal((N, IN)).astype(np.float32),
        r_feat=rng.standard_normal((M, IN)).astype(np.float32),
        inter_adj=dense,
        city_rows=(a["city"][batch][:, None] == a["city"][None, :]
                   ).astype(np.float32),
        prov_rows=(a["prov"][batch][:, None] == a["prov"][None, :]
                   ).astype(np.float32),
        batch=batch.astype(np.int32),
        labels=rng.integers(0, M, 12).astype(np.int32))
    return (jax_unpack(variables["params"]), tb.dense_reference_params(model),
            inputs)


def test_dense_params_unpack_as_jax(dense_case):
    want, got, _ = dense_case
    assert sorted(got) == sorted(want) == ["attention_0", "attention_1",
                                           "out_att"]
    for head in want:
        assert sorted(got[head]) == sorted(want[head])
        for k in want[head]:
            assert got[head][k].requires_grad
            np.testing.assert_array_equal(got[head][k].detach().numpy(),
                                          np.asarray(want[head][k]),
                                          err_msg=f"{head}.{k}")


def _dense_args(inputs, to):
    return [to(inputs[k]) for k in ("s_feat", "r_feat", "inter_adj",
                                    "city_rows", "prov_rows", "batch")]


def _port_loss(params, inputs, generator, dropout=0.0):
    logp = tb.dense_reference_msha_forward(
        params, *_dense_args(inputs, torch.from_numpy)[:5],
        torch.from_numpy(inputs["batch"]).long(), generator, dropout=dropout)
    b = torch.from_numpy(inputs["batch"]).long()
    lab = torch.from_numpy(inputs["labels"]).long()
    return logp, -logp[b].gather(1, lab[:, None]).mean()


def test_dense_forward_and_gradients_match_jax(dense_case):
    params_j, params_t, inputs = dense_case
    args_j = _dense_args(inputs, jnp.asarray)

    def loss_j(params):
        logp = jb.dense_reference_msha_forward(
            params, *args_j, jax.random.key(0), dropout=0.0)
        b, lab = args_j[-1], jnp.asarray(inputs["labels"])
        return -jnp.mean(jnp.take_along_axis(logp[b], lab[:, None], 1)), logp

    (loss_want, logp_want), grads_want = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params_j)
    logp, loss = _port_loss(params_t, inputs, torch.Generator())
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(logp_want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-5)
    leaves = [(h, k) for h in params_t for k in params_t[h]]
    grads = torch.autograd.grad(loss, [params_t[h][k] for h, k in leaves])
    for (h, k), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_want[h][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=f"{h}.{k}")


def test_dense_dropout_follows_the_generator(dense_case):
    _, params, inputs = dense_case

    def run(seed):
        with torch.no_grad():
            return _port_loss(params, inputs, torch.Generator().manual_seed(
                seed), dropout=0.5)[0]

    first, again, other = run(3), run(3), run(4)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    with torch.no_grad():
        clean = _port_loss(params, inputs, torch.Generator())[0]
    assert not torch.equal(first, clean)


# ---------------------------------------------------------------------------
# the attention paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attention_case():
    a = flow_without_empty_rows(11)
    fg_t = make_flow(tg, a)
    g = fg_t.inter
    assert bool(((g.row_ptr[1:] - g.row_ptr[:-1]) > 0).all())
    return a, g, tb.attention_inputs(g, 8)


def test_sparse_attention_path_matches_dense(attention_case):
    _, g, x = attention_case
    ops = tb.attention_operators(g)
    kw = dict(a_src=x["a_src"], a_dst=x["a_dst"])
    dense = functools.partial(tb.attention_dense_path, mask=x["mask"], **kw)
    sparse = functools.partial(tb.attention_sparse_path, ops=ops, **kw)
    grads = [tb.attention_grads(path, x["h1"], x["h2"], x["ct_n"], x["ct_m"])
             for path in (dense, sparse)]
    for want, got in zip((*dense(x["h1"], x["h2"]), *grads[0]),
                         (*sparse(x["h1"], x["h2"]), *grads[1])):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_dense_attention_path_matches_jax(monkeypatch, attention_case):
    """JAX's dense path, which ``bench_flagship_attention_paths`` nests,
    recorded through its ``_timeit_chain`` (the sparse calls skipped), on
    the same graph and draws as the port's."""
    a, g, x = attention_case
    calls = []

    def record(fn, *args, iters=10):
        calls.append((fn, args))
        return 1.0

    monkeypatch.setattr(jb, "_timeit_chain", record)
    monkeypatch.setattr("msha_gnn_tpu.data.load_flow_graph",
                        lambda year: make_flow(jg, a))
    out = jb.bench_flagship_attention_paths(d=8)
    assert out["n"] == g.n_src and out["e_pad"] == g.num_padded_edges
    (fwd, fwd_args), _, (grad, grad_args), _ = calls
    for arg, name in zip(fwd_args, ("h1", "h2")):
        np.testing.assert_array_equal(np.asarray(arg), x[name].numpy())
    dense = functools.partial(tb.attention_dense_path, a_src=x["a_src"],
                              a_dst=x["a_dst"], mask=x["mask"])
    got = (*dense(x["h1"], x["h2"]),
           *tb.attention_grads(dense, x["h1"], x["h2"], x["ct_n"],
                               x["ct_m"]))
    want = (*fwd(*fwd_args), *grad(*grad_args))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_chained_timing_feeds_each_call_the_carry():
    seen = []

    def fn(x, y):
        seen.append(x.clone())
        return (x * y + 1.0, None)

    x0 = torch.zeros(3)
    t = tb._timeit_chain(fn, x0, torch.full((3,), 2.0), iters=4)
    assert t > 0 and len(seen) == 8  # a warm run, then the timed one
    # the carry after the first call: (1 + 1) + 0.5 * 0
    assert torch.equal(seen[0], x0)
    assert torch.equal(seen[1], torch.full((3,), 2e-12))


# ---------------------------------------------------------------------------
# the flagship, the size sweep, serving, run_bench and the CLI
# ---------------------------------------------------------------------------

def test_flagship_returns_jax_keys(data_dir, short_loops):
    out = tb.bench_flagship(batch_size=16, in_features=IN,
                            out_features=OUT, iters=8, data_dir=data_dir,
                            device="cpu")
    assert set(out) == jax_keys("bench_flagship")
    assert (out["n"], out["m"], out["batch_size"]) == (N, M, 16)
    assert out["records_per_s"] == 16 / out["step_seconds"]
    assert out["speedup_vs_dense_reference"] == (
        out["dense_baseline_step_seconds"] / out["step_seconds"])
    assert out["dense_baseline_n"] == N
    assert out["mfu"] is None and out["flops_per_step"] > 0
    for k in ("step_seconds", "single_dispatch_step_seconds",
              "dense_baseline_step_seconds"):
        assert np.isfinite(out[k]) and out[k] > 0


def test_flagship_baseline_cut_scales_to_full_n(data_dir, short_loops,
                                                 monkeypatch):
    seen = {}
    real = tb._timeit

    def spy(fn, *args, **kw):
        seen["t"] = real(fn, *args, **kw)
        return seen["t"]

    monkeypatch.setattr(tb, "_timeit", spy)
    out = tb.bench_flagship(batch_size=8, in_features=IN, out_features=OUT,
                            iters=2, baseline_n=20, data_dir=data_dir,
                            device="cpu")
    assert out["dense_baseline_n"] == 20
    np.testing.assert_allclose(out["dense_baseline_step_seconds"],
                               seen["t"] / tb.DENSE_SCAN_STEPS * N / 20)


def test_size_sweep_returns_jax_keys(short_loops):
    out = tb.bench_flagship_size_sweep(sizes=(200, 400), batch_size=16,
                                       in_features=IN, out_features=OUT,
                                       iters=8, device="cpu")
    assert list(out) == ["200", "400"]
    for n, row in out.items():
        assert set(row) == jax_keys("bench_flagship_size_sweep")
        assert row["records_per_s"] == 16 / row["step_seconds"]
        assert row["ns_per_node_per_step"] == \
            row["step_seconds"] / int(n) * 1e9


def test_serving_returns_jax_keys(data_dir):
    out = tb.bench_serving(batch_size=32, iters=2, data_dir=data_dir,
                           device="cpu")
    assert list(out) == ["full_scores_cache", "per_batch"]
    for row in out.values():
        assert set(row) == jax_keys("bench_serving")
        assert row["predictions_per_s"] == 32 / row["batch_seconds"]


def test_attention_paths_return_jax_keys(data_dir):
    out = tb.bench_flagship_attention_paths(d=8, data_dir=data_dir,
                                            device="cpu")
    assert set(out) == jax_keys("bench_flagship_attention_paths")
    assert (out["n"], out["m"], out["d"]) == (N, M, 8)
    assert out["dense_over_sparse_fwd"] == \
        out["sparse_fwd"] / out["dense_fwd"]


@pytest.mark.parametrize("which", ["all", "flagship", "spmm", "sddmm",
                                   "size_sweep", "scaling"])
def test_run_bench_keys_follow_jax(monkeypatch, which):
    """Both ``run_bench``s with their benchmarks stubbed (and JAX's
    generator setting kept out of the test process): the port's keys are
    JAX's with ``xla`` -> ``torch``, ``pallas`` -> ``cuda`` and no
    ``prng``."""
    for mod in (jb, tb):
        for name in ("bench_flagship", "bench_spmm", "bench_sddmm",
                     "bench_flagship_size_sweep", "bench_scaling"):
            monkeypatch.setattr(mod, name,
                                lambda *a, name=name, **kw: {"of": name})
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    want = jb.run_bench(which)
    got = tb.run_bench(which, device="cpu")
    rename = {"spmm_xla": "spmm_torch", "sddmm_pallas": "sddmm_cuda"}
    want = {rename.get(k, k): v for k, v in want.items() if k != "prng"}
    assert got == {**want, "device": "cpu"}


# bench_scaling at a size the CPU takes in a fraction of a second
SMALL_SCALING = dict(n=64, records=256, batch_size=16, iters=2,
                     in_features=8, out_features=4)


def test_run_bench_refuses_scaling_and_unknown_names(monkeypatch):
    """Scaling runs now (the sharded MSHA step at world size 1); an
    unknown name is still refused."""
    real = tb.bench_scaling
    monkeypatch.setattr(tb, "bench_scaling",
                        lambda **kw: real(**kw, **SMALL_SCALING))
    out = tb.run_bench("scaling", device="cpu")
    assert list(out) == ["device", "scaling"] and list(out["scaling"]) == [
        "1"]
    assert set(out["scaling"]["1"]) == {"step_seconds", "records_per_s",
                                        "scaling_efficiency"}
    with pytest.raises(ValueError, match="unknown benchmark"):
        tb.run_bench("attention", device="cpu")


def test_cli_bench_prints_one_json_line(monkeypatch, capsys):
    seen = {}

    def fake(which, data_dir, device):
        seen.update(which=which, data_dir=data_dir, device=device)
        return {"device": "cpu", "spmm": {"seconds": 0.5}}

    monkeypatch.setattr(tb, "run_bench", fake)
    assert cli.main(["bench", "--which", "spmm", "--device", "cpu",
                     "--data_dir", "somewhere"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"device": "cpu",
                                    "spmm": {"seconds": 0.5}}
    assert seen == dict(which="spmm", data_dir="somewhere", device="cpu")


def test_cli_bench_scaling_exits_2(monkeypatch, capsys):
    """``bench --which scaling`` no longer exits 2: it prints its one JSON
    line and exits 0."""
    real = tb.bench_scaling
    monkeypatch.setattr(tb, "bench_scaling",
                        lambda **kw: real(**kw, **SMALL_SCALING))
    assert cli.main(["bench", "--which", "scaling", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip())
    row = out["scaling"]["1"]
    assert row["scaling_efficiency"] is None
    assert row["records_per_s"] == 16 / row["step_seconds"]
