"""The port's GCN serving forward against the JAX package's.

The same flow graph (numpy, from a seed) goes into both packages.  The
JAX ``gcn_task(impl="pallas")`` runs its Pallas SpMM in interpret mode on
the CPU; its flax parameters are converted with ``gcn_params_from_jax``
into the port's model, so both compute with the same weights.  Tolerance
rtol 1e-4, atol 1e-5 on the log-probabilities: the Pallas f32 SpMM has
about 2^-16 relative error (a two-pass bf16 hi/lo split).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.training import gcn_task as jax_gcn_task
from msha_gnn_torch.models import gcn_params_from_jax
from msha_gnn_torch.training import gcn_task

RTOL, ATOL = 1e-4, 1e-5


def flow_arrays(seed, n=60, m=5, records=400, pad=32):
    """Recipients follow the source's province, as in the JAX tests."""
    rng = np.random.default_rng(seed)
    prov = rng.integers(0, 4, n)
    city = rng.integers(0, 8, n)
    src = rng.integers(0, n, records).astype(np.int32)
    dst = ((prov[src] + rng.integers(0, 2, records)) % m).astype(np.int32)
    gdp = rng.random(n).astype(np.float32)
    return dict(src=src, dst=dst, prov=prov, city=city, gdp=gdp, n=n, m=m,
                pad=pad)


def make_flow(pkg, a):
    """The same flow graph in ``msha_gnn_tpu.graph`` or
    ``msha_gnn_torch.graph`` (``pkg``)."""
    arr = jnp.asarray if pkg is jg else torch.from_numpy
    inter = pkg.BipartiteGraph.from_coo(
        a["src"], a["dst"], np.ones(len(a["src"]), np.float32),
        n_src=a["n"], n_dst=a["m"], pad_to_multiple=a["pad"])
    return pkg.FlowGraph(
        inter=inter, city=pkg.Grouping.from_ids(a["city"]),
        province=pkg.Grouping.from_ids(a["prov"]), gdp=arr(a["gdp"]),
        edge_src=arr(a["src"]), edge_dst=arr(a["dst"]))


SIZES = {
    "tiny": dict(n=60, m=5, records=400, pad=32),
    "wide": dict(n=300, m=12, records=2500, pad=128),
}


@pytest.fixture(scope="module", params=sorted(SIZES))
def jax_and_port(request):
    a = flow_arrays(1, **SIZES[request.param])
    fg_j, fg_t = make_flow(jg, a), make_flow(tg, a)
    task_j, variables, _ = jax_gcn_task(fg_j, nfeat=16, impl="pallas")
    want = np.asarray(task_j.full_scores(variables))
    return fg_t, task_j, variables, want


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_full_scores_match_jax(jax_and_port, impl):
    fg_t, _, variables, want = jax_and_port
    task, model = gcn_task(fg_t, nfeat=16, impl=impl, device="cpu")
    model.load_state_dict(gcn_params_from_jax(variables["params"]))
    got = task.full_scores(model)
    assert got.shape == want.shape == (fg_t.n_src, fg_t.n_dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.exp().sum(dim=1).numpy(), 1.0, rtol=1e-5)


def test_batch_forward_matches_jax(jax_and_port):
    fg_t, task_j, variables, _ = jax_and_port
    rows = np.asarray([0, 3, fg_t.n_src - 1, 3], np.int32)
    want, _ = task_j.forward(variables, jnp.asarray(rows), train=False,
                             rngs=None)
    task, model = gcn_task(fg_t, nfeat=16, device="cpu")
    model.load_state_dict(gcn_params_from_jax(variables))
    got, mutated = task.forward(model, torch.from_numpy(rows), train=False)
    assert mutated == {}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_model_layout_and_init():
    a = flow_arrays(2)
    task, model = gcn_task(make_flow(tg, a), nfeat=16, seed=5, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {"features": (60, 17), "gc1.weight": (17, 5),
                      "gc1.bias": (5,), "gc2.weight": (5, 5),
                      "gc2.bias": (5,)}
    # the GDP column rides last; the random features are U[0, 1)
    np.testing.assert_array_equal(model.features[:, -1].detach().numpy(),
                                  a["gdp"])
    feats = model.features.detach()[:, :-1]
    assert 0 <= float(feats.min()) and float(feats.max()) < 1
    stdv = 1 / np.sqrt(5)
    for name in ("gc1.weight", "gc1.bias", "gc2.weight", "gc2.bias"):
        assert float(model.state_dict()[name].abs().max()) <= stdv
    # the seed decides the weights
    _, again = gcn_task(make_flow(tg, a), nfeat=16, seed=5, device="cpu")
    _, other = gcn_task(make_flow(tg, a), nfeat=16, seed=6, device="cpu")
    assert torch.equal(model.gc1.weight, again.gc1.weight)
    assert not torch.equal(model.gc1.weight, other.gc1.weight)
    assert task.graph.n_src == 60


def test_full_scores_run_without_grad():
    task, model = gcn_task(make_flow(tg, flow_arrays(3)), nfeat=8,
                           device="cpu")
    out = task.full_scores(model)
    assert not out.requires_grad and torch.is_inference(out)


def test_train_dropout_draws_from_the_generator():
    """GCN's dropout mask comes from the generator it is given: equal seeds
    give equal train-mode outputs, other seeds others, and torch's global
    seed plays no part."""
    task, model = gcn_task(make_flow(tg, flow_arrays(3)), nfeat=8,
                           device="cpu")
    rows = torch.arange(30)

    def train_forward(seed, global_seed):
        torch.manual_seed(global_seed)
        gen = torch.Generator().manual_seed(seed)
        out, _ = task.forward(model, rows, train=True, generator=gen)
        return out.detach()

    first = train_forward(1, 0)
    assert torch.equal(first, train_forward(1, 12345))
    assert not torch.equal(first, train_forward(2, 0))
    evaluated, _ = task.forward(model, rows, train=False)
    assert not torch.equal(first, evaluated.detach())  # the mask acted
