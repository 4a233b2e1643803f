"""The port's distributed operators on K = 1, 2, 4 gloo ranks against the
JAX package's on as many virtual CPU devices (``make_mesh(k,
data_axis=k)``), on the CPU.

Each K spawns its ranks once (``tests/torch_parallel_workers.py``, a
120 s deadline); every rank gathers the operators' outputs and the whole
gradients of ``sum(out * ct)`` (the parameters replicated, the
operators' inputs and outputs each rank's block of rows), and every
rank's are held against the JAX operator's on the same seeded numpy
inputs: ``DistributedSpmm`` and ``RingSpmm`` (forward, transpose, runtime
weights, ``dx``, ``dw``) at ``tests/test_dist_spmm.py``'s 1e-5,
``ShardedCsrSpmm`` against ``ShardedPallasSpmm`` (its Pallas kernels in
interpret mode) at ``tests/test_sharded_pallas.py``'s 1e-4,
``ShardedRank1Gat`` at ``tests/test_rank1_dist.py``'s bounds (out 1e-4 /
1e-5, gradients 2e-3 / 1e-3).  The graphs have empty rows, and neither 61
sources nor 37 recipients divide by 2 or 4.  The host partitioners and
``ring_buckets`` are held against the JAX package's directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import msha_gnn_tpu.graph as jg
import msha_gnn_tpu.parallel as jpar
import msha_gnn_torch.graph as tg
from msha_gnn_torch.data.ring import ring_buckets
from msha_gnn_torch.parallel import (balanced_edge_partition,
                                     partition_edges_by_src,
                                     src_block_bounds)
from tests.torch_parallel_workers import spawn

KS = (1, 2, 4)
N_SRC, N_DST, D, N_SQ = 61, 37, 8, 50
BOUNDS = {"dist": (1e-5, 1e-5), "ring": (1e-5, 1e-5),
          "ring_static": (1e-5, 1e-5), "csr": (1e-4, 1e-4)}
R1_OUT, R1_GRAD = (1e-4, 1e-5), (2e-3, 1e-3)


def _coo(rng, n_src, n_dst, density, empty):
    m = rng.random((n_src, n_dst)) < density
    m[list(empty)] = False
    s, r = np.nonzero(m)
    return dict(s=s, r=r, w=rng.random(len(s)).astype(np.float32),
                n_src=n_src, n_dst=n_dst)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    g = _coo(rng, N_SRC, N_DST, 0.15, (3, 17, 40, 60))
    e_pad = tg.BipartiteGraph.from_coo(g["s"], g["r"], g["w"], n_src=N_SRC,
                                       n_dst=N_DST).num_padded_edges

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(
        graph=g, x=normal(N_DST, D), xt=normal(N_SRC, D),
        ct=normal(N_SRC, D), ctt=normal(N_DST, D),
        w=rng.random(e_pad).astype(np.float32),
        rank1=dict(graph=_coo(rng, N_SQ, N_SQ, 0.1, (0, 25, 49)),
                   c=normal(N_SQ), a=normal(D), x=normal(N_SQ, D),
                   ct=normal(N_SQ, D)))


_PORT, _JAX = {}, {}


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    def run(k):
        if k not in _PORT:
            _PORT[k] = spawn("ops", inputs, k,
                             tmp_path_factory.mktemp(f"ops{k}"))
        return _PORT[k]
    return run


def _jgraph(a):
    return jg.BipartiteGraph.from_coo(a["s"], a["r"], a["w"],
                                      n_src=a["n_src"], n_dst=a["n_dst"])


def _vjp(op, ct, *args, **kw):
    out, vjp = jax.vjp(lambda *a: op(*a, **kw), *args)
    return (out, *vjp(ct))


def _jax_results(inputs, k):
    """Every JAX operator's outputs and gradients at ``k`` devices, in one
    jitted program."""
    mesh = jpar.make_mesh(k, data_axis=k)
    g = _jgraph(inputs["graph"])
    ops = {"dist": jpar.DistributedSpmm(g, mesh),
           "ring": jpar.RingSpmm(g, mesh, runtime_weights=True),
           "ring_static": jpar.RingSpmm(g, mesh),
           "csr": jpar.ShardedPallasSpmm(g, mesh, interpret=True)}
    r1 = inputs["rank1"]
    op_r1 = jpar.ShardedRank1Gat(_jgraph(r1["graph"]), mesh, interpret=True,
                                 negative_slope=0.2)

    def run(x, xt, ct, ctt, w, c, a, x1, ct1):
        res = {}
        for name, op in ops.items():
            out, dx = _vjp(op, ct, x)
            res[f"{name}/static"] = {"out": out, "dx": dx}
            if name == "ring_static":
                continue
            out, dx, dw = _vjp(lambda x, w: op(x, edge_weight=w), ct, x, w)
            res[f"{name}/weighted"] = {"out": out, "dx": dx, "dw": dw}
            if name == "csr":
                continue
            out, dx, dw = _vjp(lambda x, w: op(x, edge_weight=w,
                                                transpose=True), ctt, xt, w)
            res[f"{name}/transpose"] = {"out": out, "dx": dx, "dw": dw}
        out, dc, da, dx = _vjp(op_r1, ct1, c, a, x1)
        res["rank1"] = {"out": out, "dc": dc, "da": da, "dx": dx}
        return res

    args = [inputs[key] for key in ("x", "xt", "ct", "ctt", "w")] + [
        r1[key] for key in ("c", "a", "x", "ct")]
    res = jax.jit(run)(*map(jnp.asarray, args))
    return {name: {key: np.asarray(v) for key, v in r.items()}
            for name, r in res.items()}


@pytest.fixture(scope="module")
def jax_ref(inputs):
    def run(k):
        if k not in _JAX:
            _JAX[k] = _jax_results(inputs, k)
        return _JAX[k]
    return run


CASES = [f"{op}/{kind}" for op in ("dist", "ring")
         for kind in ("static", "weighted", "transpose")] + [
    "ring_static/static", "csr/static", "csr/weighted"]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_spmm_operators_match_jax(port, jax_ref, inputs, k, case):
    want = jax_ref(k)[case]
    rtol, atol = BOUNDS[case.split("/")[0]]
    e = len(inputs["graph"]["s"])  # distinct (s, r) pairs: every edge real
    for rank, res in enumerate(port(k)):
        got = res[case]
        for key, v in want.items():
            g_v, w_v = got[key], v
            if key == "dw":  # pad-edge weight grads: zero on both paths
                g_v, w_v = g_v[:e], w_v[:e]
                np.testing.assert_array_equal(got[key][e:], 0.0)
            np.testing.assert_allclose(g_v, w_v, rtol=rtol, atol=atol,
                                       err_msg=f"{case} {key} rank {rank}")


@pytest.mark.parametrize("k", KS)
def test_sharded_rank1_gat_matches_jax(port, jax_ref, k):
    want = jax_ref(k)["rank1"]
    for rank, res in enumerate(port(k)):
        got = res["rank1"]
        np.testing.assert_allclose(got["out"], want["out"], rtol=R1_OUT[0],
                                   atol=R1_OUT[1])
        for key in ("dc", "da", "dx"):
            np.testing.assert_allclose(got[key], want[key], rtol=R1_GRAD[0],
                                       atol=R1_GRAD[1],
                                       err_msg=f"{key} rank {rank}")
        # a source row with no edges gives zeros, as the JAX operator's
        for row in (0, 25, 49):
            np.testing.assert_array_equal(got["out"][row], 0.0)


@pytest.mark.parametrize("k", KS)
def test_ranks_agree_on_replicated_results(port, k):
    """Every rank holds the same replicated outputs and gradients."""
    runs = port(k)
    for res in runs[1:]:
        for case, r in res.items():
            for key, v in r.items():
                if v is not None:
                    np.testing.assert_array_equal(v, runs[0][case][key])


@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_partitioners_match_jax(inputs, k):
    a = inputs["graph"]
    g_t = tg.BipartiteGraph.from_coo(a["s"], a["r"], a["w"], n_src=N_SRC,
                                     n_dst=N_DST)
    g_j = _jgraph(a)
    np.testing.assert_array_equal(src_block_bounds(N_SRC, k),
                                  jpar.partition.src_block_bounds(N_SRC, k))
    for port_fn, jax_fn in ((partition_edges_by_src,
                             jpar.partition_edges_by_src),
                            (balanced_edge_partition,
                             jpar.balanced_edge_partition)):
        parts_t = port_fn(g_t, k, pad_to_multiple=16)
        parts_j = jax_fn(g_j, k, pad_to_multiple=16)
        assert sum(p.num_edges for p in parts_t) == g_t.num_edges
        for p_t, p_j in zip(parts_t, parts_j, strict=True):
            assert (p_t.n_src, p_t.n_dst, p_t.num_edges) == (
                p_j.n_src, p_j.n_dst, p_j.num_edges)
            for key in ("senders", "receivers", "weight", "row_ptr"):
                np.testing.assert_array_equal(getattr(p_t, key).numpy(),
                                              np.asarray(getattr(p_j, key)))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ring_buckets_match_jax(k):
    """The slots of the JAX package's native bucketer (input order within
    a bucket), and each bucket's edges those of its numpy fallback."""
    from msha_gnn_tpu.data import _native

    rng = np.random.default_rng(k)
    n_src, n_dst, e = 61, 37, 700
    s = np.sort(rng.integers(0, n_src, e)).astype(np.int32)
    r = rng.integers(0, n_dst, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    row_blk, dst_blk = -(-n_src // k), -(-n_dst // k)
    got = ring_buckets(s, r, w, k, row_blk, dst_blk, with_inv=True)
    want = _native.ring_buckets(s, r, w, k, row_blk, dst_blk)
    for g_a, w_a in zip(got[:3], want):
        np.testing.assert_array_equal(g_a, w_a)
    s_b, rl_b, w_b, inv = got
    real = inv < e
    np.testing.assert_array_equal(w_b[real], w[inv[real]])
    np.testing.assert_array_equal(s_b[~real], row_blk)
    assert sorted(inv[real].tolist()) == list(range(e))
