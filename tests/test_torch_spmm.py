"""The port's SpMM against the JAX package's Pallas SpMM.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode.  ``hub_split=0`` forces ``_visit_kernel`` and
``hub_split=128`` forces ``_hub_kernel``, the two TPU kernels that the
port's ``csr_spmm_f32`` replaces.  The port side runs the plain SpMM
(``impl="torch"``) and the operator of the CUDA kernel on CPU tensors
(``impl="cuda"``), which takes the kernel's plain version but keeps the
operator's CSR/CSC bookkeeping under test.

Tolerance rtol 1e-4, atol 1e-5: the Pallas f32 path is a two-pass bf16
hi/lo split with about 2^-16 error relative to the terms it sums
(``spmm.py:41-45``).  That is relative to the result only where no sum
cancels, so the inputs are non-negative: the weights are the path's own,
flow counts normalised by column, and x is U[0, 1) like the GCN's input
features.  Signed inputs are held against dense products below.  The kernel itself is held
against its plain version on the card (``cuda`` marker), at rtol 1e-5 and
atol 1e-6 for a different float32 summation order.

The gradient of a runtime edge weight is held against the JAX VJP with
the same tolerance and non-negative inputs: the JAX side's SDDMM (and its
fused dx + dw kernels) gather through the same bf16 hi/lo split
(``spmm.py:1446-1450``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas.spmm import SpmmOperator as JaxSpmmOperator
from msha_gnn_torch.ops import spmm
from msha_gnn_torch.ops.cuda import _build
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

RTOL, ATOL = 1e-4, 1e-5


def skewed_coo(seed, n_src=300, n_dst=150, e=2500, alpha=1.3):
    """Power-law column degrees, as in the JAX hub-split tests; unique
    edges weighted by their record count over their column's total."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_dst + 1) ** alpha
    p /= p.sum()
    key, counts = np.unique(
        rng.integers(0, n_src, e) * n_dst + rng.choice(n_dst, e, p=p),
        return_counts=True)
    src, dst = key // n_dst, key % n_dst
    col_total = np.bincount(dst, weights=counts, minlength=n_dst)
    w = (counts / col_total[dst]).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def graphs():
    src, dst, w = skewed_coo(0)
    kw = dict(n_src=300, n_dst=150, pad_to_multiple=128)
    return (tg.BipartiteGraph.from_coo(src, dst, w, **kw),
            jg.BipartiteGraph.from_coo(src, dst, w, **kw))


@pytest.fixture(scope="module")
def jax_ops(graphs):
    _, gj = graphs
    return {hub: JaxSpmmOperator.build(gj, interpret=True, hub_split=hub)
            for hub in (0, 128)}


@pytest.mark.parametrize("d", [32, 129])
@pytest.mark.parametrize("weights", ["static", "runtime"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("hub", [0, 128], ids=["visit_kernel", "hub_kernel"])
def test_spmm_matches_pallas(graphs, jax_ops, hub, transpose, weights, d):
    gt, gj = graphs
    op = jax_ops[hub]
    if hub:
        assert op.fwd_split is not None and op.fwd_split.hub is not None
    else:
        assert op.fwd_split is None
    rng = np.random.default_rng(d + 7 * transpose)
    x = rng.random((gt.n_src if transpose else gt.n_dst, d)
                   ).astype(np.float32)
    ew = None
    if weights == "runtime":
        # the static weights, each scaled by a random factor in [0.5, 1.5)
        ew = gt.weight.numpy() * (0.5 + rng.random(gt.num_padded_edges)
                                  ).astype(np.float32)
    want = np.asarray(op(jnp.asarray(x), transpose=transpose,
                         edge_weight=None if ew is None else jnp.asarray(ew)))
    for impl in ("torch", "cuda"):
        got = spmm(gt, torch.from_numpy(x), transpose=transpose, impl=impl,
                   edge_weight=None if ew is None else torch.from_numpy(ew))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=impl)


def test_plain_matches_dense_with_empty_rows():
    rng = np.random.default_rng(1)
    dense = (rng.random((40, 9)) < 0.2) * rng.standard_normal((40, 9))
    dense[[0, 17, 39]] = 0.0
    dense[:, 3] = 0.0
    g = tg.BipartiteGraph.from_dense(dense.astype(np.float32),
                                     pad_to_multiple=16)
    op = cuda_spmm.SpmmOperator(g, device="cpu")
    x = rng.standard_normal((9, 5)).astype(np.float32)
    xt = rng.standard_normal((40, 5)).astype(np.float32)
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(), dense @ x,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        op(torch.from_numpy(xt), transpose=True).numpy(), dense.T @ xt,
        rtol=1e-5, atol=1e-5)


def test_operator_csc_arrays_and_permutation(graphs):
    gt, _ = graphs
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    e = gt.num_edges
    s, r = gt.senders[:e].long(), gt.receivers[:e].long()
    perm = op.t_edge
    # CSC order: sorted by (receiver, sender), every edge once
    assert sorted(perm.tolist()) == list(range(e))
    key = r[perm] * gt.n_src + s[perm]
    assert bool((key[1:] > key[:-1]).all())
    np.testing.assert_array_equal(op.t_col.numpy(), s[perm].numpy())
    np.testing.assert_array_equal(op.t_w.numpy(), gt.weight[:e][perm].numpy())
    counts = np.bincount(r.numpy(), minlength=gt.n_dst)
    np.testing.assert_array_equal(np.diff(op.t_ptr.numpy()), counts)
    assert op.ptr.dtype == op.col.dtype == op.t_ptr.dtype == torch.int32
    assert op.t_edge.dtype == torch.int32


def test_cpu_tensors_take_the_plain_version_and_count_nothing(graphs):
    gt, _ = graphs
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    before = cuda_spmm.launches
    x = torch.randn(gt.n_dst, 4, generator=torch.Generator().manual_seed(0))
    want = cuda_spmm.csr_spmm_plain(op.ptr, op.col, op.w, x, gt.n_src)
    assert torch.equal(op(x), want)
    assert cuda_spmm.launches == before
    assert op.launches == op.launches_transposed == 0
    with pytest.raises(ValueError):
        op(torch.zeros(gt.n_dst + 1, 4))


def test_cpu_runtime_weights_keep_autograd(graphs):
    """On the CPU the plain version is differentiable, as JAX's is."""
    gt, _ = graphs
    x = torch.randn(gt.n_dst, 3, requires_grad=True)
    spmm(gt, x, impl="cuda").sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


@pytest.mark.parametrize("weights", ["static", "runtime"])
@pytest.mark.parametrize("transpose", [False, True])
def test_x_gradient_matches_pallas_vjp(graphs, jax_ops, transpose, weights):
    """``x.grad`` through the operator's autograd (the other direction's
    launch of the kernel) against the JAX operator's VJP."""
    import jax

    gt, _ = graphs
    rng = np.random.default_rng(3 + 2 * transpose)
    n_in, n_out = (gt.n_src, gt.n_dst) if transpose else (gt.n_dst, gt.n_src)
    x = rng.random((n_in, 16)).astype(np.float32)
    ct = rng.random((n_out, 16)).astype(np.float32)
    ew = None
    if weights == "runtime":
        ew = gt.weight.numpy() * (0.5 + rng.random(gt.num_padded_edges)
                                  ).astype(np.float32)
    op_j = jax_ops[0]
    _, vjp = jax.vjp(
        lambda x: op_j(x, transpose=transpose,
                       edge_weight=None if ew is None else jnp.asarray(ew)),
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out = op(xt, transpose=transpose,
             edge_weight=None if ew is None else torch.from_numpy(ew))
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_bwd_ops(graphs):
    _, gj = graphs
    return {(hub, fused): JaxSpmmOperator.build(gj, interpret=True,
                                                hub_split=hub,
                                                fused_bwd=fused)
            for hub in (0, None) for fused in (False, True)}


@pytest.mark.parametrize("fused_bwd", [False, True],
                         ids=["sddmm_dw", "fused_dw"])
@pytest.mark.parametrize("hub", [0, None], ids=["no_hub", "auto_hub"])
@pytest.mark.parametrize("transpose", [False, True])
def test_weight_gradient_matches_pallas_vjp(graphs, jax_bwd_ops, transpose,
                                            hub, fused_bwd, monkeypatch):
    """``dw`` and ``dx`` of a runtime edge weight against the JAX operator's
    VJP, each backward mode against its counterpart: ``fused_bwd=False``,
    the port's ``csr_spmm_f32`` + ``csr_sddmm_f32`` against the JAX SDDMM
    kernels, and ``fused_bwd=True``, the port's one ``csr_spmm_dw_f32``
    against the JAX fused dx + dw kernels (``_visit_dw_kernel``,
    ``_hub_dw_kernel``); the kernels' plain versions here."""
    import jax

    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm

    calls = []
    for mod, name in ((cuda_spmm, "csr_spmm_dw"), (cuda_sddmm, "csr_sddmm")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=real, _n=name:
                            calls.append(_n) or _f(*a))

    gt, _ = graphs
    rng = np.random.default_rng(11 + 2 * transpose)
    n_in, n_out = (gt.n_src, gt.n_dst) if transpose else (gt.n_dst, gt.n_src)
    x = rng.random((n_in, 24)).astype(np.float32)
    ct = rng.random((n_out, 24)).astype(np.float32)
    ew = gt.weight.numpy() * (0.5 + rng.random(gt.num_padded_edges)
                              ).astype(np.float32)
    op_j = jax_bwd_ops[(hub, fused_bwd)]
    _, vjp = jax.vjp(lambda x, w: op_j(x, transpose=transpose,
                                       edge_weight=w),
                     jnp.asarray(x), jnp.asarray(ew))
    want_dx, want_dw = (np.asarray(v) for v in vjp(jnp.asarray(ct)))
    op = cuda_spmm.SpmmOperator(gt, device="cpu", fused_bwd=fused_bwd)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(ew).requires_grad_()
    op(xt, transpose=transpose, edge_weight=wt).backward(torch.from_numpy(ct))
    assert calls == (["csr_spmm_dw"] if fused_bwd else ["csr_sddmm"])
    assert wt.grad.shape == wt.shape
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=RTOL,
                               atol=ATOL)
    assert not wt.grad[gt.num_edges:].any()    # pad slots get no gradient


def test_reduce_edges_sums_rows_into_receivers(graphs):
    gt, _ = graphs
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    z = torch.randn(gt.num_edges, 5, generator=torch.Generator().manual_seed(1))
    want = torch.zeros(gt.n_dst, 5).index_add_(
        0, gt.receivers[: gt.num_edges].long(), z)
    torch.testing.assert_close(op.reduce_edges(z), want, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        op.reduce_edges(z[:-1])


def test_null_weights_are_unit_weights(graphs):
    gt, _ = graphs
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    x = torch.randn(gt.n_dst, 3, generator=torch.Generator().manual_seed(2))
    ones = torch.ones(op.num_edges)
    got = cuda_spmm.csr_spmm(op.ptr, op.col, None, x, gt.n_src)
    want = cuda_spmm.csr_spmm_plain(op.ptr, op.col, ones, x, gt.n_src)
    assert torch.equal(got, want)


def test_build_layout_and_failure(tmp_path, monkeypatch):
    assert _build.sources() == ["flash_gat", "rank1_gat", "sddmm", "softmax",
                                "spmm"]
    path = _build.library_path("spmm")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.parent.parts[-2:] == ("build", "msha_gnn_torch")
    # a failing compiler raises with its output, and leaves no library
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/spmm.cu"):
        _build.build(["spmm"])
    assert not _build.library_path("spmm").exists()


def test_library_names_hash_the_shared_header(tmp_path, monkeypatch):
    """Every library's name hashes ``csrc/*.cuh`` too, so an edit of the
    dropout hash in ``gat_common.cuh`` rebuilds both GAT sources."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.sources()}
    with open(tmp_path / "gat_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    for name in ("flash_gat.cu", "rank1_gat.cu"):
        assert '#include "gat_common.cuh"' in (tmp_path / name).read_text()


def test_unknown_impl_raises(graphs):
    gt, _ = graphs
    with pytest.raises(ValueError, match="unknown spmm impl"):
        spmm(gt, torch.zeros(gt.n_dst, 2), impl="xla")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(graphs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gt, _ = graphs
    g = gt.to("cuda")
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for transpose, n_in in ((False, g.n_dst), (True, g.n_src)):
        for d in (32, 129):
            x = torch.randn(n_in, d, generator=gen, device="cuda")
            ptr, col, w = ((op.t_ptr, op.t_col, op.t_w) if transpose
                           else (op.ptr, op.col, op.w))
            n_rows = g.n_dst if transpose else g.n_src
            before = cuda_spmm.launches
            got = op(x, transpose=transpose)
            assert cuda_spmm.launches == before + 1
            want = cuda_spmm.csr_spmm_plain(ptr, col, w, x, n_rows)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # x gradients: the transposed launch of the same kernel
    for transpose, n_in in ((False, g.n_dst), (True, g.n_src)):
        x = torch.randn(n_in, 8, generator=gen, device="cuda",
                        requires_grad=True)
        gout = torch.randn(g.n_src if not transpose else g.n_dst, 8,
                           generator=gen, device="cuda")
        before = cuda_spmm.launches
        op(x, transpose=transpose).backward(gout)
        assert cuda_spmm.launches == before + 2
        want = op(gout, transpose=not transpose)
        torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-6)
    # runtime weights that need a gradient: dw from csr_sddmm_f32
    from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm

    for transpose, n_in in ((False, g.n_dst), (True, g.n_src)):
        x = torch.rand(n_in, 8, generator=gen, device="cuda")
        w = g.weight.clone().requires_grad_()
        gout = torch.rand(g.n_src if not transpose else g.n_dst, 8,
                          generator=gen, device="cuda")
        before = cuda_sddmm.launches
        op(x, transpose=transpose, edge_weight=w).backward(gout)
        assert cuda_sddmm.launches == before + 1
        rows, cols = (x, gout) if transpose else (gout, x)
        want = cuda_sddmm.csr_sddmm_plain(op.ptr, op.col, rows, cols,
                                          g.num_padded_edges)
        torch.testing.assert_close(w.grad, want, rtol=1e-5, atol=1e-6)
