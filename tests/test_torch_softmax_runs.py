"""The edge-run walk of ``seg_softmax_fwd_f32`` and ``seg_softmax_bwd_f32``
(``msha_gnn_torch/csrc/softmax.cu``), mirrored step by step in plain
PyTorch by ``seg_softmax_fwd_runs_plain`` and ``seg_softmax_bwd_runs_plain``
(runs of slots, head and tail pieces, each run merging the crossing rows
that touch it in run order), against the plain versions and the JAX
package's ``SegmentSoftmaxOperator`` in interpret mode.

The CSR row pointers are drawn by hypothesis (``pointers`` and ``csr`` of
``tests/test_torch_fwd_runs.py``; fixed seed, no example database): empty
rows at the start, in the middle and at the end, a row across several
runs, pad slots past ``ptr[n_rows]`` (NaN in the inputs, never read), and
graphs with no edges at all; with no mask and with an arbitrary mask that
leaves one row fully masked; at several run lengths, 1 included.  Every
slot of ``[0, n_out)`` must be written exactly once (pads as 0), and in
the forward every ``lse`` row too.  Tolerances are the JAX package's own
for this operator (``tests/test_pallas_softmax.py``): ``att`` and ``lse``
at rtol 1e-5, atol 1e-6; ``dl`` at rtol 1e-4, atol 1e-5.  The kernels
themselves are held against the mirrors and the plain versions on the
card (``tests/test_torch_cuda_kernels.py``).

With the attention's dropout folded in (``seg_softmax_fwd_drop`` and
``seg_softmax_bwd_drop``: the keep mask hashed in the walk), the forward's
``att_k`` and the backward's ``dl`` are held bit for bit against the
composition they replace, ``keep_scale_plain`` times the softmax and the
softmax's VJP of the cotangent times ``keep_scale_plain``, in the mirrors,
the plain versions and the operator's autograd; against the JAX operator
times the JAX package's keep mask (``tests/test_rank1_dropout.py``'s host
copy of ``rank1_gat.py::_keep_scale``) at the tolerances above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from msha_gnn_tpu.ops.pallas import SegmentSoftmaxOperator as JaxSoftmax
from msha_gnn_torch.ops.cuda import softmax as sm
from msha_gnn_torch.ops.cuda.rank1_gat import keep_scale_plain
from tests.test_rank1_dropout import host_keep_scale
from tests.test_torch_fwd_runs import csr, pointers
from tests.test_torch_softmax import CASES, case_graph, masks

ATT_RTOL, ATT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def inputs(lengths, pad, seed, masked, scale=3.0):
    """``(ptr, logits, g, mask, n_edges)``: NaN past ``ptr[n_rows]``; the
    mask (if ``masked``) drops about a third of the edges and every edge
    of the longest row."""
    rng = np.random.default_rng(seed)
    ptr, _ = csr(lengths, pad, rng)
    e = int(ptr[-1])
    logits = torch.from_numpy(
        (rng.standard_normal(e + pad) * scale).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(e + pad).astype(np.float32))
    logits[e:] = float("nan")
    g[e:] = float("nan")
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random(e + pad) > 0.3)
        mask[e:] = False
        if e:
            r = int(np.argmax(lengths))
            mask[int(ptr[r]):int(ptr[r + 1])] = False
    return ptr, logits, g, mask, e


def check_walks(ptr, logits, g, mask, e, run):
    """Both mirrors at ``run`` against the plain versions, each output
    written once; returns the mirrors' ``att`` and ``dl``."""
    att, lse, att_writes, lse_writes = sm.seg_softmax_fwd_runs_plain(
        ptr, logits, mask, e, run)
    assert bool((att_writes == 1).all()), f"slots {att_writes.tolist()}"
    assert bool((lse_writes == 1).all()), f"rows {lse_writes.tolist()}"
    want_att, want_lse = sm.seg_softmax_fwd_plain(ptr, logits, mask, e)
    torch.testing.assert_close(att, want_att, rtol=ATT_RTOL, atol=ATT_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=ATT_RTOL, atol=ATT_ATOL)
    assert not att[e:].any()
    if mask is not None:
        assert not att[~mask].any()
    dl, writes = sm.seg_softmax_bwd_runs_plain(ptr, want_att, g, e, run)
    assert bool((writes == 1).all()), f"slots {writes.tolist()}"
    want_dl = sm.seg_softmax_bwd_plain(ptr, want_att, g, e)
    torch.testing.assert_close(dl, want_dl, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not dl[e:].any()
    return att, dl


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("run", [1, 4, 16, 32])
def test_walks_match_plain(run, masked):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16))
    def check(case, seed):
        check_walks(*inputs(*case, seed, masked), run)

    check()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("run", [1, 3, 8])
def test_walk_corners(run, masked):
    """No edges at all (with and without pads), every row empty but the
    last, a single slot, the edges ending on a run boundary with pads after
    it, a row covering whole runs, logits x30."""
    cases = (([0, 0, 0], 0), ([0, 0, 0], 9), ([0, 0, 5], 0), ([1], 0),
             ([0, 8, 0], 3), ([3, 0, 0, 5], 4), ([2, 40, 0, 1], 5))
    for lengths, pad in cases:
        check_walks(*inputs(lengths, pad, 0, masked), run)
    check_walks(*inputs([5, 0, 70, 3], 20, 1, masked, scale=30.0), run)


def test_fully_masked_and_empty_rows_in_the_walk():
    """A fully masked row, inside a run and across runs, like an empty row
    gives zeros and ``lse = NEG + log(1e-30)``: its masked edges take no
    part in its statistics."""
    lengths = [0, 3, 40, 0, 6]
    ptr, logits, _, _, e = inputs(lengths, 5, 2, masked=False)
    mask = torch.ones(e + 5, dtype=torch.bool)
    mask[e:] = False
    mask[int(ptr[1]):int(ptr[3])] = False        # rows 1 and 2
    floor = torch.tensor(sm.NEG) + torch.log(torch.tensor(1e-30))
    for run in (1, 4, 16):
        att, lse, _, _ = sm.seg_softmax_fwd_runs_plain(ptr, logits, mask, e,
                                                       run)
        assert bool((lse[[0, 1, 2, 3]] == floor).all())
        assert not att[:int(ptr[3])].any()
        assert bool(torch.isfinite(lse).all())


def test_walk_pieces_cross_and_merge_in_run_order():
    """The schedule itself: which rows leave pieces and which runs merge
    them (a 40-edge row from slot 3 covers runs 0-5 of 8 slots)."""
    ptr = torch.tensor([0, 3, 43, 45], dtype=torch.int32)
    seen = {"rows": [], "chains": []}

    def reduce(pb, pe):
        return [(pb, pe)]

    def merge(a, b):
        return a + b

    def value(piece):
        if piece is not None and len(piece) > 1:
            seen["chains"].append(tuple(piece))
        return piece

    _ = sm._runs_walk(ptr, 45, 48, 8, reduce, merge, value,
                      lambda pb, pe, val: None,
                      lambda r, val: seen["rows"].append(r))
    # row 1 is merged by every run it touches (0-5), in run order; the run
    # where it begins writes its row value, after grid 1's rows 0 and 2
    chain = ((3, 8), (8, 16), (16, 24), (24, 32), (32, 40), (40, 43))
    assert seen["chains"] == [chain] * 6
    assert seen["rows"] == [0, 2, 1]


def test_tree_merge_brackets_neighbours_in_batches_of_32():
    """A crossing row's pieces merge as a balanced tree over neighbours in
    each batch of 32, the batches left to right."""
    def merge(a, b):
        return f"({a} {b})"

    assert sm._tree_merge(list("abcde"), merge) == "(((a b) (c d)) e)"
    pieces = [str(i) for i in range(34)]
    batch = pieces[:32]
    while len(batch) > 1:
        batch = [merge(batch[i], batch[i + 1])
                 for i in range(0, len(batch), 2)]
    assert sm._tree_merge(pieces, merge) == merge(batch[0], "(32 33)")


@pytest.mark.parametrize("run", [1, 32, 256])
@pytest.mark.parametrize("kind", ["build", "arbitrary"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walks_match_jax_operator(case, kind, run):
    gt, gj = case_graph(case)
    mask = masks(gt, kind)
    rng = np.random.default_rng(len(case) + len(kind) + run)
    e_pad, e = gt.num_padded_edges, gt.num_edges
    logits = (rng.standard_normal(e_pad) * 3).astype(np.float32)
    ct = rng.standard_normal(e_pad).astype(np.float32)
    jop = JaxSoftmax(np.asarray(gj.senders), np.asarray(gj.row_ptr), gj.n_src,
                     mask=mask, interpret=True)
    want, vjp = jax.vjp(jop, jnp.asarray(logits))
    (want_dl,) = vjp(jnp.asarray(ct))

    att, _, att_writes, lse_writes = sm.seg_softmax_fwd_runs_plain(
        gt.row_ptr, torch.from_numpy(logits), torch.from_numpy(mask), e, run)
    assert bool((att_writes == 1).all()) and bool((lse_writes == 1).all())
    np.testing.assert_allclose(att.numpy(), np.asarray(want),
                               rtol=ATT_RTOL, atol=ATT_ATOL)
    dl, writes = sm.seg_softmax_bwd_runs_plain(
        gt.row_ptr, att, torch.from_numpy(ct), e, run)
    assert bool((writes == 1).all())
    np.testing.assert_allclose(dl.numpy(), np.asarray(want_dl),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_mapping_defaults_and_limits():
    """The operator takes the module's run length (a warp a run holds 1 to
    512 slots; other lengths raise) and holds no workspace on the CPU; a
    workspace given to the wrappers must be float32, contiguous, on the
    device and long enough."""
    gt, _ = case_graph("300x120")
    op = sm.SegmentSoftmaxOperator(gt.senders, gt.row_ptr, gt.n_src,
                                   device="cpu")
    assert op.run == sm.RUN and op.ws is None
    assert sm._run_length(None) == sm.RUN
    assert sm._run_length(1) == 1
    assert sm._run_length(sm.MAX_WARP_RUN) == sm.MAX_WARP_RUN
    assert sm.ws_floats(0, 8) == 9 and sm.ws_floats(17, 8) == 27
    for run in (0, sm.MAX_WARP_RUN + 1):
        with pytest.raises(ValueError):
            sm._run_length(run)
    cpu = torch.device("cpu")
    assert sm._workspace(None, 17, 8, cpu).shape == (27,)
    ws = torch.empty(30)
    assert sm._workspace(ws, 17, 8, cpu) is ws
    for bad in (torch.empty(26), torch.empty(27, dtype=torch.float64),
                torch.empty(54)[::2]):
        with pytest.raises(ValueError):
            sm._workspace(bad, 17, 8, cpu)


def check_drop_walks(ptr, logits, g, mask, e, run, seed, rate):
    """The dropout mirrors at ``run`` against the composition they fold,
    bit for bit: ``att`` as without dropout, ``att_k = att * k``, ``dl``
    the VJP of ``g * k``; every slot written once, the pads 0."""
    n_out = logits.numel()
    keep = keep_scale_plain(torch.arange(n_out), seed, rate)
    att, att_k, lse, att_w, lse_w = sm.seg_softmax_fwd_drop_runs_plain(
        ptr, logits, mask, e, seed, rate, run)
    att0, lse0, _, _ = sm.seg_softmax_fwd_runs_plain(ptr, logits, mask, e,
                                                     run)
    assert bool((att_w == 1).all()) and bool((lse_w == 1).all())
    assert torch.equal(att, att0) and torch.equal(lse, lse0)
    assert torch.equal(att_k, att * keep)
    assert not att_k[e:].any() and not att_k[keep == 0].any()
    dl, writes = sm.seg_softmax_bwd_drop_runs_plain(ptr, att, g, e, seed,
                                                    rate, run)
    dl0, _ = sm.seg_softmax_bwd_runs_plain(ptr, att, g * keep, e, run)
    assert bool((writes == 1).all())
    assert torch.equal(dl, dl0) and not dl[e:].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("run", [1, 16, 32])
def test_drop_walks_are_the_composition_bit_for_bit(run, masked):
    @settings(max_examples=4, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(-2**31, 2**31 - 1),
           rate=st.sampled_from([0.25, 0.5]))
    def check(case, seed, rate):
        ptr, logits, g, mask, e = inputs(*case, seed & 0xFFFF, masked)
        dseed = torch.tensor([seed], dtype=torch.int32)
        check_drop_walks(ptr, logits, g, mask, e, run, dseed, rate)

    check()


def test_drop_plain_versions_are_the_composition_bit_for_bit():
    """The wrappers' plain versions (the CPU path): ``att_k`` is the plain
    softmax times the keep mask, ``dl`` the plain VJP of the cotangent
    times it, bit for bit; the wrappers on CPU tensors take them and count
    no launch."""
    ptr, logits, g, _, e = inputs([5, 0, 70, 3, 0, 9], 20, 3, False)
    logits[e:], g[e:] = 0.0, 0.0
    seed = torch.tensor([-123457], dtype=torch.int32)
    keep = keep_scale_plain(torch.arange(logits.numel()), seed, 0.5)
    before = (sm.fwd_launches, sm.bwd_launches, sm.fwd_drop_launches,
              sm.bwd_drop_launches)
    att, att_k, lse = sm.seg_softmax_fwd_drop(ptr, logits, None, e, seed,
                                              0.5)
    want_att, want_lse = sm.seg_softmax_fwd_plain(ptr, logits, None, e)
    assert torch.equal(att, want_att) and torch.equal(lse, want_lse)
    assert torch.equal(att_k, want_att * keep)
    dl = sm.seg_softmax_bwd_drop(ptr, att, g, e, seed, 0.5)
    assert torch.equal(dl, sm.seg_softmax_bwd_plain(ptr, att, g * keep, e))
    assert (sm.fwd_launches, sm.bwd_launches, sm.fwd_drop_launches,
            sm.bwd_drop_launches) == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_softmax_drop_is_the_composition_under_autograd(case):
    """``edge_softmax_drop`` (the materialised layer's attention in
    training) against ``edge_softmax(impl="cuda") * keep_scale_plain``
    through autograd on the CPU: values and the logits' gradient bit for
    bit."""
    from msha_gnn_torch.ops import edge_softmax

    gt, _ = case_graph(case)
    rng = np.random.default_rng(len(case))
    logits = torch.from_numpy((rng.standard_normal(gt.num_padded_edges)
                               * 3).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(gt.num_padded_edges)
                          .astype(np.float32))
    seed = torch.tensor([77], dtype=torch.int32)
    keep = keep_scale_plain(torch.arange(gt.num_padded_edges), seed, 0.5)
    got, want = (logits.clone().requires_grad_() for _ in range(2))
    out = sm.edge_softmax_drop(gt, got, seed, 0.5)
    out.backward(ct)
    ref = edge_softmax(gt, want, impl="cuda") * keep
    ref.backward(ct)
    assert torch.equal(out, ref) and torch.equal(got.grad, want.grad)
    assert not out[gt.num_edges:].any()


@pytest.mark.parametrize("run", [1, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_drop_walks_match_jax_operator_times_its_keep_mask(case, run):
    """The dropout mirrors against the JAX ``SegmentSoftmaxOperator`` in
    interpret mode (with its build's mask, ``senders < n_src``, which the
    port's operator needs no bytes for) times the JAX package's keep mask
    (the host copy of ``_keep_scale``), forward and VJP."""
    gt, gj = case_graph(case)
    rng = np.random.default_rng(len(case) + run)
    e_pad, e = gt.num_padded_edges, gt.num_edges
    logits = (rng.standard_normal(e_pad) * 3).astype(np.float32)
    ct = rng.standard_normal(e_pad).astype(np.float32)
    keep = host_keep_scale(np.arange(e_pad), 4242, 0.5)
    jop = JaxSoftmax(np.asarray(gj.senders), np.asarray(gj.row_ptr), gj.n_src,
                     mask=masks(gt, "build"), interpret=True)
    want, vjp = jax.vjp(lambda l: jop(l) * jnp.asarray(keep),
                        jnp.asarray(logits))
    (want_dl,) = vjp(jnp.asarray(ct))
    seed = torch.tensor([4242], dtype=torch.int32)
    att, att_k, _, _, _ = sm.seg_softmax_fwd_drop_runs_plain(
        gt.row_ptr, torch.from_numpy(logits), None, e, seed, 0.5, run)
    np.testing.assert_allclose(att_k.numpy(), np.asarray(want),
                               rtol=ATT_RTOL, atol=ATT_ATOL)
    dl, _ = sm.seg_softmax_bwd_drop_runs_plain(
        gt.row_ptr, att, torch.from_numpy(ct), e, seed, 0.5, run)
    np.testing.assert_allclose(dl.numpy(), np.asarray(want_dl),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
