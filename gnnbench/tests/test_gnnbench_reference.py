"""The plain references against a hand-worked tiny graph (CPU)."""

import math

import numpy as np
import pytest
import torch

from gnnbench.reference import common, linkpred_full, scale_chunked

# sender -> receiver; sender 3 has no edges
S = [0, 0, 1, 2, 2]
R = [1, 2, 2, 0, 1]
N, D = 4, 2
SLOPE = 0.2
FEAT = [[0.3, -0.2], [0.1, 0.4], [-0.5, 0.2], [0.25, 0.05]]
W = [[0.6, -0.1], [0.2, 0.3]]
A = [0.5, -0.4, 0.3, 0.7]
BATCH = ([0, 2], [1, 0], [3, 1], [2, 3])


def hand_loss(feat, w, a):
    """The model of ``reference/scale_chunked.py`` in plain loops."""
    h = [[sum(feat[i][k] * w[k][j] for k in range(D)) for j in range(D)]
         for i in range(N)]
    c = [sum(h[i][j] * a[j] for j in range(D)) for i in range(N)]
    t = [sum(h[i][j] * a[D + j] for j in range(D)) for i in range(N)]
    agg = [[0.0] * D for _ in range(N)]
    for i in range(N):
        edges = [e for e in range(len(S)) if S[e] == i]
        if not edges:
            continue
        logits = []
        for e in edges:
            u = c[i] + t[R[e]]
            logits.append(u if u > 0 else SLOPE * u)
        top = max(logits)
        ws = [math.exp(v - top) for v in logits]
        for e, wv in zip(edges, ws):
            for j in range(D):
                agg[i][j] += wv / sum(ws) * h[R[e]][j]
    z = [[(v if v > 0 else math.exp(v) - 1) + h[i][j]
          for j, v in enumerate(agg[i])] for i in range(N)]

    def score(p, q):
        return sum(z[p][j] * z[q][j] for j in range(D))

    def softplus(x):
        return math.log1p(math.exp(-abs(x))) + max(x, 0.0)

    pos = [softplus(-score(p, q)) for p, q in zip(BATCH[0], BATCH[1])]
    neg = [softplus(score(p, q)) for p, q in zip(BATCH[2], BATCH[3])]
    return sum(pos) / len(pos) + sum(neg) / len(neg)


def test_scale_reference_loss_and_gradients_by_hand():
    p = {"feat": torch.tensor(FEAT, dtype=torch.float64),
         "W": torch.tensor(W, dtype=torch.float64),
         "a": torch.tensor(A, dtype=torch.float64)}
    batch = tuple(torch.tensor(v) for v in BATCH)
    for block in (2, 1 << 22):          # edge blocks that split rows
        loss, grads = scale_chunked.loss_and_grads(
            p, torch.tensor(S), torch.tensor(R), N, batch, SLOPE, block)
        assert float(loss) == pytest.approx(hand_loss(FEAT, W, A), rel=1e-12)
        flat = {"feat": FEAT, "W": W, "a": A}
        for name, value in flat.items():
            arr = np.array(value, dtype=np.float64)
            for idx in np.ndindex(arr.shape):
                step = 1e-6
                hi, lo = arr.copy(), arr.copy()
                hi[idx] += step
                lo[idx] -= step
                args = dict(flat)
                args[name] = hi.tolist()
                f_hi = hand_loss(args["feat"], args["W"], args["a"])
                args[name] = lo.tolist()
                f_lo = hand_loss(args["feat"], args["W"], args["a"])
                want = (f_hi - f_lo) / (2 * step)
                got = float(grads[name][idx])
                assert got == pytest.approx(want, rel=1e-6, abs=1e-9), \
                    (name, idx)


def murmur(slot: int, seed: int) -> float:
    m = 0xFFFFFFFF
    h = (slot * 0x9E3779B9 + (seed & m)) & m
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    return (h & 0xFFFFFF) / float(1 << 24)


def test_keep_scale_is_the_hash_by_hand():
    slots = np.arange(0, 5000, 7)
    for seed in (0, 1, -1, -2**31, 2**31 - 1, 123456789):
        got = linkpred_full.keep_scale(slots, seed, 0.5)
        want = [2.0 if murmur(int(s), seed) >= 0.5 else 0.0 for s in slots]
        assert got.tolist() == want
    kept = (linkpred_full.keep_scale(np.arange(100000), 42, 0.5) > 0).mean()
    assert abs(kept - 0.5) < 0.01


def test_keep_scale_is_the_ports_keep_mask():
    from msha_gnn_torch.ops.cuda.rank1_gat import keep_scale_plain

    slots = np.arange(20000)
    for seed in (0, 7, -5, 2**31 - 1):
        want = keep_scale_plain(torch.from_numpy(slots), torch.tensor(
            [seed], dtype=torch.int32), 0.5).numpy()
        assert np.array_equal(linkpred_full.keep_scale(slots, seed, 0.5),
                              want)


def test_message_graph_is_both_directions_in_csr_order():
    train = np.array([[2, 0], [0, 1], [1, 2], [0, 1]])
    s, r = linkpred_full.message_graph(train, 3)
    assert list(zip(s, r)) == [(0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
                               (2, 1)]


def test_attention_layer_by_hand():
    x = torch.tensor(FEAT, dtype=torch.float64)
    w = torch.tensor(W, dtype=torch.float64)
    a = torch.tensor(A, dtype=torch.float64).reshape(4, 1)
    s, r = torch.tensor(S), torch.tensor(R)
    graph = (s, r, np.arange(len(S)))
    got = linkpred_full.attention(x, w, a, graph, seed=0, rate=0.0,
                                  slope=SLOPE)
    h = (x @ w).tolist()
    for i in range(N):
        edges = [e for e in range(len(S)) if S[e] == i]
        want = [0.0] * D
        if edges:
            u = [sum(h[i][j] * A[j] for j in range(D))
                 + sum(h[R[e]][j] * A[D + j] for j in range(D))
                 for e in edges]
            lg = [v if v > 0 else SLOPE * v for v in u]
            ws = [math.exp(v - max(lg)) for v in lg]
            for e, wv in zip(edges, ws):
                for j in range(D):
                    want[j] += wv / sum(ws) * h[R[e]][j]
        want = [v if v > 0 else math.exp(v) - 1 for v in want]
        assert got[i].tolist() == pytest.approx(want, rel=1e-12, abs=1e-15)


def test_adam_is_torch_adam():
    torch.manual_seed(0)
    p0 = {"x": torch.randn(5, dtype=torch.float64),
          "y": torch.randn(2, 3, dtype=torch.float64)}
    target = {k: torch.randn_like(v) for k, v in p0.items()}

    def loss_and_grads(params, i):
        loss = sum(((params[k] - target[k]) ** 2 * (i + 1)).sum()
                   for k in params)
        grads = {k: 2 * (params[k] - target[k]) * (i + 1) for k in params}
        return loss, grads

    got = common.run_steps(p0, 3, 0.01, loss_and_grads, torch.float64)
    params = {k: v.clone().requires_grad_() for k, v in p0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=0.01)
    for i in range(3):
        opt.zero_grad()
        loss = sum(((params[k] - target[k]) ** 2 * (i + 1)).sum()
                   for k in params)
        loss.backward()
        opt.step()
    for k in params:
        assert got["change_norms"][k] == pytest.approx(
            float((params[k].detach() - p0[k]).norm()), rel=1e-12)
