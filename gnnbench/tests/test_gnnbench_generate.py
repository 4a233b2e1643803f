"""The traffic generator's counts and laws at small sizes (CPU)."""

import numpy as np
import pytest
import torch

from gnnbench.generate import draw_nodes, make_graph, sub_seeds

HUB = {"nodes": 3000, "edges": 60000,
       "senders": {"law": "uniform", "order": "sorted"},
       "receivers": {"law": "power", "alpha": 1.5}}
PAIRS = {"nodes": 300, "pairs": 6000, "draw_chunk": 4000,
         "senders": {"law": "power", "alpha": 0.5},
         "receivers": {"law": "power", "alpha": 0.5},
         "split": [4800, 600, 600]}


def power_p(n, alpha):
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    return p / p.sum()


def test_sub_seeds_are_fixed_31_bit_and_take_any_whole_number():
    for seed in (0, 7, 2**31 + 5, 2**40, -3):
        a, b = sub_seeds(seed), sub_seeds(seed)
        assert a == b and len(a) == 4 and len(set(a)) == 4
        assert all(0 <= v < 2**31 for v in a)
    assert sub_seeds(1) != sub_seeds(2)


def test_directed_edges_counts_order_and_hub_share():
    g = make_graph(HUB, 11, "cpu")
    s, r = g["senders"], g["receivers"]
    assert s.dtype == r.dtype == torch.int32
    assert s.numel() == r.numel() == HUB["edges"]
    assert bool((s[1:] >= s[:-1]).all())
    assert int(s.min()) >= 0 and int(s.max()) < HUB["nodes"]
    assert int(r.min()) >= 0 and int(r.max()) < HUB["nodes"]
    p0 = power_p(HUB["nodes"], 1.5)[0]          # about 0.38
    share = float((r == 0).double().mean())
    assert abs(share - p0) < 5 * (p0 * (1 - p0) / HUB["edges"]) ** 0.5
    # uniform senders: every node's count near E / N
    counts = torch.bincount(s.long(), minlength=HUB["nodes"]).double()
    assert abs(float(counts.mean()) - HUB["edges"] / HUB["nodes"]) < 1e-9
    assert float(counts.std()) < 2 * (HUB["edges"] / HUB["nodes"]) ** 0.5


def test_same_seed_same_graph_other_seed_other_graph_same_sizes():
    a, b, c = (make_graph(HUB, seed, "cpu") for seed in (3, 3, 4))
    assert torch.equal(a["senders"], b["senders"])
    assert torch.equal(a["receivers"], b["receivers"])
    assert not torch.equal(a["receivers"], c["receivers"])
    assert a["senders"].numel() == c["senders"].numel()


def test_power_law_draws_follow_their_cdf():
    gen = torch.Generator().manual_seed(0)
    x = draw_nodes(gen, {"law": "power", "alpha": 0.5}, 50, 200000)
    freq = np.bincount(x.numpy(), minlength=50) / 200000
    assert np.abs(freq - power_p(50, 0.5)).max() < 0.003


def test_distinct_pairs_counts_split_and_first_in_draw_order():
    g = make_graph(PAIRS, 5, "cpu")
    parts = [g[k].numpy() for k in ("train", "valid", "test")]
    assert [len(p) for p in parts] == PAIRS["split"]
    every = np.concatenate(parts)
    assert (every[:, 0] < every[:, 1]).all()            # lo < hi, no loops
    keys = every[:, 0] * PAIRS["nodes"] + every[:, 1]
    assert len(np.unique(keys)) == PAIRS["pairs"]       # distinct, disjoint
    # replay the draws: the kept pairs are the first distinct ones
    gen = torch.Generator().manual_seed(5)
    seen, order = set(), []
    while len(order) < PAIRS["pairs"]:
        a = draw_nodes(gen, PAIRS["senders"], PAIRS["nodes"],
                       PAIRS["draw_chunk"]).numpy()
        b = draw_nodes(gen, PAIRS["receivers"], PAIRS["nodes"],
                       PAIRS["draw_chunk"]).numpy()
        for u, v in zip(a, b):
            if u != v:
                k = min(u, v) * PAIRS["nodes"] + max(u, v)
                if k not in seen:
                    seen.add(k)
                    order.append(k)
    assert set(order[: PAIRS["pairs"]]) == set(keys.tolist())


def test_split_sizes_must_add_up():
    with pytest.raises(ValueError):
        make_graph(dict(PAIRS, split=[10, 10, 10]), 0, "cpu")
