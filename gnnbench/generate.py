"""The one traffic generator: a graph drawn on the device from a mix's
parameters (``traffic/<mix>.json``) and the run's seed.

Two shapes of mix:

* ``"edges"``: that many directed edges, each end drawn from its law,
  optionally delivered in sender order (``"order": "sorted"``);
* ``"pairs"``: that many distinct undirected pairs (self-loops dropped,
  the first distinct pairs in draw order kept), split by ``"split"``
  counts into train / valid / test at random.

A node law is ``{"law": "uniform"}`` or ``{"law": "power", "alpha": a}``
(``p(i)`` proportional to ``(i + 1) ** -a``, drawn by the inverse of its
float64 CDF, the law of the repo's ``build_edges`` at ``a = 1.5``).  The
same seed gives the same graph on the same device; the sizes never depend
on the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sub_seeds(seed: int, n: int = 4) -> List[int]:
    """``n`` independent 31-bit seeds from a run's seed (any whole
    number): graph, parameters, batches, dropout, in that order."""
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(n)
    return [int(v) & 0x7FFFFFFF for v in state]


def draw_nodes(gen: torch.Generator, law: dict, n: int, count: int
               ) -> torch.Tensor:
    """``count`` node ids (int64) on ``gen``'s device under ``law``."""
    dev = gen.device
    if law["law"] == "uniform":
        return torch.randint(0, n, (count,), generator=gen, device=dev)
    if law["law"] == "power":
        p = torch.arange(1, n + 1, dtype=torch.float64, device=dev) \
            .pow(-float(law["alpha"]))
        cdf = torch.cumsum(p / p.sum(), 0)
        u = torch.rand(count, generator=gen, device=dev, dtype=torch.float64)
        return torch.searchsorted(cdf, u).clamp_max_(n - 1)
    raise ValueError(f"unknown node law {law['law']!r}")


def directed_edges(spec: dict, gen: torch.Generator) -> Dict:
    """``spec["edges"]`` directed edges: ``{"senders", "receivers"}``
    int32 on the device, senders drawn first."""
    n, e = int(spec["nodes"]), int(spec["edges"])
    s = draw_nodes(gen, spec["senders"], n, e)
    if spec["senders"].get("order") == "sorted":
        s = torch.sort(s).values
    s = s.to(torch.int32)
    r = draw_nodes(gen, spec["receivers"], n, e).to(torch.int32)
    return {"senders": s, "receivers": r}


def distinct_pairs(spec: dict, gen: torch.Generator) -> Dict:
    """The first ``spec["pairs"]`` distinct undirected pairs ``lo < hi``
    in draw order, drawn in chunks of ``spec["draw_chunk"]``, then split:
    ``{"train", "valid", "test"}``, int64 ``[m, 2]`` on the device."""
    n, target = int(spec["nodes"]), int(spec["pairs"])
    chunk = int(spec.get("draw_chunk", 2 * target))
    keys = torch.empty(0, dtype=torch.int64, device=gen.device)
    while True:
        a = draw_nodes(gen, spec["senders"], n, chunk)
        b = draw_nodes(gen, spec["receivers"], n, chunk)
        keep = a != b
        a, b = a[keep], b[keep]
        keys = torch.cat([keys, torch.minimum(a, b) * n
                          + torch.maximum(a, b)])
        uniq, inv = torch.unique(keys, return_inverse=True)
        if uniq.numel() >= target:
            break
    first = torch.full((uniq.numel(),), keys.numel(), dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(keys.numel(),
                                               device=keys.device), "amin")
    kept = keys[torch.sort(first).values[:target]]
    pairs = torch.stack([kept // n, kept % n], 1)
    sizes = [int(v) for v in spec["split"]]
    if sum(sizes) != target:
        raise ValueError(f"split {sizes} does not add up to {target} pairs")
    perm = torch.randperm(target, generator=gen, device=gen.device)
    out, lo = {}, 0
    for name, size in zip(("train", "valid", "test"), sizes):
        out[name] = pairs[perm[lo:lo + size]]
        lo += size
    return out


def make_graph(spec: dict, seed: int, device) -> Dict:
    """The mix's graph for a graph seed (:func:`sub_seeds`' first), on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if "pairs" in spec:
        return distinct_pairs(spec, gen)
    return directed_edges(spec, gen)
