"""Driver of full-graph GAT link prediction
(``msha_gnn_torch/training/link_prediction.py``).

Set-up is ``data.split_edges`` on the benchmark's split (the message
graph's layout) and ``link_prediction.build_link_prediction``, whose
parameters are then overwritten by the benchmark's own; a step is
``link_prediction.train_step`` on the next batch, with
``link_prediction.epoch_batches`` drawn once an epoch, epochs cycled.
``evaluate`` is not run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..generate import make_graph, sub_seeds


def shape(config: dict, traffic: dict) -> dict:
    m = config["model"]
    return {"nodes": int(traffic["nodes"]),
            "edges": 2 * int(traffic["split"][0]),
            "hidden": int(m["hidden"]), "heads": int(m["n_heads"]),
            "predictor_layers": int(m["num_layers"]),
            "batch": int(traffic["batch_size"])}


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The split's pairs, drawn on the device and copied to the host once,
    and the seeds of the parameters and of the run (its batches and its
    dropout generator)."""
    graph_seed, param_seed, model_seed, _ = sub_seeds(seed)
    g = make_graph(traffic, graph_seed, device)
    out = {k: g[k].cpu().numpy() for k in ("train", "valid", "test")}
    out.update(nodes=int(traffic["nodes"]), param_seed=param_seed,
               model_seed=model_seed)
    return out


def param_shapes(config: dict, n: int) -> dict:
    """Name -> shape of ``LinkPredModel``'s parameters (MLP predictor)."""
    m = config["model"]
    h, heads = int(m["hidden"]), int(m["n_heads"])
    layers = int(m["num_layers"])
    out = {"features": (n, h)}
    for i in range(heads):
        out[f"encoder.attention_{i}.W"] = (h, h)
        out[f"encoder.attention_{i}.a"] = (2 * h, 1)
    out["encoder.out_att.W"] = (heads * h, h)
    out["encoder.out_att.a"] = (2 * h, 1)
    for k in range(layers - 1):
        out[f"predictor.lins.{k}.weight"] = (h, h)
        out[f"predictor.lins.{k}.bias"] = (h,)
    out[f"predictor.lins.{layers - 1}.weight"] = (1, h)
    out[f"predictor.lins.{layers - 1}.bias"] = (1,)
    return out


def initial_params(config: dict, traffic: dict, inp: dict, device) -> dict:
    """The model's initial laws, drawn on the device in two calls:
    ``features`` N(0, 0.1^2); each attention ``W`` [in, out] and ``a``
    [2 out, 1] uniform in ``(-b, b)``, ``b = 1.414 sqrt(6 / (rows +
    cols))``; each linear weight [out, in] a normal truncated at two
    standard deviations with variance ``1 / in`` (by the inverse of the
    normal's CDF); biases 0."""
    shapes = param_shapes(config, inp["nodes"])
    gen = torch.Generator(device=device).manual_seed(inp["param_seed"])
    out = {"features": torch.randn(shapes["features"], generator=gen,
                                   device=device) * 0.1}
    rest = [k for k in shapes if k != "features"]
    sizes = [math.prod(shapes[k]) for k in rest]
    buf = torch.rand(sum(sizes), generator=gen, device=device)
    lo_cdf = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    for k, u in zip(rest, torch.split(buf, sizes)):
        shp = shapes[k]
        if k.endswith(".bias"):
            out[k] = torch.zeros(shp, device=device)
        elif k.startswith("predictor."):
            std = math.sqrt(1.0 / shp[1]) / 0.87962566103423978
            p = lo_cdf + u * (1 - 2 * lo_cdf)
            out[k] = (torch.erfinv(2 * p - 1) * math.sqrt(2) * std) \
                .clamp(-2 * std, 2 * std).view(shp)
        else:
            b = 1.414 * math.sqrt(6.0 / (shp[0] + shp[1]))
            out[k] = (u * (2 * b) - b).view(shp)
    return out


@dataclasses.dataclass
class State:
    run: object
    spans: object
    batches: list
    i: int = 0


def build(config: dict, traffic: dict, inp: dict, params0: dict, device,
          spans) -> State:
    from msha_gnn_torch.data import split_edges
    from msha_gnn_torch.training import link_prediction as lp

    split = split_edges({"n": inp["nodes"], "name": "gnnbench-ddi",
                         "split": {"train": inp["train"],
                                   "valid": inp["valid"],
                                   "test": inp["test"],
                                   "test_neg": np.zeros((0, 2), np.int64)}})
    cfg = lp.LinkPredConfig(**config["model"],
                            batch_size=int(traffic["batch_size"]),
                            seed=inp["model_seed"])
    run = lp.build_link_prediction(split, cfg, device)
    named = dict(run.model.named_parameters())
    if set(named) != set(params0):
        raise RuntimeError(f"parameters {sorted(named)} are not the "
                           f"benchmark's {sorted(params0)}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(params0[k])
    return State(run, spans, [])


def step(st: State) -> torch.Tensor:
    from msha_gnn_torch.training import link_prediction as lp

    if st.i == len(st.batches):
        with st.spans("batch"):
            st.batches = lp.epoch_batches(st.run)
        st.i = 0
    batch = st.batches[st.i]
    st.i += 1
    return lp.train_step(st.run, batch)


def leaves(st: State) -> dict:
    return dict(st.run.model.named_parameters())


def optimizer(st: State) -> torch.optim.Optimizer:
    return st.run.optimizer
