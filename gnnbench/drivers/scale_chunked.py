"""Driver of the out-of-core rank-1 GAT link predictor
(``msha_gnn_torch/training/scale.py``).

Set-up is ``scale.build_chunked(..., fused=True)`` on the benchmark's
edges; a step is what ``scale._train`` does: ``scale.draw_batch`` from a
numpy generator, the loss, ``backward``, a ``torch.optim.Adam`` built as
``_train`` builds it.  The loss stays on the device.  The port has no
public step entry for this model, so the step is written out here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..generate import make_graph, sub_seeds


def shape(config: dict, traffic: dict) -> dict:
    return {"nodes": int(traffic["nodes"]), "edges": int(traffic["edges"]),
            "d": int(config["model"]["d"]),
            "batch": int(traffic["batch_edges"])}


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The edges, drawn on the device and copied to the host once, and the
    seeds of the parameters and the batches."""
    graph_seed, param_seed, batch_seed, _ = sub_seeds(seed)
    g = make_graph(traffic, graph_seed, device)
    return {"senders": g["senders"].cpu().numpy(),
            "receivers": g["receivers"].cpu().numpy(),
            "nodes": int(traffic["nodes"]), "param_seed": param_seed,
            "batch_seed": batch_seed}


def initial_params(config: dict, traffic: dict, inp: dict, device) -> dict:
    """``scale._init_params``' law, drawn on the device in one call:
    ``feat`` uniform [0, 1), ``W`` and ``a`` uniform in ``(-g, g)``, ``g =
    1.414 sqrt(6 / 2d)``."""
    n, d = inp["nodes"], int(config["model"]["d"])
    g = 1.414 * (6.0 / (2 * d)) ** 0.5
    gen = torch.Generator(device=device).manual_seed(inp["param_seed"])
    buf = torch.rand(n * d + d * d + 2 * d, generator=gen, device=device)
    feat = buf[: n * d].view(n, d).clone()
    rest = buf[n * d:] * (2 * g) - g
    return {"feat": feat, "W": rest[: d * d].view(d, d).clone(),
            "a": rest[d * d:].clone()}


@dataclasses.dataclass
class State:
    loss_fn: object
    params: dict
    opt: torch.optim.Optimizer
    rng: np.random.Generator
    senders: np.ndarray
    receivers: np.ndarray
    cfg: object
    device: torch.device
    spans: object


def build(config: dict, traffic: dict, inp: dict, params0: dict, device,
          spans) -> State:
    from msha_gnn_torch.training import scale

    model = config["model"]
    cfg = scale.ScaleConfig(d=int(model["d"]), lr=float(model["lr"]),
                            batch_edges=int(traffic["batch_edges"]),
                            negative_slope=float(model["negative_slope"]),
                            precision=model["precision"])
    loss_fn, s, r, _ = scale.build_chunked(
        inp["senders"], inp["receivers"], inp["nodes"], cfg,
        num_slices=config.get("num_slices"), fused=bool(config["fused"]),
        device=device)
    params = {k: v.requires_grad_() for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    return State(loss_fn, params, opt, np.random.default_rng(
        inp["batch_seed"]), s, r, cfg, torch.device(device), spans)


def step(st: State) -> torch.Tensor:
    from msha_gnn_torch.training import scale

    with st.spans("batch"):
        batch = scale.draw_batch(st.rng, st.senders, st.receivers,
                                 len(st.params["feat"]), st.cfg.batch_edges,
                                 st.device)
    loss = st.loss_fn(st.params, *batch)
    st.opt.zero_grad(set_to_none=True)
    loss.backward()
    st.opt.step()
    return loss.detach()


def leaves(st: State) -> dict:
    return st.params


def optimizer(st: State) -> torch.optim.Optimizer:
    return st.opt
