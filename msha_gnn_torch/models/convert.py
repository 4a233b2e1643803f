"""Weights from the JAX package into the port's modules.

The flax parameter trees hold numpy-convertible arrays.  The GCN and GAT
weights keep the JAX ``[in, out]`` layout in the port, so for them
conversion is a renaming; a flax ``Dense`` kernel ``[in, out]`` becomes an
``nn.Linear`` weight ``[out, in]`` by a transpose.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def gcn_params_from_jax(params: Mapping) -> dict:
    """A flax ``GCN`` ``params`` tree -> the port's ``GCN`` ``state_dict``.

    ``params`` maps ``features`` and ``gc1``/``gc2`` -> ``weight``/``bias``
    to arrays (a ``{"params": ...}`` variables dict is accepted too).
    """
    if "params" in params:
        params = params["params"]

    sd = {"features": _tensor(params["features"])}
    for layer in ("gc1", "gc2"):
        sd[f"{layer}.weight"] = _tensor(params[layer]["weight"])
        sd[f"{layer}.bias"] = _tensor(params[layer]["bias"])
    return sd


def linkpred_params_from_jax(params: Mapping) -> dict:
    """The ``{"encoder", "predictor", "features"}`` tree of
    ``msha_gnn_tpu.training.link_prediction.run_link_prediction`` -> the
    ``state_dict`` of the port's ``LinkPredModel``."""
    sd = {"features": _tensor(params["features"])}
    for name, layer in params["encoder"].items():
        sd[f"encoder.{name}.W"] = _tensor(layer["W"])
        sd[f"encoder.{name}.a"] = _tensor(layer["a"])
    for name, dense in params["predictor"].items():
        i = int(name.rsplit("_", 1)[1])
        sd[f"predictor.lins.{i}.weight"] = _tensor(dense["kernel"]).T.contiguous()
        sd[f"predictor.lins.{i}.bias"] = _tensor(dense["bias"])
    return sd
