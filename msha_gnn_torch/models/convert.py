"""Weights from the JAX package into the port's modules.

The flax parameter trees hold numpy-convertible arrays in the same
``[in, out]`` layout the port keeps, so conversion is a renaming.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def gcn_params_from_jax(params: Mapping) -> dict:
    """A flax ``GCN`` ``params`` tree -> the port's ``GCN`` ``state_dict``.

    ``params`` maps ``features`` and ``gc1``/``gc2`` -> ``weight``/``bias``
    to arrays (a ``{"params": ...}`` variables dict is accepted too).
    """
    if "params" in params:
        params = params["params"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"features": t(params["features"])}
    for layer in ("gc1", "gc2"):
        sd[f"{layer}.weight"] = t(params[layer]["weight"])
        sd[f"{layer}.bias"] = t(params[layer]["bias"])
    return sd
