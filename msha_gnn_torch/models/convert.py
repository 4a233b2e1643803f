"""Weights from the JAX package into the port's modules.

The flax parameter trees hold numpy-convertible arrays.  The GCN, GAT,
MSHA and HGANE weights keep the JAX layout in the port, so for them
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


def sparse_gat_layer_params_from_jax(params: Mapping) -> dict:
    """A flax ``SparseGATLayer``'s ``{"W", "a"}`` -> the port's layer
    ``state_dict`` (the same layout: ``W`` [in, out], ``a`` [2 out, 1])."""
    if "params" in params:
        params = params["params"]
    return {"W": _tensor(params["W"]), "a": _tensor(params["a"])}


def _dense(params: Mapping, name: str) -> dict:
    """A flax ``Dense`` ``{"kernel", "bias"}`` -> ``nn.Linear`` entries."""
    return {f"{name}.weight": _tensor(params[name]["kernel"]).T.contiguous(),
            f"{name}.bias": _tensor(params[name]["bias"])}


def gat_params_from_jax(params: Mapping) -> dict:
    """A flax ``GAT`` ``params`` tree (``features`` when learnable, the
    heads ``attention_{i}`` and ``out_att`` with ``W`` and ``a``) -> the
    port's ``GAT`` ``state_dict``."""
    if "params" in params:
        params = params["params"]
    sd = {"features": _tensor(params["features"])} \
        if "features" in params else {}
    for name, layer in params.items():
        if name != "features":
            for k, v in sparse_gat_layer_params_from_jax(layer).items():
                sd[f"{name}.{k}"] = v
    return sd


def sage_params_from_jax(params: Mapping) -> dict:
    """A flax ``GraphSAGE`` ``params`` tree (``Sfeatures``, the ``Dense``
    layers ``linear1`` and ``linear2``) -> the port's ``GraphSAGE``
    ``state_dict``."""
    if "params" in params:
        params = params["params"]
    return {"Sfeatures": _tensor(params["Sfeatures"]),
            **_dense(params, "linear1"), **_dense(params, "linear2")}


def hgane_params_from_jax(variables: Mapping) -> dict:
    """A flax ``HGANELayer``'s variables ``{"params", "batch_stats"}`` ->
    the port's ``HGANELayer`` ``state_dict``: the embeddings, ``W1``,
    ``W2``, ``a12``, ``a3``, and ``bn1``, ``bn2`` with their ``scale``,
    ``bias`` and running ``mean``, ``var``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {k: _tensor(params[k]) for k in (
        "source_embedding", "recipient_embedding", "W1", "W2", "a12", "a3")}
    for bn in ("bn1", "bn2"):
        for k in ("scale", "bias"):
            sd[f"{bn}.{k}"] = _tensor(params[bn][k])
        for k in ("mean", "var"):
            sd[f"{bn}.{k}"] = _tensor(stats[bn][k])
    return sd


def dense_stack_params_from_jax(params: Mapping, prefix: str) -> dict:
    """A flax tree of ``Dense`` layers ``{"<name>_<i>": {"kernel",
    "bias"}}`` (``MLP``'s ``layers_i``, ``LinkPredictor``'s ``lins_i``) ->
    the entries of the port's ``nn.ModuleList`` ``prefix``."""
    sd = {}
    for name, dense in params.items():
        i = int(name.rsplit("_", 1)[1])
        sd[f"{prefix}.{i}.weight"] = _tensor(dense["kernel"]).T.contiguous()
        sd[f"{prefix}.{i}.bias"] = _tensor(dense["bias"])
    return sd


def linkpred_params_from_jax(params: Mapping) -> dict:
    """The ``{"encoder", "predictor", "features"}`` tree (and ``student``
    with KD) of ``msha_gnn_tpu.training.link_prediction.
    run_link_prediction`` -> the ``state_dict`` of the port's
    ``LinkPredModel``."""
    sd = {"features": _tensor(params["features"])}
    for name, layer in params["encoder"].items():
        for k, v in sparse_gat_layer_params_from_jax(layer).items():
            sd[f"encoder.{name}.{k}"] = v
    sd.update(dense_stack_params_from_jax(params["predictor"],
                                          "predictor.lins"))
    if "student" in params:
        sd.update(dense_stack_params_from_jax(params["student"],
                                              "student.layers"))
    return sd


def llp_params_from_jax(trees: Mapping) -> dict:
    """The LLP run's flax trees ``{"student", "predictor", "teacher",
    "teacher_predictor"}`` (each a ``params`` tree or a ``{"params":
    ...}`` variables dict; ``msha_gnn_tpu/training/kd.py`` keeps the first
    two in its optimised tree and the teacher's apart) -> the entries of
    the port's ``LLPModel`` ``state_dict`` (without ``features``, a
    constant of the run)."""
    def params_of(tree):
        return tree["params"] if "params" in tree else tree

    sd = {}
    for name, prefix in (("student", "student.layers"),
                         ("predictor", "predictor.lins"),
                         ("teacher_predictor", "teacher_predictor.lins")):
        sd.update(dense_stack_params_from_jax(params_of(trees[name]), prefix))
    for k, v in gat_params_from_jax(params_of(trees["teacher"])).items():
        sd[f"teacher.{k}"] = v
    return sd



def msha_layer_params_from_jax(params: Mapping,
                               batch_stats: Mapping) -> dict:
    """A flax ``MSHALayer``'s ``params`` (``W1``, ``W2``, ``a``, and
    ``a3``, ``a4`` with the intra channels; ``bn1``, ``bn2`` with ``scale``
    and ``bias``) and ``batch_stats`` (``bn1``, ``bn2`` with ``mean`` and
    ``var``) -> the port's ``MSHALayer`` ``state_dict``."""
    sd = {k: _tensor(params[k]) for k in ("W1", "W2", "a", "a3", "a4")
          if k in params}
    for bn in ("bn1", "bn2"):
        for k in ("scale", "bias"):
            sd[f"{bn}.{k}"] = _tensor(params[bn][k])
        for k in ("mean", "var"):
            sd[f"{bn}.{k}"] = _tensor(batch_stats[bn][k])
    return sd


def msha_params_from_jax(variables: Mapping) -> dict:
    """A flax ``MSHA``'s variables ``{"params", "batch_stats"}`` -> the
    port's ``MSHA`` ``state_dict``: ``Sfeatures``, ``Rfeatures``, the
    layer ``attention`` (:func:`msha_layer_params_from_jax`) and, with the
    output layer, ``out_att`` (``W``, ``a``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {k: _tensor(params[k]) for k in ("Sfeatures", "Rfeatures")}
    for k, v in msha_layer_params_from_jax(params["attention"],
                                           stats["attention"]).items():
        sd[f"attention.{k}"] = v
    if "out_att" in params:
        sd["out_att.W"] = _tensor(params["out_att"]["W"])
        sd["out_att.a"] = _tensor(params["out_att"]["a"])
    return sd


def scale_params_from_jax(params: Mapping) -> dict:
    """The JAX out-of-core model's parameters (``training/scale.py``'s
    ``feat``, ``W``, ``a``) -> the port's: the same names, float32
    tensors."""
    return {k: _tensor(params[k]) for k in ("feat", "W", "a")}
