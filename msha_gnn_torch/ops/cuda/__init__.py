"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

The sources live in ``msha_gnn_torch/csrc``; :mod:`._build` compiles them
with ``nvcc`` at first launch.  The names below mirror
``msha_gnn_tpu/ops/pallas/__init__.py`` (``*_pallas`` is ``*_cuda``
here).  They are imported lazily, at first use: importing this package
compiles and loads nothing, and neither does importing the modules
behind the names.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "SpmmOperator": "spmm",
    "FlashGATOperator": "flash_gat",
    "FlashGatOperator": "flash_gat",
    "flash_gat_aggregate": "flash_gat",
    "segment_reduce_sorted": "spmm",
    "spmm_cuda": "spmm",
    "SddmmOperator": "sddmm",
    "Rank1GatOperator": "rank1_gat",
    "SegmentSoftmaxOperator": "softmax",
    "edge_softmax_cuda": "softmax",
    "sddmm_dot_cuda": "sddmm",
    "sddmm_cuda": "sddmm",
    "rank1_logits_fn": "sddmm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
