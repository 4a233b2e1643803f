"""msha_gnn_torch — the PyTorch + CUDA port of ``msha_gnn_tpu``.

A second package beside the JAX one, written for one NVIDIA H100.  It
imports ``torch`` and numpy and nothing of JAX or of ``msha_gnn_tpu``: what
it needs from there it keeps as its own copy.  Names follow the JAX
package so a reader finds each counterpart; inside, the code is PyTorch
idiom (``nn.Module``, plain functions on tensors, ``torch.Generator``).

Device rule: every entry point takes ``device`` and defaults to
``"cuda"``.  Without CUDA it raises unless the caller asked for ``"cpu"``;
nothing falls back to the CPU silently.  Every kernel wrapper runs its
plain PyTorch version only for a tensor that lies on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, a bare ``"cuda"`` with the
    current card's index (so it compares equal to its tensors' device);
    raises when CUDA was asked for and is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from .graph import (  # noqa: E402
    BipartiteGraph,
    FlowGraph,
    Grouping,
    PairGrouping,
    dst_degrees,
    from_scipy,
    normalize_by_dst_degree,
    normalize_rows,
    src_degrees,
)

__all__ = [
    "resolve_device",
    "BipartiteGraph",
    "FlowGraph",
    "Grouping",
    "PairGrouping",
    "dst_degrees",
    "from_scipy",
    "src_degrees",
    "normalize_by_dst_degree",
    "normalize_rows",
]
