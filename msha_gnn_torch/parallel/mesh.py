"""The process mesh and the placement of tensors on it
(``msha_gnn_tpu/parallel/mesh.py``).

The JAX package builds a 2-D logical ``(data, model)`` mesh of devices
and declares shardings on it.  Here one process drives one device and
the processes form a ``torch.distributed`` group (NCCL on CUDA, gloo on
the CPU: the device picks the backend, :func:`~.runtime.initialize`).
:func:`make_mesh` lays the group's ranks out on the one axis that every
operator of this package partitions over, the graph's rows: the JAX
default ``(n, 1)``, pure graph partitioning.  The JAX mesh's ``model``
axis (column sharding) is left out: no operator runs on it.

A :class:`Placement` says which slice of a tensor a rank holds:
:func:`replicated` (all of it) or :func:`data_sharded` (a block of rows).
Blocks are uniform, ``ceil(n / k)`` long, the last one cut at ``n``
(:func:`~.partition.src_block_bounds`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The collective backend of ``device``'s type: NCCL for CUDA, gloo
    for the CPU; raises for any other type."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no collective backend for device type {kind!r}")
    return BACKENDS[kind]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group over the graph's rows: this process's ``rank`` in
    ``group``, the ``world`` size and the device this process drives."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of ``group_rank`` in :attr:`group`."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def block(self, n: int) -> Tuple[int, int, int]:
        """``(lo, hi, blk)``: this rank's block of ``n`` items in ``world``
        uniform blocks of ``blk``."""
        blk = -(-n // self.world) if n else 0
        lo = min(self.rank * blk, n)
        return lo, min(lo + blk, n), blk


def make_mesh(n_devices: Optional[int] = None, *,
              group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """The mesh over ``group``'s ranks (default: the default group, which
    :func:`~.runtime.initialize` makes).

    ``n_devices``, when given, must be the group's size (one process a
    device).  ``device`` defaults to the device the backend implies (the
    current CUDA device for NCCL, the CPU for gloo).  A device whose type
    does not match the group's backend raises: no backend stands in for
    another.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "msha_gnn_torch.parallel.initialize() first")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans its process group, one rank a "
                         f"device: {n_devices} devices asked for, the group "
                         f"has {world} ranks")
    backend = dist.get_backend(group)
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    dev = resolve_device(device)
    if backend_for(dev) != backend:
        raise ValueError(f"device {dev} needs the {backend_for(dev)} "
                         f"backend; the group runs {backend}")
    return Mesh(group=group, rank=rank, world=world, device=dev)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which slice of a tensor a rank of ``mesh`` holds: axis 0 split over
    the ranks when ``rows`` is set, else the whole tensor."""

    mesh: Mesh
    rows: bool = False

    def slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The index of this rank's slice of a tensor of ``shape``."""
        out = [slice(None)] * len(shape)
        if self.rows and len(shape) >= 1:
            lo, hi, _ = self.mesh.block(shape[0])
            out[0] = slice(lo, hi)
        return tuple(out)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (a view)."""
        return t[self.slices(t.shape)]


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def data_sharded(mesh: Mesh, ndim: int = 1) -> Placement:
    """First axis over the ranks, the rest whole (``ndim`` is the JAX
    signature's; a placement holds for any rank of tensor)."""
    del ndim
    return Placement(mesh, rows=True)
