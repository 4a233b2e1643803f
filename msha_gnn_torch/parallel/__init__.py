"""Multi-GPU edge-partitioned execution over ``torch.distributed``
(``msha_gnn_tpu/parallel/``): one process a device, NCCL on CUDA, gloo on
the CPU.

* :mod:`.runtime`: :func:`initialize` / :func:`shutdown` of the process
  group, checkpoint-resuming training, the device health check, restarts;
* :mod:`.mesh`: the mesh of ranks and the placements;
* :mod:`.partition`: the source-row and edge-balanced partitioners;
* :mod:`.comm`: the collectives and their autograd forms;
* :mod:`.dist_spmm` (``DistributedSpmm``, ``RingSpmm``), :mod:`.csr_spmm`
  (``ShardedCsrSpmm``, the CSR kernels a shard) and :mod:`.rank1_dist`
  (``ShardedRank1Gat``, the fused rank-1 GAT kernels a shard);
* :mod:`.sharded`: the sharded MSHA and link-prediction train steps.

Single-machine launch of ``K`` ranks on ``K`` cards::

    torchrun --nproc_per_node K script.py   # script: initialize(), make_mesh()
"""

from .csr_spmm import ShardedCsrSpmm
from .dist_spmm import DistributedSpmm, RingSpmm
from .mesh import Mesh, Placement, data_sharded, make_mesh, replicated
from .partition import (balanced_edge_partition, partition_edges_by_src,
                        src_block_bounds)
from .rank1_dist import ShardedRank1Gat
from .runtime import (device_health_check, fault_tolerant_fit, initialize,
                      run_with_restarts, shutdown)
from .sharded import (make_sharded_linkpred_step, make_sharded_msha_step,
                      run_one_sharded_step, state_shardings)

__all__ = [
    "Mesh", "Placement", "make_mesh", "replicated", "data_sharded",
    "DistributedSpmm",
    "RingSpmm", "ShardedCsrSpmm", "ShardedRank1Gat",
    "partition_edges_by_src", "balanced_edge_partition", "src_block_bounds",
    "state_shardings", "make_sharded_linkpred_step",
    "make_sharded_msha_step", "run_one_sharded_step", "initialize",
    "shutdown", "fault_tolerant_fit", "device_health_check",
    "run_with_restarts",
]
