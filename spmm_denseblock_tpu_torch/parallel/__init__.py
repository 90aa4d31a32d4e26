"""Distributed SpMM over torch.distributed (twin of
``spmm_denseblock_tpu/parallel``).

Execution model. The JAX package runs one program over a mesh of
devices with ``shard_map``. The port runs one process a rank, each rank
with its own device (``cuda:{rank % GPUs}`` unless the caller passes
``device=``; ``device="cpu"`` for CPU ranks), and the collectives run on
the process groups of the mesh's axes (``mesh.make_mesh``: a
``DeviceMesh`` with the axes "row" and "col").

- Host prep is deterministic and seeded, so every rank computes the same
  layout arrays (the JAX package's multihost rule); a rank keeps only its
  own stripe's arrays, on its own device.
- A plan's call takes the whole operand on every rank, as the JAX
  plans' ``run(dense)`` does, or only the rank's own row stripe wrapped
  in ``exchange.RowStripe`` (its rows are ``exchange.operand_rows``):
  the JAX plans' "B may be passed with any sharding", which lets a
  layer's output stripe feed the next layer with no gather. The result
  is the rank's row stripe of C on its device; ``exchange.output_rows``
  names its global rows and ``exchange.gather_output`` gathers the whole
  C in caller order onto every rank.
- The backend is the caller's: ``nccl`` needs one GPU a rank; ``gloo``
  serves CPU ranks and several ranks sharing one GPU, copying through
  the host where gloo takes no CUDA tensor, its send/recv (``exchange``,
  chosen by the backend and the collective). Kernels always run on the
  rank's device. The ring posts each step's exchange before the step's
  kernel.
- The operands are plain tensors, not DTensors (``mesh`` says why).
"""

from spmm_denseblock_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_1d,
    row_sharding,
    replicated,
)
from spmm_denseblock_tpu_torch.parallel.shard import (
    ShardedBSR,
    ShardedCSR,
    shard_bsr,
    shard_csr,
    bucket_by_col_chunk,
    shard_stats,
)
from spmm_denseblock_tpu_torch.parallel.multihost import (
    initialize,
    pod_mesh,
    is_coordinator,
)
from spmm_denseblock_tpu_torch.parallel.spmm import (
    dist_bsr_spmm_plan,
    dist_csr_spmm_ell_plan,
    dist_csr_spmm_plan,
    dist_hybrid_spmm_plan,
    dist_windowed_spmm_plan,
    dist_sddmm_plan,
    balanced_block_row_permutation,
)

__all__ = [
    "make_mesh",
    "make_mesh_1d",
    "row_sharding",
    "replicated",
    "ShardedBSR",
    "ShardedCSR",
    "shard_bsr",
    "shard_csr",
    "bucket_by_col_chunk",
    "shard_stats",
    "dist_bsr_spmm_plan",
    "dist_csr_spmm_ell_plan",
    "dist_csr_spmm_plan",
    "dist_hybrid_spmm_plan",
    "dist_windowed_spmm_plan",
    "dist_sddmm_plan",
    "balanced_block_row_permutation",
    "initialize",
    "pod_mesh",
    "is_coordinator",
]
