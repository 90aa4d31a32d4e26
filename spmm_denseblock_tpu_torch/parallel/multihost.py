"""Multi-process setup helpers (twin of
``spmm_denseblock_tpu/parallel/multihost.py``).

The runtime model is SPMD over ``torch.distributed``: every process runs
the same program, one process a rank, and each rank owns one device.
Launch pattern (per process, e.g. under torchrun):

    from spmm_denseblock_tpu_torch.parallel.multihost import initialize, pod_mesh
    initialize(backend="nccl")        # one GPU a rank
    mesh = pod_mesh()                 # ("row", "col") over ALL ranks
    ... the same code on every rank: dist_bsr_spmm_plan(bsr, mesh=mesh) ...

Design notes for the sparse layer:
- The reordering permutation and every layout array are computed on the
  host, deterministically (seeded, see reorder/), so every rank derives
  the same arrays from the same graph file - no broadcast is needed; a
  rank then keeps only its own stripe's arrays, on its own device.
- The collectives in parallel/spmm.py run on the process group of one
  mesh axis, so a "row" exchange never touches the "col" groups. Over
  NVLink or PCIe NCCL moves the bytes; gloo serves CPU ranks, and several
  ranks sharing one GPU (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spmm_denseblock_tpu_torch.parallel.mesh import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: float = 600.0,
) -> None:
    """torch.distributed.init_process_group with torchrun's environment
    as the defaults: coordinator_address "host:port" (MASTER_ADDR and
    MASTER_PORT), num_processes (WORLD_SIZE), process_id (RANK). A
    coordinator_address with a scheme ("tcp://...", "file://...") is
    passed as the init method as it is. A second call is a no-op, as it
    is in the JAX package. backend: "gloo" (CPU ranks, or several ranks
    sharing one GPU) or "nccl" (one GPU a rank)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))


def pod_mesh(
    row_parallelism: Optional[int] = None,
    axis_names: Tuple[str, str] = ("row", "col"),
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """2D mesh over ALL ranks (every process must call this with the same
    arguments). row_parallelism defaults to the world size (pure stripe
    parallelism, col = 1)."""
    n = dist.get_world_size()
    rows = row_parallelism or n
    if n % rows != 0:
        raise ValueError(f"{n} devices not divisible by row_parallelism={rows}")
    return make_mesh((rows, n // rows), axis_names, device_type=device_type)


def is_coordinator() -> bool:
    return dist.get_rank() == 0
