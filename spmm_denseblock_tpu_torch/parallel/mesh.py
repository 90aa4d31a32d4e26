"""Device mesh helpers (twin of ``spmm_denseblock_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the initialized world, with the JAX package's axis names:

  "row"  - partitions the sparse matrix A by block-row ranges (each rank
           owns a horizontal stripe of A and the matching stripe of C);
  "col"  - partitions the dense operand's feature dimension.

``make_mesh`` keeps "row" as the major (slowest-varying) axis, as the JAX
mesh does, so a row group's ranks are consecutive in a (rows, cols) grid
only along its column. Every exchange of a distributed plan runs on the
process group of its own axis (``mesh.get_group("row")``), never on the
world.

The operands of the plans are plain tensors, one stripe a rank, not
DTensors: a plan's stripes are block-aligned and may be uneven or follow
``balanced_contiguous_boundaries``, which DTensor's even ``Shard`` does
not express. ``row_sharding`` and ``replicated`` return the DTensor
placements that name the same layouts, for callers that build DTensors
from a plan's even stripes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _world_ranks(devices: Optional[Sequence]) -> list:
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "parallel.multihost.initialize() (or init_process_group) first"
        )
    return list(devices if devices is not None else range(dist.get_world_size()))


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("row", "col"),
    devices: Optional[Sequence] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """2D mesh over the world's ranks (or `devices`, a sequence of global
    ranks); defaults to (world size, 1). device_type: "cuda" when a GPU is
    present, else "cpu"."""
    ranks = _world_ranks(devices)
    if shape is None:
        shape = (len(ranks), 1)
    n = shape[0] * shape[1]
    if n > len(ranks):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(ranks)}")
    grid = torch.as_tensor(np.asarray(ranks[:n]).reshape(shape), dtype=torch.int64)
    return DeviceMesh(_device_type(device_type), grid,
                      mesh_dim_names=tuple(axis_names))


def make_mesh_1d(
    n: Optional[int] = None,
    axis: str = "row",
    devices: Optional[Sequence] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """1D mesh of the first `n` ranks (default: all) along `axis`."""
    ranks = _world_ranks(devices)
    if n is None:
        n = len(ranks)
    if n > len(ranks):
        raise ValueError(f"mesh ({n},) needs {n} devices, have {len(ranks)}")
    grid = torch.as_tensor(np.asarray(ranks[:n]), dtype=torch.int64)
    return DeviceMesh(_device_type(device_type), grid, mesh_dim_names=(axis,))


def row_sharding(mesh: DeviceMesh, axis: str = "row") -> tuple:
    """Placements that shard the leading dim over `axis` and replicate
    over the other mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)
