from spmm_denseblock_tpu_torch.reorder.base import (
    check_permutation,
    identity,
    invert_permutation,
    permutate,
    reorder_per_component,
)
from spmm_denseblock_tpu_torch.reorder.gorder import gorder
from spmm_denseblock_tpu_torch.reorder.greedy import greedy_closest
from spmm_denseblock_tpu_torch.reorder.metis import (
    load_iperm,
    load_partition,
    metis_nd,
    metis_partition_rcm,
    nested_dissection,
    partition_rcm,
)
from spmm_denseblock_tpu_torch.reorder.rabbit import rabbit_order
from spmm_denseblock_tpu_torch.reorder.registry import (
    STRATEGIES,
    reorder,
    reorder_cached,
)
from spmm_denseblock_tpu_torch.reorder.simple import (
    bfs,
    max_degree_sort,
    rcm_classic,
    rcm_variant,
)

__all__ = [
    "permutate",
    "invert_permutation",
    "check_permutation",
    "identity",
    "reorder_per_component",
    "max_degree_sort",
    "bfs",
    "rcm_variant",
    "rcm_classic",
    "gorder",
    "rabbit_order",
    "greedy_closest",
    "metis_nd",
    "metis_partition_rcm",
    "nested_dissection",
    "partition_rcm",
    "load_iperm",
    "load_partition",
    "STRATEGIES",
    "reorder",
    "reorder_cached",
]
