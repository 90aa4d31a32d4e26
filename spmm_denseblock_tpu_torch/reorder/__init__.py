from spmm_denseblock_tpu_torch.reorder.base import (
    check_permutation,
    identity,
    invert_permutation,
    permutate,
)
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
    "max_degree_sort",
    "bfs",
    "rcm_variant",
    "rcm_classic",
    "STRATEGIES",
    "reorder",
    "reorder_cached",
]
