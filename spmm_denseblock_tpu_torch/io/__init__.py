from spmm_denseblock_tpu_torch.io.datasets import (
    DATASET_PROFILES,
    DATASET_SIZES,
    load_dataset,
    synthetic_powerlaw,
)
from spmm_denseblock_tpu_torch.io.graph_io import (
    cached,
    dump_permutation,
    load_permutation,
)

__all__ = [
    "DATASET_PROFILES",
    "DATASET_SIZES",
    "load_dataset",
    "synthetic_powerlaw",
    "cached",
    "dump_permutation",
    "load_permutation",
]
