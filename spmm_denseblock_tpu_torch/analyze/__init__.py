from spmm_denseblock_tpu_torch.analyze.heatmap import (
    dump_heatmap,
    heatmap,
    load_heatmap,
    plot_heatmap,
)
from spmm_denseblock_tpu_torch.analyze.metrics import (
    DEFAULT_BLOCK_SIZES,
    bandwidth_profile,
    block_metrics,
    calculate_nnzb,
    ell_compact_metrics,
    ell_metrics,
    fill_histogram,
)
from spmm_denseblock_tpu_torch.analyze.molecules import (
    molecule_utilization_study,
    per_graph_reorder,
)

__all__ = [
    "molecule_utilization_study",
    "per_graph_reorder",
    "calculate_nnzb",
    "block_metrics",
    "fill_histogram",
    "bandwidth_profile",
    "ell_metrics",
    "ell_compact_metrics",
    "DEFAULT_BLOCK_SIZES",
    "heatmap",
    "dump_heatmap",
    "load_heatmap",
    "plot_heatmap",
]
