from spmm_denseblock_tpu_torch.bench.timing import time_chained, time_chained_square
from spmm_denseblock_tpu_torch.bench.harness import (
    bench_graph,
    bench_scaling,
    bench_synthetic_bsr,
    bench_synthetic_csr,
    bench_train_scaling,
    bench_train_step,
)
from spmm_denseblock_tpu_torch.bench.sweeps import (
    main,
    sweep_bsrmm,
    sweep_csrmm,
    sweep_graph,
    sweep_scaling,
)

__all__ = [
    "time_chained",
    "time_chained_square",
    "bench_synthetic_bsr",
    "bench_synthetic_csr",
    "bench_graph",
    "bench_scaling",
    "bench_train_scaling",
    "bench_train_step",
    "sweep_bsrmm",
    "sweep_csrmm",
    "sweep_graph",
    "sweep_scaling",
    "main",
]
