"""Operations, bytes and peaks: the arithmetic every roofline and mfu
metric divides by, frozen inside the benchmark.

Peaks: NVIDIA's H100 SXM data sheet at the 700 W limit, dense, as in
``spmm_denseblock_tpu_torch/utils/profiling.py`` (commit a9b8f82).
The SpMM bound is ``chip_smoke.py``'s ``csr_bound`` (same commit): each
input byte read once, each output byte written once, whatever route the
program takes.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_S = 3.35e12
# operations/s by the precision a configuration states; "f32" is exact
# float32 on the FFMA units (TF32 off)
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def csr_spmm_ops(nnz: int, f: int) -> int:
    return 2 * nnz * f


def csr_spmm_bytes(nnz: int, n_rows: int, n_cols: int, f: int,
                   value_bytes: int = 4, index_bytes: int = 4,
                   x_bytes: int = 4) -> int:
    """Values and column indices, the row pointer, X read once, Y
    written once."""
    return (nnz * (value_bytes + index_bytes) + (n_rows + 1) * index_bytes
            + n_cols * f * x_bytes + n_rows * f * x_bytes)


def csr_spmm_bound_s(nnz: int, n: int, f: int, precision: str = "f32") -> float:
    """The least time an H100 could take for one n x n CSR SpMM at width f."""
    return max(csr_spmm_ops(nnz, f) / PEAK_OPS_S[precision],
               csr_spmm_bytes(nnz, n, n, f) / HBM_BYTES_S)


def gcn_spmm_widths(dims: Sequence[int], train: bool):
    """Widths of the SpMMs in one request (forward: every layer's input)
    or one training step (also Aᵀ's SpMMs of layers 2.., whose inputs
    need a gradient; layer 1's input needs none)."""
    widths = list(dims[:-1])
    if train:
        widths += list(dims[1:-1])
    return widths


def gcn_flops(nnz: int, n: int, dims: Sequence[int], train: bool) -> int:
    """Model FLOPs of one request or step: per layer 2·nnz·F_in (SpMM)
    + 2·n·F_in·F_out (dense). A step adds each layer's weight gradient
    and, for layers 2.., the input gradient through the dense transform
    and through Aᵀ."""
    total = 0
    for i, (f_in, f_out) in enumerate(zip(dims[:-1], dims[1:])):
        fwd_spmm, dense = 2 * nnz * f_in, 2 * n * f_in * f_out
        total += fwd_spmm + dense
        if train:
            total += dense  # weight gradient
            if i > 0:
                total += dense + fwd_spmm  # input gradient, then Aᵀ
    return total


def gcn_spmm_bound_s(nnz: int, n: int, dims: Sequence[int], train: bool,
                     precision: str = "f32") -> float:
    return sum(csr_spmm_bound_s(nnz, n, f, precision)
               for f in gcn_spmm_widths(dims, train))
