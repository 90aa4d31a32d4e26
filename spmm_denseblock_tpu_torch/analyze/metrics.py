"""Block-structure analytics in vectorized numpy (twin of
``spmm_denseblock_tpu/analyze/metrics.py``, bit-equal on the same input).

- calculate_nnzb: the reference's calculateNnzb (utility.cc:47-69);
- block_metrics: analyzeBlockSparseMetrics (reorder_graph.cc:12-24):
  density = nnzb / nb^2, utilization = nnz / (nnzb b^2), average =
  nnz / nnzb;
- fill_histogram: calculate_block_density_dist
  (block_density_dist.cpp:47-86), the per-block occupancy in 10 buckets;
- bandwidth_profile: matrix bandwidth and envelope.

The JAX module's ELL-tier models (ell_metrics, ell_compact_metrics) come
with the port's ELL tier.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR

# the reference sweeps 2..64 (reorder_graph.cc:14); 128 and 256 are the
# sizes of the JAX package's kernels
DEFAULT_BLOCK_SIZES = (2, 4, 8, 16, 32, 64, 128, 256)


def _block_keys(csr: CSR, b: int) -> np.ndarray:
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    nbc = -(-csr.shape[1] // b)
    return (rows // b) * nbc + cols // b


def calculate_nnzb(csr: CSR, block_size: int) -> int:
    """Nonzero b x b blocks."""
    return int(np.unique(_block_keys(csr, block_size)).shape[0])


def block_metrics(
    csr: CSR, block_sizes: Sequence[int] = DEFAULT_BLOCK_SIZES
) -> Dict[int, Dict[str, float]]:
    out: Dict[int, Dict[str, float]] = {}
    nnz = csr.nnz
    for b in block_sizes:
        nbr = -(-csr.shape[0] // b)
        nbc = -(-csr.shape[1] // b)
        nnzb = calculate_nnzb(csr, b)
        out[b] = dict(
            nnzb=float(nnzb),
            density=nnzb / (nbr * nbc),
            utilization=nnz / (nnzb * b * b) if nnzb else 0.0,
            average=nnz / nnzb if nnzb else 0.0,
        )
    return out


def fill_histogram(csr: CSR, block_size: int, n_buckets: int = 10) -> np.ndarray:
    """Bucket k counts the blocks with occupancy in (k/n, (k+1)/n]; an
    occupancy of 0 never appears (only nonzero blocks exist)."""
    _, counts = np.unique(_block_keys(csr, block_size), return_counts=True)
    occ = counts.astype(np.float64) / (block_size * block_size)
    buckets = np.minimum((np.ceil(occ * n_buckets) - 1).astype(np.int64), n_buckets - 1)
    buckets = np.maximum(buckets, 0)
    return np.bincount(buckets, minlength=n_buckets)


def bandwidth_profile(csr: CSR) -> Dict[str, float]:
    """The quantities RCM-style orderings minimize: the bandwidth (max
    |i - j| over the nonzeros) and the envelope or profile (the sum over
    rows of the span from the leftmost nonzero to the diagonal)."""
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    if rows.shape[0] == 0:
        return {"bandwidth": 0.0, "profile": 0.0, "avg_span": 0.0}
    bandwidth = float(np.abs(rows - cols).max())
    n = csr.n_rows
    min_col = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(min_col, rows, cols)
    present = min_col != np.iinfo(np.int64).max
    span = np.where(present, np.maximum(np.arange(n) - min_col, 0), 0)
    return {
        "bandwidth": bandwidth,
        "profile": float(span.sum()),
        "avg_span": float(span.sum() / max(present.sum(), 1)),
    }
