"""Block-structure analytics in vectorized numpy (twin of
``spmm_denseblock_tpu/analyze/metrics.py``, bit-equal on the same input).

- calculate_nnzb: the reference's calculateNnzb (utility.cc:47-69);
- block_metrics: analyzeBlockSparseMetrics (reorder_graph.cc:12-24):
  density = nnzb / nb^2, utilization = nnz / (nnzb b^2), average =
  nnz / nnzb;
- fill_histogram: calculate_block_density_dist
  (block_density_dist.cpp:47-86), the per-block occupancy in 10 buckets;
- bandwidth_profile: matrix bandwidth and envelope;
- ell_metrics, ell_compact_metrics: what the ELL tier
  (ops/csr_spmm_ell.py) builds for a matrix, its slots, classes, chunks
  and two-level compaction spans. The JAX twins also estimate times from
  TPU v5e gather rates; the port leaves those fields out.
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


def ell_metrics(
    csr: CSR, bucket: str = "quarter", feat_dim: int = 128,
    itemsize: int = 4, compact_model: bool = False,
) -> Dict[str, float]:
    """The degree-bucketed ELL layout's size for this matrix: its padded
    slots (every row gets at least one), their ratio to nnz, its width
    classes and CHUNK_SLOTS chunks, and the operand table's bytes at
    feat_dim columns of itemsize bytes. compact_model=True adds
    ell_compact_metrics (an O(nnz) unique-count pass)."""
    from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import CHUNK_SLOTS, _row_widths

    deg = csr.degrees().astype(np.int64)
    K = _row_widths(deg, bucket)
    slots = int(K.sum())
    classes, counts = np.unique(K, return_counts=True)
    n_chunks = int(
        sum(
            -(-int(m) // max(1, CHUNK_SLOTS // int(k)))
            for k, m in zip(classes, counts)
        )
    )
    out = {
        "slots": slots,
        "padded_ratio": slots / max(csr.nnz, 1),
        "n_classes": int(classes.size),
        "n_chunks": n_chunks,
        "table_bytes": int(csr.n_cols) * feat_dim * itemsize,
    }
    if compact_model:
        out.update(ell_compact_metrics(csr, bucket, feat_dim, itemsize))
    return out


def ell_compact_metrics(
    csr: CSR, bucket: str = "quarter", feat_dim: int = 128,
    itemsize: int = 4,
) -> Dict[str, float]:
    """The two-level gather's view of the ELL layout (compact="auto"):
    over candidate spans of COMPACT_SLOTS (capped at CHUNK_SLOTS), the
    unique neighbours U against the slots S, as U/S over all spans (lower:
    rows inside a class share more neighbours), and the spans that
    _ell_layout's cost model would compact."""
    from spmm_denseblock_tpu_torch import native
    from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (
        CHUNK_SLOTS,
        COMPACT_SLOTS,
        _COMPACT_MIN_GAIN,
        _gather_ns_per_slot,
        _row_widths,
    )
    from spmm_denseblock_tpu_torch.reorder.simple import _ragged_arange

    deg = csr.degrees().astype(np.int64)
    K_r = _row_widths(deg, bucket)
    order = np.argsort(K_r, kind="stable")
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    r_big = _gather_ns_per_slot(int(csr.n_cols) * feat_dim * itemsize, itemsize)
    sum_u = sum_s = n_compacted = 0
    for K in np.unique(K_r[order]):
        rows_k = order[K_r[order] == K]
        d = indptr[rows_k + 1] - indptr[rows_k]
        idx = cols[np.repeat(indptr[rows_k], d) + _ragged_arange(d)]
        # unique counts on the unpadded stream: the pads all repeat one
        # id, so they add at most 1 to U (added below)
        tgt_m = max(1, min(COMPACT_SLOTS, CHUNK_SLOTS) // int(K))
        off = np.concatenate([[0], np.cumsum(d)])
        for s in range(0, rows_k.size, tgt_m):
            m = min(tgt_m, rows_k.size - s)
            S = m * int(K)
            seg = idx[off[s]: off[s + m]]
            U = native.unique_inverse(seg, int(csr.n_cols))[0].size + 1  # + pad id
            r_sub = _gather_ns_per_slot(U * feat_dim * itemsize, itemsize)
            n_compacted += U * r_big + S * r_sub <= _COMPACT_MIN_GAIN * S * r_big
            sum_u += U
            sum_s += S
    return {
        "compact_u_over_s": round(sum_u / max(sum_s, 1), 4),
        "compact_spans": int(n_compacted),
    }


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
