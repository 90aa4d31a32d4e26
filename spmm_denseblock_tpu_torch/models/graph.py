"""Normalized adjacencies for the GNN models, built once on the host
(twin of ``spmm_denseblock_tpu/models/graph.py``, bit-equal), and the
attention pattern of the GAT (``gat_pattern``, the port's own)."""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


def add_self_loops(csr: CSR) -> CSR:
    n = min(csr.shape)
    rows = np.concatenate([csr.row_ids(), np.arange(n, dtype=np.int64)])
    cols = np.concatenate(
        [np.asarray(csr.indices, dtype=np.int64), np.arange(n, dtype=np.int64)]
    )
    vals = np.concatenate([csr.values(), np.ones(n, dtype=np.float32)])
    return CSR.from_coo(rows, cols, vals, csr.shape)


def sym_norm_adjacency(csr: CSR, self_loops: bool = True) -> CSR:
    """GCN propagation matrix D^-1/2 (A [+ I]) D^-1/2 (Kipf-Welling)."""
    a = add_self_loops(csr) if self_loops else csr
    rows = a.row_ids().astype(np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    vals = a.values().astype(np.float64)
    deg = np.zeros(a.shape[0], dtype=np.float64)
    np.add.at(deg, rows, vals)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
    new_vals = (vals * inv_sqrt[rows] * inv_sqrt[cols]).astype(np.float32)
    return CSR.from_coo(rows, cols, new_vals, a.shape)


def mean_adjacency(csr: CSR, self_loops: bool = False) -> CSR:
    """Row-normalized D^-1 A, the GraphSAGE mean aggregator."""
    a = add_self_loops(csr) if self_loops else csr
    rows = a.row_ids().astype(np.int64)
    vals = a.values().astype(np.float64)
    deg = np.zeros(a.shape[0], dtype=np.float64)
    np.add.at(deg, rows, vals)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
    return CSR.from_coo(
        rows,
        np.asarray(a.indices, dtype=np.int64),
        (vals * inv[rows]).astype(np.float32),
        a.shape,
    )


def gat_pattern(csr: CSR) -> CSR:
    """The GAT's attention pattern of a square graph: the bidirected simple
    graph (DGL's ``to_bidirected``: each edge both ways, duplicate edges
    merged), its self-loops removed and then one added on every node,
    as DGL's ogbn-arxiv GAT example builds it. Pattern-only (data None),
    columns ascending in each row."""
    n = csr.n_rows
    if csr.n_cols != n:
        raise ValueError(f"the attention pattern needs a square graph, got {csr.shape}")
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    keep = rows != cols
    loops = np.arange(n, dtype=np.int64)
    key = np.concatenate([rows[keep] * n + cols[keep], cols[keep] * n + rows[keep],
                          loops * n + loops])
    key = np.unique(key)
    return CSR.from_coo(key // n, key % n, None, (n, n))
