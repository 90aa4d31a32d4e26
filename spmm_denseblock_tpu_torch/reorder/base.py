"""Reordering primitives (twin of ``spmm_denseblock_tpu/reorder/base.py``).

A strategy is a function CSR -> old2new, a bijection from old to new
vertex index. ``permutate`` applies one to both axes of a square matrix
(rows only for a rectangular one).
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch import native as _native
from spmm_denseblock_tpu_torch.formats.csr import CSR


def permutate(old2new: np.ndarray, csr: CSR, impl: str = "native") -> CSR:
    """Relabel rows (and, for a square matrix, columns) by old2new. A
    square matrix goes through the native O(nnz) pass (sdb_permutate:
    per-row copies and row-sized sorts); the numpy body through the COO
    view is its plain version, bit-equal to it, and serves rectangular
    matrices and impl="python"."""
    old2new = np.asarray(old2new, dtype=np.int64)
    n_rows, n_cols = csr.shape
    if _native.selected(impl) and n_rows == n_cols:
        if old2new.shape != (n_rows,) or (
                n_rows and not 0 <= old2new.min() <= old2new.max() < n_rows):
            raise ValueError(f"old2new must map range({n_rows}) into itself")
        indptr, indices = _native.csr_args(csr)
        out_indptr = np.empty(n_rows + 1, np.int32)
        out_indices = np.empty(csr.nnz, np.int32)
        order = np.empty(csr.nnz, np.int64)
        _native.load().sdb_permutate(n_rows, indptr, indices,
                                     np.ascontiguousarray(old2new), out_indptr,
                                     out_indices, order)
        data = None if csr.data is None else np.asarray(csr.data)[order]
        return CSR(indptr=out_indptr, indices=out_indices, data=data,
                   shape=csr.shape)
    rows = old2new[csr.row_ids().astype(np.int64)]
    cols = np.asarray(csr.indices, dtype=np.int64)
    if n_rows == n_cols:
        cols = old2new[cols]
    data = None if csr.data is None else np.asarray(csr.data)
    return CSR.from_coo(rows, cols, data, csr.shape)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def check_permutation(old2new: np.ndarray, n: int) -> None:
    """Raise unless old2new is a bijection on range(n)."""
    old2new = np.asarray(old2new)
    if old2new.shape != (n,):
        raise ValueError(f"perm shape {old2new.shape} != ({n},)")
    seen = np.zeros(n, dtype=bool)
    seen[old2new] = True
    if not seen.all():
        raise ValueError("old2new is not a bijection")


def identity(csr: CSR) -> np.ndarray:
    return np.arange(csr.n_rows, dtype=np.int64)


def reorder_per_component(csr: CSR, strategy_fn) -> np.ndarray:
    """old2new that applies strategy_fn (CSR -> old2new, any entry of
    STRATEGIES) inside each weakly connected component on its own, the
    components kept contiguous in ascending order of their least original
    vertex id: the reference's per-molecule reorder for batches of small
    graphs (ogbg_molhiv.py:5-52). On a block-diagonal adjacency it keeps
    the diagonal blocks while it densifies each."""
    from scipy.sparse.csgraph import connected_components

    n = csr.n_rows
    n_comp, labels = connected_components(
        csr.to_scipy(), directed=True, connection="weak"
    )
    old2new = np.empty(n, dtype=np.int64)
    offset = 0
    first_seen = np.full(n_comp, n, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        first_seen[labels[v]] = v
    for comp in np.argsort(first_seen, kind="stable"):
        members = np.nonzero(labels == comp)[0]
        if members.size == 1:
            old2new[members[0]] = offset
            offset += 1
            continue
        sub = csr.to_scipy()[members][:, members].tocsr()
        sub_perm = strategy_fn(CSR.from_scipy(sub, keep_data=False))
        old2new[members] = offset + np.asarray(sub_perm)
        offset += members.size
    return old2new
