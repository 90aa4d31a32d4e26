"""Degree-sort, BFS and RCM reorderings (twin of
``spmm_denseblock_tpu/reorder/simple.py``). impl="native" (the default)
runs the native engine; impl="python" the vectorized numpy bodies below,
which the engine matches bit for bit.

- max_degree_sort: vertices by descending degree (stable).
- bfs: multi-source FIFO BFS numbering, restarting at the lowest
  unvisited id. Per level, FIFO discovery order is a stable
  first-occurrence dedupe of the concatenated frontier adjacency.
- rcm_variant ("rcmk"): adjacency lists sorted by descending neighbor
  degree, then BFS.
- rcm_classic ("rcm"): textbook reverse Cuthill-McKee through scipy.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch import native as _native
from spmm_denseblock_tpu_torch.formats.csr import CSR


def max_degree_sort(csr: CSR, impl: str = "native") -> np.ndarray:
    if _native.selected(impl):
        return _native.run("sdb_degree_sort", csr)
    order = np.argsort(-csr.degrees(), kind="stable")  # new2old
    old2new = np.empty(csr.n_rows, dtype=np.int64)
    old2new[order] = np.arange(csr.n_rows)
    return old2new


def _bfs_order(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """old2new of a multi-source FIFO BFS with lowest-unvisited restarts,
    one numpy pass per level."""
    old2new = np.full(n, -1, dtype=np.int64)
    cnt = 0
    pos = 0
    while cnt < n:
        while pos < n and old2new[pos] != -1:
            pos += 1
        if pos == n:
            break
        frontier = np.array([pos], dtype=np.int64)
        old2new[pos] = cnt
        cnt += 1
        while frontier.size:
            starts, ends = indptr[frontier], indptr[frontier + 1]
            if int(np.sum(ends - starts)) == 0:
                break
            idx = np.repeat(starts, ends - starts) + _ragged_arange(ends - starts)
            neigh = indices[idx].astype(np.int64)
            neigh = neigh[old2new[neigh] == -1]
            uniq, first = np.unique(neigh, return_index=True)
            discovered = uniq[np.argsort(first, kind="stable")]
            old2new[discovered] = cnt + np.arange(discovered.size)
            cnt += discovered.size
            frontier = discovered
    return old2new


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """concatenate([arange(l) for l in lengths]) without a Python loop."""
    total = int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def bfs(csr: CSR, impl: str = "native") -> np.ndarray:
    if _native.selected(impl):
        return _native.run("sdb_bfs", csr)
    return _bfs_order(np.asarray(csr.indptr), np.asarray(csr.indices), csr.n_rows)


def _sort_adjacency_by(csr: CSR, key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Re-sort each row's neighbor list by key[neighbor], then by id."""
    indices = np.asarray(csr.indices, dtype=np.int64)
    rows = csr.row_ids().astype(np.int64)
    order = np.lexsort((indices, key[indices], rows))
    return np.asarray(csr.indptr), indices[order]


def rcm_variant(csr: CSR, impl: str = "native") -> np.ndarray:
    """The repo's 'rcmk': neighbors visited in descending-degree order."""
    if _native.selected(impl):
        return _native.run("sdb_rcm_variant", csr)
    indptr, indices = _sort_adjacency_by(csr, -csr.degrees())
    return _bfs_order(indptr, indices, csr.n_rows)


def rcm_classic(csr: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee via scipy (ascending-degree BFS, reversed)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    order = reverse_cuthill_mckee(csr.to_scipy(), symmetric_mode=False)
    old2new = np.empty(csr.n_rows, dtype=np.int64)
    old2new[np.asarray(order, dtype=np.int64)] = np.arange(csr.n_rows)
    return old2new
