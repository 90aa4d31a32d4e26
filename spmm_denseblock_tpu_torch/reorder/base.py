"""Reordering primitives (twin of ``spmm_denseblock_tpu/reorder/base.py``).

A strategy is a function CSR -> old2new, a bijection from old to new
vertex index. ``permutate`` applies one to both axes of a square matrix
(rows only for a rectangular one) through the COO view. The JAX package
first tries its native C++ pass; this port runs the numpy body, which is
that pass's specification.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


def permutate(old2new: np.ndarray, csr: CSR) -> CSR:
    """Relabel rows (and, for a square matrix, columns) by old2new."""
    old2new = np.asarray(old2new, dtype=np.int64)
    n_rows, n_cols = csr.shape
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
