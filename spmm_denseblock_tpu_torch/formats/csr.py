"""CSR format as a frozen numpy dataclass (host side).

Twin of ``spmm_denseblock_tpu/formats/csr.py``: the same (indptr,
indices, data) triple and the same constructors, bit-equal on the same
inputs. The matrix lives on the host; ``to(device)`` hands its arrays
to torch. ``data is None`` means implicit 1.0 values (adjacency
matrices).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with numpy fields."""

    indptr: np.ndarray  # (n_rows + 1,) int32
    indices: np.ndarray  # (nnz,) int32
    data: Optional[np.ndarray]  # (nnz,) float32, or None for implicit ones
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return np.float32 if self.data is None else self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(mat, keep_data: bool = True) -> "CSR":
        m = mat.tocsr()
        m.sort_indices()
        data = np.asarray(m.data, dtype=np.float32) if keep_data else None
        return CSR(
            indptr=np.asarray(m.indptr, dtype=np.int32),
            indices=np.asarray(m.indices, dtype=np.int32),
            data=data,
            shape=tuple(m.shape),
        )

    @staticmethod
    def from_edges(
        edges: np.ndarray, n_rows: int, n_cols: Optional[int] = None
    ) -> "CSR":
        """Build from an (E, 2) array of (src, dst) pairs; values implicit
        1. Duplicate edges are kept."""
        if n_cols is None:
            n_cols = n_rows
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        order = np.argsort(edges[:, 0] * n_cols + edges[:, 1], kind="stable")
        edges = edges[order]
        counts = np.bincount(edges[:, 0], minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSR(
            indptr=indptr,
            indices=edges[:, 1].astype(np.int32),
            data=None,
            shape=(n_rows, n_cols),
        )

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        data: Optional[np.ndarray],
        shape: Tuple[int, int],
    ) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        # one fused stable sort key keeps duplicate coordinates in order
        order = np.argsort(rows * shape[1] + cols, kind="stable")
        rows, cols = rows[order], cols[order]
        if data is not None:
            data = np.asarray(data, dtype=np.float32)[order]
        counts = np.bincount(rows, minlength=shape[0])
        indptr = np.zeros(shape[0] + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSR(indptr=indptr, indices=cols.astype(np.int32), data=data, shape=shape)

    # -- views -------------------------------------------------------------

    def row_ids(self) -> np.ndarray:
        """COO row index vector (nnz,)."""
        return np.repeat(
            np.arange(self.n_rows, dtype=np.int32), np.diff(self.indptr)
        )

    def values(self) -> np.ndarray:
        if self.data is None:
            return np.ones(self.nnz, dtype=np.float32)
        return np.asarray(self.data)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.values(), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray().astype(np.float32)

    def to(self, device) -> dict:
        """The three arrays as torch tensors on `device` (values
        materialized, so implicit ones become explicit)."""
        return {
            "indptr": torch.as_tensor(self.indptr, device=device),
            "indices": torch.as_tensor(self.indices, device=device),
            "data": torch.as_tensor(self.values(), device=device),
        }

    def transpose(self) -> "CSR":
        """A^T as CSR: row/col swap through the COO view."""
        return CSR.from_coo(
            np.asarray(self.indices, dtype=np.int64),
            self.row_ids().astype(np.int64),
            None if self.data is None else np.asarray(self.data),
            (self.shape[1], self.shape[0]),
        )

    def degrees(self) -> np.ndarray:
        return np.diff(np.asarray(self.indptr)).astype(np.int64)


def random_csr(
    p: float,
    n_rows: int,
    n_cols: Optional[int] = None,
    seed: int = 1234,
    values: str = "uniform",
) -> CSR:
    """Bernoulli(p) random CSR, seeded: per-row Binomial(n_cols, p) nnz
    counts, uniform column ids drawn with replacement then deduped.

    values: 'uniform' -> U[0,1) data; 'ones' -> implicit 1.0 (data=None).
    """
    if n_cols is None:
        n_cols = n_rows
    rng = np.random.default_rng(seed)
    row_nnz = rng.binomial(n_cols, p, size=n_rows)
    nnz = int(row_nnz.sum())
    cols = rng.integers(0, n_cols, size=nnz, dtype=np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    # np.unique's sorted distinct keys, as a sort and a mask: with NumPy
    # 2.3's np.unique, random_csr(2e-3, 2**17) took 64-76 s on an H100
    # machine's host, and 2.7 s with the sort
    key = np.sort(rows * n_cols + cols)
    first = np.ones(key.size, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    rows, cols = key // n_cols, key % n_cols
    data = (
        rng.random(rows.shape[0], dtype=np.float32) if values == "uniform" else None
    )
    return CSR.from_coo(rows, cols, data, (n_rows, n_cols))
