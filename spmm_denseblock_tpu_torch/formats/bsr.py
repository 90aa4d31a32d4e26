"""BSR (block sparse row) format as a frozen numpy dataclass.

Twin of ``spmm_denseblock_tpu/formats/bsr.py``: blocks live in a flat
layout sorted by (block_row, block_col),

    blocks     : (nnzb, b, b)   block values, row-major inside a block
    block_rows : (nnzb,) int32  nondecreasing
    block_cols : (nnzb,) int32

and every constructor is bit-equal to the JAX package's on the same
inputs. ``to(device, dtype)`` hands the arrays to torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BSR:
    """Flat block-sparse-row matrix. ``shape`` is the logical dense
    shape; the block grid is padded up. ``nnzb`` counts real blocks."""

    block_rows: np.ndarray
    block_cols: np.ndarray
    blocks: np.ndarray
    shape: Tuple[int, int]
    block_size: int
    nnzb: int

    @property
    def b(self) -> int:
        return self.block_size

    @property
    def n_block_rows(self) -> int:
        return -(-self.shape[0] // self.block_size)

    @property
    def n_block_cols(self) -> int:
        return -(-self.shape[1] // self.block_size)

    @property
    def dtype(self):
        return self.blocks.dtype

    @staticmethod
    def from_parts(
        block_rows: np.ndarray,
        block_cols: np.ndarray,
        blocks: np.ndarray,
        shape: Tuple[int, int],
        block_size: int,
    ) -> "BSR":
        order = np.lexsort((block_cols, block_rows))
        return BSR(
            block_rows=np.ascontiguousarray(block_rows[order], dtype=np.int32),
            block_cols=np.ascontiguousarray(block_cols[order], dtype=np.int32),
            blocks=np.ascontiguousarray(blocks[order]),
            shape=shape,
            block_size=block_size,
            nnzb=int(block_rows.shape[0]),
        )

    def block_density(self) -> float:
        """nnzb / (n_block_rows * n_block_cols)."""
        return self.nnzb / (self.n_block_rows * self.n_block_cols)

    def nnz_inside(self) -> int:
        """Nonzero entries inside the real blocks."""
        return int(np.count_nonzero(np.asarray(self.blocks[: self.nnzb])))

    def utilization(self) -> float:
        """nnz / (nnzb * b^2): the share of stored block cells that are
        nonzero."""
        denom = self.nnzb * self.b * self.b
        return self.nnz_inside() / denom if denom else 0.0

    def block_indptr(self) -> np.ndarray:
        """(n_block_rows + 1,) classic BSR rowptr over real blocks."""
        rows = self.block_rows[: self.nnzb]
        counts = np.bincount(rows, minlength=self.n_block_rows)
        indptr = np.zeros(self.n_block_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return indptr

    def to_dense(self) -> np.ndarray:
        b = self.b
        dense = np.zeros(
            (self.n_block_rows * b, self.n_block_cols * b), dtype=np.float32
        )
        rows = self.block_rows[: self.nnzb]
        cols = self.block_cols[: self.nnzb]
        blocks = np.asarray(self.blocks[: self.nnzb], dtype=np.float32)
        for k in range(self.nnzb):
            r, c = rows[k] * b, cols[k] * b
            dense[r : r + b, c : c + b] += blocks[k]
        return dense[: self.shape[0], : self.shape[1]]

    def transpose(self) -> "BSR":
        """A^T as BSR: swap block row/col ids, transpose each block."""
        nnzb = self.nnzb
        return BSR.from_parts(
            self.block_cols[:nnzb],
            self.block_rows[:nnzb],
            self.blocks[:nnzb].transpose(0, 2, 1),
            (self.shape[1], self.shape[0]),
            self.block_size,
        )

    def to_scipy(self):
        """scipy.sparse.bsr_matrix over the padded block grid."""
        import scipy.sparse as sp

        nbr, nbc, b = self.n_block_rows, self.n_block_cols, self.b
        return sp.bsr_matrix(
            (
                np.asarray(self.blocks[: self.nnzb], dtype=np.float32),
                self.block_cols[: self.nnzb],
                self.block_indptr(),
            ),
            shape=(nbr * b, nbc * b),
            blocksize=(b, b),
        )

    def to(self, device, dtype: Optional[torch.dtype] = None) -> dict:
        """The flat arrays as torch tensors on `device`; blocks cast to
        `dtype` when given."""
        blocks = torch.as_tensor(self.blocks, device=device)
        if dtype is not None:
            blocks = blocks.to(dtype)
        return {
            "block_rows": torch.as_tensor(self.block_rows, device=device),
            "block_cols": torch.as_tensor(self.block_cols, device=device),
            "blocks": blocks,
        }


def random_bsr(
    p: float,
    n_block_rows: int,
    n_block_cols: Optional[int] = None,
    block_size: int = 128,
    seed: int = 1234,
    values: str = "uniform",
) -> BSR:
    """Bernoulli(p) random BSR: each chosen block filled with U[0,1)
    values (or ones)."""
    if n_block_cols is None:
        n_block_cols = n_block_rows
    rng = np.random.default_rng(seed)
    row_nnzb = rng.binomial(n_block_cols, p, size=n_block_rows)
    cols = rng.integers(0, n_block_cols, size=int(row_nnzb.sum()), dtype=np.int64)
    rows = np.repeat(np.arange(n_block_rows, dtype=np.int64), row_nnzb)
    key = np.unique(rows * n_block_cols + cols)
    rows, cols = key // n_block_cols, key % n_block_cols
    nnzb = rows.shape[0]
    if values == "uniform":
        blocks = rng.random((nnzb, block_size, block_size), dtype=np.float32)
    else:
        blocks = np.ones((nnzb, block_size, block_size), dtype=np.float32)
    return BSR.from_parts(
        rows.astype(np.int32),
        cols.astype(np.int32),
        blocks,
        (n_block_rows * block_size, n_block_cols * block_size),
        block_size,
    )
