"""Windowed dense-tile format (twin of
``spmm_denseblock_tpu/formats/windowed.py``, bit-equal on the same
input).

Rows are tiled in groups of R; each row tile keeps its K best W-aligned
column windows and stores the submatrix on (tile, window) as a dense
(R, W) tile; every other nonzero falls into a remainder CSR. The SpMM is
then C[tile] = sum_k tiles[t, k] @ B[window_{t,k}], batched dense
matmuls over contiguous operand windows, plus the remainder's product:
the rectangular generalization of the reference's square-block hybrid
(divide.cu:52-127), which pays where reordering narrows each row's
column band.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


@dataclasses.dataclass(frozen=True)
class Windowed:
    """tiles: (T, K, R, W) dense row-band tiles; win_idx[t, k]: the
    W-aligned column window that tile (t, k) multiplies; remainder: a CSR
    of every nonzero not captured. Row tile t covers rows [t*R,
    (t+1)*R)."""

    tiles: np.ndarray  # (T, K, R, W) f32
    win_idx: np.ndarray  # (T, K) int32
    remainder: CSR
    shape: Tuple[int, int]
    tile_rows: int
    window: int

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_windows_per_tile(self) -> int:
        return int(self.tiles.shape[1])

    def captured_nnz(self) -> int:
        return int(np.count_nonzero(self.tiles))

    def to_dense(self) -> np.ndarray:
        R, W = self.tile_rows, self.window
        n_rows, n_cols = self.shape
        out = np.zeros((self.n_tiles * R, -(-n_cols // W) * W), np.float32)
        for t in range(self.n_tiles):
            for k in range(self.n_windows_per_tile):
                c0 = int(self.win_idx[t, k]) * W
                out[t * R : (t + 1) * R, c0 : c0 + W] += self.tiles[t, k]
        return out[:n_rows, :n_cols] + self.remainder.to_dense()


def divide_windowed(
    csr: CSR,
    tile_rows: int = 256,
    window: int = 1024,
    min_fill: float = 0.0,
    n_windows: int = 1,
) -> Windowed:
    """Split into windowed dense tiles and a remainder. Each row tile
    keeps the `n_windows` W-aligned column windows holding the most
    nonzeros (ties: the lower window id first); a (tile, window) pair
    whose captured nonzeros fall below min_fill of R*W, or below one, is
    dropped to the remainder (its tile slot stays zero, at window 0)."""
    R, W, K = tile_rows, window, n_windows
    n_rows, n_cols = csr.shape
    T = -(-n_rows // R)
    n_win = -(-n_cols // W)
    K = min(K, n_win)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    tile_of = rows // R
    win_of = cols // W
    pair = tile_of * n_win + win_of
    counts = np.bincount(pair, minlength=T * n_win).reshape(T, n_win)

    # top-K windows per tile (count descending, window id ascending)
    order = np.argsort(-counts, axis=1, kind="stable")
    top = order[:, :K]  # (T, K) window ids
    top_counts = np.take_along_axis(counts, top, axis=1)
    keep = top_counts >= max(min_fill * R * W, 1)  # empty windows dropped

    # slot_of[t, w] = k when window w is tile t's k-th slot, else -1
    slot_of = np.full((T, n_win), -1, dtype=np.int64)
    t_ids = np.repeat(np.arange(T), K)
    slot_of[t_ids, top.ravel()] = np.where(
        keep.ravel(), np.tile(np.arange(K), T), -1
    )

    slot = slot_of[tile_of, win_of]  # (nnz,) in [-1, K)
    sel = slot >= 0
    tiles = np.zeros((T, K, R, W), dtype=np.float32)
    np.add.at(
        tiles,
        (tile_of[sel], slot[sel], rows[sel] % R, cols[sel] % W),
        vals[sel],
    )
    win_idx = np.where(keep, top, 0).astype(np.int32)
    remainder = CSR.from_coo(rows[~sel], cols[~sel], vals[~sel], csr.shape)
    return Windowed(
        tiles=tiles,
        win_idx=win_idx,
        remainder=remainder,
        shape=csr.shape,
        tile_rows=R,
        window=W,
    )
