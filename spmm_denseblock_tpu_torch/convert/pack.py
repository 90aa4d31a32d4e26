"""Layout packing helpers (twin of ``spmm_denseblock_tpu/convert/pack.py``,
bit-equal on the same input): re-blocking a BSR matrix to a larger block
size, and padding utilities."""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.formats.bsr import BSR


def repack_bsr(bsr: BSR, new_block_size: int) -> BSR:
    """Re-block a BSR matrix to a multiple of its block size: each
    (new/b) x (new/b) grid of small blocks becomes one block, stored when
    any of its small blocks is. Exact: the dense matrix is unchanged."""
    b, nb = bsr.b, new_block_size
    if nb == b:
        return bsr
    if nb % b != 0:
        raise ValueError(f"new block size {nb} must be a multiple of {b}")
    g = nb // b
    nnzb = bsr.nnzb
    brows = np.asarray(bsr.block_rows[:nnzb], dtype=np.int64)
    bcols = np.asarray(bsr.block_cols[:nnzb], dtype=np.int64)
    blocks = np.asarray(bsr.blocks[:nnzb], dtype=np.float32)

    n_new_bc = -(-bsr.n_block_cols // g)
    skey = (brows // g) * n_new_bc + bcols // g
    uniq, inv = np.unique(skey, return_inverse=True)
    out = np.zeros((uniq.shape[0], nb, nb), dtype=np.float32)
    ro = (brows % g) * b
    co = (bcols % g) * b
    for k in range(nnzb):
        out[inv[k], ro[k] : ro[k] + b, co[k] : co[k] + b] += blocks[k]
    return BSR.from_parts(
        (uniq // n_new_bc).astype(np.int32),
        (uniq % n_new_bc).astype(np.int32),
        out,
        bsr.shape,
        nb,
    )


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_dense_rows(x: np.ndarray, n_rows: int) -> np.ndarray:
    """Zero-pad the leading dim of a dense operand up to n_rows (the
    block grid's rows)."""
    if x.shape[0] == n_rows:
        return x
    pad = [(0, n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)
