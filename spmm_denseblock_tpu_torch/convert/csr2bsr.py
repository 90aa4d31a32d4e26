"""CSR <-> BSR conversion (host, vectorized numpy).

Twin of ``spmm_denseblock_tpu/convert/csr2bsr.py``, bit-equal on the
same input. Blocks are row-major inside a block:
dense[r, c] -> blocks[k, r % b, c % b].
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR


def csr_to_bsr(csr: CSR, block_size: int) -> BSR:
    """Two phases: (1) count the distinct nonzero blocks, (2) scatter the
    element values into (nnzb, b, b)."""
    b = block_size
    nbc = -(-csr.shape[1] // b)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    bkey = (rows // b) * nbc + cols // b
    uniq, inv = np.unique(bkey, return_inverse=True)
    blocks = np.zeros((uniq.shape[0], b, b), dtype=np.float32)
    np.add.at(blocks, (inv, rows % b, cols % b), vals)
    return BSR.from_parts(
        (uniq // nbc).astype(np.int32),
        (uniq % nbc).astype(np.int32),
        blocks,
        csr.shape,
        b,
    )


def bsr_to_csr(bsr: BSR) -> CSR:
    """Inverse conversion that keeps all b^2 cells of every stored block
    (explicit zeros included), clipped to the logical shape."""
    b = bsr.b
    nnzb = bsr.nnzb
    brows = np.asarray(bsr.block_rows[:nnzb], dtype=np.int64)
    bcols = np.asarray(bsr.block_cols[:nnzb], dtype=np.int64)
    blocks = np.asarray(bsr.blocks[:nnzb], dtype=np.float32)

    rr, cc = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    rows = (brows[:, None, None] * b + rr[None]).ravel()
    cols = (bcols[:, None, None] * b + cc[None]).ravel()
    vals = blocks.ravel()
    keep = (rows < bsr.shape[0]) & (cols < bsr.shape[1])
    return CSR.from_coo(rows[keep], cols[keep], vals[keep], bsr.shape)


def csr_to_bsr_pruned(csr: CSR, block_size: int) -> BSR:
    """csr_to_bsr under the name that convert callers use when they want
    zero-block pruning made explicit: csr_to_bsr keeps only the blocks
    that hold a stored nonzero already, so the two are the same."""
    return csr_to_bsr(csr, block_size)
