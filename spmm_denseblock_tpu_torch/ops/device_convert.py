"""CSR -> BSR on the device at a static capacity (twin of
``spmm_denseblock_tpu/ops/device_convert.py``, XLA code in the JAX
package; no Pallas kernel is involved).

The reference converts on the GPU with cuSPARSE's two phases
(cusparseXcsr2bsrNnz, then cusparseScsr2bsr). As in the JAX package the
caller passes a capacity ``nnzb_max`` and gets back the padded flat-BSR
layout: unused slots are zero blocks parked on the last block-row at
column 0, and blocks past the capacity are dropped exactly as JAX drops
them. Phase 1, ``count_nnzb_device``, sizes the capacity.

Order: one stable sort of the fused int64 key ``brow << 31 | bcol``
(block ids are int32, so the key is exact at any grid size). It gives
the same order as JAX's two stable int32 passes (``_sort_by_block``),
which JAX needs because its keys are int32.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device


def _sorted_blocks(row_ids, col_ids, block_size: int):
    """(order, sorted fused keys) of the elements by (brow, bcol)."""
    key = (row_ids.long() // block_size << 31) | (col_ids.long() // block_size)
    key_s, order = torch.sort(key, stable=True)
    return order, key_s


def _fresh_mask(key_s) -> torch.Tensor:
    """True where a sorted element starts a new block."""
    fresh = torch.ones_like(key_s, dtype=torch.bool)
    fresh[1:] = key_s[1:] != key_s[:-1]
    return fresh


def count_nnzb_device(row_ids, col_ids, n_block_cols: int, block_size: int,
                      device=None) -> torch.Tensor:
    """Phase 1: the number of distinct nonzero blocks, a 0-d int32 tensor
    on the device. `n_block_cols` is kept for the JAX signature; the key
    does not need it."""
    del n_block_cols
    dev = resolve_device(device)
    row_ids = torch.as_tensor(row_ids, device=dev)
    col_ids = torch.as_tensor(col_ids, device=dev)
    if row_ids.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    _, key_s = _sorted_blocks(row_ids, col_ids, block_size)
    return _fresh_mask(key_s).sum(dtype=torch.int32)


def csr_to_bsr_device(row_ids, col_ids, vals, n_block_rows: int,
                      n_block_cols: int, block_size: int, nnzb_max: int,
                      device=None):
    """Phase 2: scatter the element values into (nnzb_max, b, b) flat
    blocks. Returns (block_rows int32, block_cols int32, blocks f32,
    nnzb 0-d int32), padding slots on the last block-row (column 0, zero
    block). Blocks past nnzb_max are dropped: the last slot keeps its own
    block (a scatter-min of each block's first sorted position), and the
    values of the dropped blocks add 0 to it. vals None means ones."""
    del n_block_cols
    dev = resolve_device(device)
    b = block_size
    row_ids = torch.as_tensor(row_ids, device=dev)
    col_ids = torch.as_tensor(col_ids, device=dev)
    nnz = row_ids.shape[0]
    if nnz == 0:  # all padding
        return (torch.full((nnzb_max,), n_block_rows - 1, dtype=torch.int32, device=dev),
                torch.zeros((nnzb_max,), dtype=torch.int32, device=dev),
                torch.zeros((nnzb_max, b, b), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    order, key_s = _sorted_blocks(row_ids, col_ids, b)
    rank = torch.cumsum(_fresh_mask(key_s), 0) - 1  # each element's block, 0-based
    nnzb = (rank[-1] + 1).to(torch.int32)
    slot = rank.clamp(max=nnzb_max - 1)
    # scatter-min of the sorted position, sentinel nnz: a real slot keeps
    # its block's first element; overflow writes (clamped to the last
    # slot) have larger positions; untouched slots keep the sentinel
    slot_pos = torch.full((nnzb_max,), nnz, dtype=torch.int64, device=dev)
    slot_pos.scatter_reduce_(0, slot, torch.arange(nnz, device=dev), "amin",
                             include_self=True)
    valid = slot_pos < nnz
    first = key_s[slot_pos.clamp(max=nnz - 1)]
    block_rows = torch.where(valid, first >> 31, n_block_rows - 1).to(torch.int32)
    block_cols = torch.where(valid, first & ((1 << 31) - 1), 0).to(torch.int32)
    v = (torch.ones(nnz, dtype=torch.float32, device=dev) if vals is None
         else torch.as_tensor(vals, device=dev).to(torch.float32)[order])
    v = torch.where(rank < nnzb_max, v, 0.0)
    blocks = torch.zeros((nnzb_max, b, b), dtype=torch.float32, device=dev)
    blocks.index_put_((slot, row_ids[order].long() % b, col_ids[order].long() % b),
                      v, accumulate=True)
    return block_rows, block_cols, blocks, nnzb


def csr_to_bsr_on_device(csr: CSR, block_size: int, nnzb_max=None,
                         device=None) -> BSR:
    """The device conversion, handed back in the port's host BSR
    container (arrays of nnzb_max slots, nnzb the real blocks). nnzb_max
    None counts the blocks first (phase 1)."""
    dev = resolve_device(device)
    nbr = -(-csr.shape[0] // block_size)
    nbc = -(-csr.shape[1] // block_size)
    row_ids = torch.as_tensor(csr.row_ids(), device=dev)
    col_ids = torch.as_tensor(np.asarray(csr.indices, dtype=np.int32), device=dev)
    vals = None if csr.data is None else torch.as_tensor(np.asarray(csr.data), device=dev)
    if nnzb_max is None:
        nnzb_max = int(count_nnzb_device(row_ids, col_ids, nbc, block_size, dev))
    brows, bcols, blocks, nnzb = csr_to_bsr_device(
        row_ids, col_ids, vals, nbr, nbc, block_size, int(nnzb_max), dev)
    return BSR(block_rows=brows.cpu().numpy(), block_cols=bcols.cpu().numpy(),
               blocks=blocks.cpu().numpy(), shape=csr.shape,
               block_size=block_size, nnzb=int(nnzb))
