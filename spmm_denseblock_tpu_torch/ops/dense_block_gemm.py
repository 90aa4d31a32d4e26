"""Standalone dense-block GEMM (twin of
``spmm_denseblock_tpu/ops/dense_block_gemm.py``, XLA code in the JAX
package; no Pallas kernel is involved).

The analog of the reference's per-block cuBLAS GEMM driver: every
(b x b) @ (b x F) product is one element of a batched matmul. Unlike the
BSR tiers it takes an *unsorted* block list and scatter-adds into C
(the cuBLAS path's semantics):

    G[k]    = dense_blk[block_cols[k]]         (tile gather)
    P[k]    = blocks[k] @ G[k]                 (batched matmul, f32)
    C       = index_add(P, block_rows)         (scatter-add by block-row)

The products run in f32 (bf16 inputs are upcast first: their products
are exact there), as JAX's ``Precision.HIGHEST`` with
``preferred_element_type=float32``: keep TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, torch's default).
On CUDA ``index_add_`` sums duplicate block-rows with atomics, so their
order, and the last bits of such rows, vary from run to run.
"""

from __future__ import annotations

import torch

from spmm_denseblock_tpu_torch.ops._device import resolve_device


def dense_block_gemm(block_rows, block_cols, blocks, dense_blk,
                     n_block_rows: int, device=None) -> torch.Tensor:
    """blocks: (nnzb, b, b); dense_blk: (n_block_cols, b, F), the blocked
    dense operand; returns the (n_block_rows, b, F) blocked output in f32.
    Arrays may be numpy or tensors; they are moved to `device` (None is
    the card)."""
    dev = resolve_device(device)
    rows = torch.as_tensor(block_rows, device=dev).long()
    cols = torch.as_tensor(block_cols, device=dev).long()
    blocks = torch.as_tensor(blocks, device=dev)
    dense_blk = torch.as_tensor(dense_blk, device=dev)
    prod = torch.bmm(blocks.float(), dense_blk.index_select(0, cols).float())
    out = torch.zeros((n_block_rows, blocks.shape[1], dense_blk.shape[2]),
                      dtype=torch.float32, device=dev)
    return out.index_add_(0, rows, prod)
