"""BSR SpMM in plain torch ops (twin of
``spmm_denseblock_tpu/ops/bsr_spmm_xla.py``, the tier that XLA compiles
in the JAX package; no Pallas kernel is involved):

    Bblk[k]  = B[block_cols[k]*b : +b, :]       (tile gather)
    P[k]     = blocks[k] @ Bblk[k]              (batched matmul, f32)
    Cblk     = index_add(P, block_rows)         (scatter-add by block-row)

It is the baseline the kernel tiers are compared with, ``auto``'s tier
for narrow operands and small blocks, and differentiable by autograd.
"""

from __future__ import annotations

import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import dtype_name, reject_int8_cast
from spmm_denseblock_tpu_torch.ops.plan import Plan


def bsr_spmm_xla_plan(bsr: BSR, dtype=None, device=None, **_ignored) -> Plan:
    """Host prep once -> Plan computing C = A @ dense in f32. dtype: None
    or float32 (f32 products) or bfloat16 (bf16 blocks and operand, f32
    products and sums); int8 raises ValueError (use ``bsr_int8``). Other
    keyword arguments (grad=, ...) are ignored, as in the JAX package:
    autograd differentiates this plan. device: None is the card."""
    device = resolve_device(device)
    reject_int8_cast(dtype, "bsr_xla (use bsr_int8)")
    if dtype is not None and dtype_name(dtype) not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {dtype!r} (None, float32 or bfloat16)")
    blocks = torch.as_tensor(bsr.blocks[: bsr.nnzb])
    cast = None if dtype is None else getattr(torch, dtype_name(dtype))
    if cast is not None:
        blocks = blocks.to(cast)
    arrays = (bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb], blocks)
    n_rows, n_cols = bsr.shape
    statics = (bsr.n_block_rows, n_rows, n_cols, bsr.n_block_cols * bsr.b)
    # work figures (ops/plan): every block's b² products
    return Plan(arrays, _bsr_xla_apply, statics, device=device, name="bsr_xla",
                nnz=bsr.nnz_inside(), positions=bsr.nnzb * bsr.b * bsr.b)


def _bsr_xla_apply(statics, arrays, dense, plain: bool = False):
    # plain torch ops already: plain=True runs the same ops
    n_block_rows, n_rows, n_cols, k_needed = statics
    block_rows, block_cols, blocks = arrays
    dense = torch.as_tensor(dense, device=blocks.device)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    if k_needed != n_cols:
        dense = torch.nn.functional.pad(dense, (0, 0, 0, k_needed - n_cols))
    b = blocks.shape[1]
    F = dense.shape[1]
    # the cast rounds the operand as the plan's dtype; the products run
    # in f32 (bf16 x bf16 is exact there), as preferred_element_type=f32
    dense_blk = dense.to(blocks.dtype).reshape(-1, b, F)
    prod = torch.bmm(blocks.float(), dense_blk[block_cols.long()].float())
    out = torch.zeros(n_block_rows, b, F, dtype=torch.float32, device=dense.device)
    out = out.index_add(0, block_rows.long(), prod)
    return out.reshape(n_block_rows * b, F)[:n_rows]


def bsr_spmm_xla(bsr: BSR, dense, device=None) -> torch.Tensor:
    return bsr_spmm_xla_plan(bsr, device=device)(dense)
