"""SDDMM, sampled dense-dense matmul: out_e = <x[row_e], y[col_e]> (twin of
``spmm_denseblock_tpu/ops/sddmm.py``, XLA code in the JAX package; no
Pallas kernel is involved).

The companion of SpMM for attention-style GNNs: SpMM aggregates
neighbour features, SDDMM scores each edge from its endpoints. Two tiers:

- element tier (any CSR): gather both endpoint rows, a row-wise dot. The
  products round to the operands' dtype and the sum runs in at least f32
  and is cast back, as ``jnp.sum`` does for bf16;
- block tier (block coordinate lists, e.g. a BSR pattern): per block a
  (b, d) @ (d, b) product into the full (b, b) score block, f32 out for
  f32 and bf16 operands alike (JAX's ``preferred_element_type=float32``:
  bf16 operands are upcast first, their products exact in f32). Keep
  TF32 off on the card (torch's default).

The plans hold their index vectors (prepared on the host once) as
buffers, on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.plan import Plan


class SddmmPlan(Plan):
    """A Plan whose call takes both operands: plan(x, y)."""

    def forward(self, x, y):
        return self.apply_fn(self.statics, self.arrays, x, y)


def _sddmm_element_apply(statics, arrays, x, y):
    row_ids, col_ids = arrays
    x = torch.as_tensor(x, device=row_ids.device)
    y = torch.as_tensor(y, device=row_ids.device)
    prod = x.index_select(0, row_ids) * y.index_select(0, col_ids)  # (nnz, d)
    acc = torch.promote_types(prod.dtype, torch.float32)  # bf16 sums in f32
    return prod.sum(-1, dtype=acc).to(prod.dtype)


def sddmm_plan(csr: CSR, device=None) -> SddmmPlan:
    """Host prep once -> plan(x, y) = e with e[k] the score of the csr's
    k-th stored nonzero (row-major order). x: (n_rows, d), y: (n_cols,
    d)."""
    arrays = (csr.row_ids().astype(np.int64),
              np.asarray(csr.indices, dtype=np.int64))
    return SddmmPlan(arrays, _sddmm_element_apply, device=resolve_device(device))


def sddmm(csr: CSR, x, y, device=None) -> torch.Tensor:
    return sddmm_plan(csr, device=device)(x, y)


def _sddmm_block_apply(statics, arrays, x, y):
    b, r_pad, c_pad = statics
    block_rows, block_cols = arrays
    x = torch.as_tensor(x, device=block_rows.device)
    y = torch.as_tensor(y, device=block_rows.device)
    pad = torch.nn.functional.pad
    xb = pad(x, (0, 0, 0, r_pad - x.shape[0])).reshape(r_pad // b, b, x.shape[1])
    yb = pad(y, (0, 0, 0, c_pad - y.shape[0])).reshape(c_pad // b, b, y.shape[1])
    xg = xb.index_select(0, block_rows).float()  # (nnzb, b, d)
    yg = yb.index_select(0, block_cols).float()
    return torch.bmm(xg, yg.transpose(1, 2))  # (nnzb, b, b) f32


def sddmm_block_plan(block_rows, block_cols, block_size: int, n_rows: int,
                     n_cols: int, device=None) -> SddmmPlan:
    """Block tier: plan(x, y) -> (nnzb, b, b) f32 score blocks for the
    given block coordinate lists. x: (n_rows, d), y: (n_cols, d); rows
    and cols are padded up to the block grid."""
    b = block_size
    arrays = (np.asarray(block_rows, dtype=np.int64),
              np.asarray(block_cols, dtype=np.int64))
    statics = (b, -(-n_rows // b) * b, -(-n_cols // b) * b)
    return SddmmPlan(arrays, _sddmm_block_apply, statics,
                     device=resolve_device(device))
