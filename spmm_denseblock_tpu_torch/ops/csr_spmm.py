"""CSR SpMM in plain torch ops (twin of
``spmm_denseblock_tpu/ops/csr_spmm.py``, the tiers that XLA compiles in
the JAX package; no Pallas kernel is involved):

    P[e, :] = val[e] * B[col[e], :]        (row-sorted gather, one scale)
    C       = index_add(P, row[e])         (scatter-add in f32)

``csr_xla`` is the CSR counterpart of ``bsr_xla``: the baseline the CSR
kernel tier (``csr_pallas``, K10) is held against, and differentiable by
autograd. ``bcoo`` is the library comparison path, a
``torch.sparse_coo_tensor`` product.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.plan import Plan, sum_plan

CHUNK_NNZ_BYTES = 4 << 30  # gather-intermediate budget for auto-chunking


def _operand(dense, n_cols: int, device) -> torch.Tensor:
    dense = torch.as_tensor(dense, device=device)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    return dense.to(torch.float32)


def _csr_xla_apply(statics, arrays, dense, plain: bool = False):
    # plain torch ops already: plain=True runs the same ops
    n_rows, n_cols = statics
    row_ids, col_ids, vals = arrays
    dense = _operand(dense, n_cols, vals.device)
    prod = dense[col_ids.long()] * vals[:, None]
    out = torch.zeros(n_rows, dense.shape[1], dtype=torch.float32,
                      device=dense.device)
    return out.index_add(0, row_ids.long(), prod)


def csr_spmm_plan(csr: CSR, chunk_nnz=None, device=None) -> Plan:
    """Host layout prep once -> Plan computing C = A @ dense in f32.

    The gather materializes an (nnz, F) intermediate. When nnz exceeds
    `chunk_nnz` (default: from CHUNK_NNZ_BYTES assuming F <= 512 f32),
    the plan splits the nonzeros into row-sorted chunks and sums their
    partial products (a sum_plan), so peak memory is chunk_nnz * F * 4
    bytes. Implicit values (data None) multiply by 1.0. device: None is
    the card."""
    device = resolve_device(device)
    if chunk_nnz is None:
        chunk_nnz = max(1, CHUNK_NNZ_BYTES // (512 * 4))
    statics = tuple(int(s) for s in csr.shape)
    row_ids = csr.row_ids()
    col_ids = np.asarray(csr.indices, dtype=np.int32)
    vals = csr.values().astype(np.float32)
    # work figures (ops/plan): nnz and positions both a part's nonzeros
    if csr.nnz <= chunk_nnz:
        return Plan((row_ids, col_ids, vals), _csr_xla_apply, statics,
                    device=device, name="csr_xla", nnz=csr.nnz, positions=csr.nnz)
    parts = []
    for c0 in range(0, csr.nnz, chunk_nnz):
        sl = slice(c0, min(c0 + chunk_nnz, csr.nnz))
        n = sl.stop - sl.start
        parts.append(Plan((row_ids[sl], col_ids[sl], vals[sl]), _csr_xla_apply,
                          statics, device=device, name="csr_xla", nnz=n,
                          positions=n))
    return sum_plan(parts)


def csr_spmm(csr: CSR, dense, device=None) -> torch.Tensor:
    return csr_spmm_plan(csr, device=device)(dense)


def _bcoo_apply(statics, arrays, dense, plain: bool = False):
    # one library call either way
    indices, vals = arrays
    mat = torch.sparse_coo_tensor(indices, vals, statics, check_invariants=False)
    return torch.sparse.mm(mat, _operand(dense, statics[1], vals.device))


def bcoo_spmm_plan(csr: CSR, device=None) -> Plan:
    """``torch.sparse_coo_tensor`` comparison path (the JAX package's
    BCOO path; the reference's cross-library check). Duplicate entries
    are kept, not coalesced at plan time, as the JAX BCOO keeps them
    with unique_indices=False; the product sums them. device: None is
    the card."""
    device = resolve_device(device)
    indices = np.stack([csr.row_ids().astype(np.int64),
                        np.asarray(csr.indices, dtype=np.int64)])
    return Plan((indices, csr.values().astype(np.float32)), _bcoo_apply,
                tuple(int(s) for s in csr.shape), device=device, name="bcoo",
                nnz=csr.nnz, positions=csr.nnz)
