"""Hybrid SpMM (twin of ``spmm_denseblock_tpu/ops/hybrid_spmm.py``): the
dense-block part through a BSR tier and the remainder through the ELL
tier, the two outputs added (``sum_plan``): the reference's divide.cu
pattern of two accumulating library calls (divide.cu:348-373).

On the card the dense part runs a BSR kernel plan (``bsr_pallas``: the
layout that its gate picks for the part's blocks, in f32, bf16 or
"high"; ``hybrid_int8`` the int8 kernel plan, its operand quantized by
``quantize_int8``) or the plain-torch ``bsr_xla`` tier, and the
remainder the ELL tier: in f32 its kernel (``sdb_ell_spmm``, one launch
a call), in bf16 and int8 its torch ops.
"""

from __future__ import annotations

import torch

from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    bsr_spmm_int8_plan,
    reject_grad_request,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import bsr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import bsr_spmm_pallas_int8_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (
    csr_spmm_ell_int8_plan,
    csr_spmm_ell_plan,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, sum_plan

DENSE_IMPLS = ("pallas", "xla")


def _ell_kw(bucket, reduce, row_sort, compact, compact_slots, feat_dim,
            device) -> dict:
    kw = dict(bucket=bucket, reduce=reduce, row_sort=row_sort,
              compact=compact, feat_dim=feat_dim, device=device)
    if compact_slots is not None:
        kw["compact_slots"] = compact_slots
    return kw


def _check_dense_impl(dense_impl: str) -> None:
    if dense_impl not in DENSE_IMPLS:
        raise ValueError(f"dense_impl must be one of {DENSE_IMPLS}, got {dense_impl!r}")


def hybrid_spmm_plan(
    hyb: Hybrid, dense_impl: str = "pallas", dtype=None, grad: bool = True,
    bucket: str = "quarter", reduce: str = "auto", row_sort: str = "keep",
    compact: str = "off", compact_slots: int = None, feat_dim: int = 128,
    device=None,
) -> Plan:
    """The dense part on bsr_spmm_pallas_plan (dense_impl="pallas") or
    bsr_spmm_xla_plan ("xla"), the remainder on csr_spmm_ell_plan with
    the ELL options given (bucket, reduce, row_sort, compact,
    compact_slots, feat_dim); dtype reaches both parts. grad=False skips
    the Aᵀ layouts that the backward needs. An empty part is left out.
    device: None is the card."""
    device = resolve_device(device)
    _check_dense_impl(dense_impl)
    ell_kw = _ell_kw(bucket, reduce, row_sort, compact, compact_slots,
                     feat_dim, device)
    if hyb.dense.nnzb == 0:
        return csr_spmm_ell_plan(hyb.remainder, grad=grad, dtype=dtype, **ell_kw)
    if dense_impl == "pallas":
        bsr_run = bsr_spmm_pallas_plan(hyb.dense, dtype=dtype, grad=grad,
                                       device=device)
    else:
        bsr_run = bsr_spmm_xla_plan(hyb.dense, dtype=dtype, device=device)
    if hyb.remainder.nnz == 0:
        return bsr_run
    csr_run = csr_spmm_ell_plan(hyb.remainder, grad=grad, dtype=dtype, **ell_kw)
    return sum_plan((bsr_run, csr_run))


def hybrid_spmm_int8_plan(
    hyb: Hybrid, calibration=None, dense_impl: str = "pallas",
    bucket: str = "quarter", reduce: str = "auto", row_sort: str = "keep",
    compact: str = "off", compact_slots: int = None, feat_dim: int = 128,
    device=None, **_ignored,
) -> Plan:
    """The two int8 tiers summed: the dense part through the int8 kernel
    plan (dense_impl="pallas") or the plain-torch bsr_int8 tier ("xla"),
    the remainder through csr_spmm_ell_int8_plan; both quantize the
    operand per column with the same scheme (static scales from
    `calibration` when given). Inference only (grad=True raises).
    device: None is the card."""
    device = resolve_device(device)
    reject_grad_request(_ignored, "hybrid_int8")
    _check_dense_impl(dense_impl)
    ell_kw = _ell_kw(bucket, reduce, row_sort, compact, compact_slots,
                     feat_dim, device)
    if hyb.dense.nnzb == 0:
        return csr_spmm_ell_int8_plan(hyb.remainder, calibration=calibration,
                                      **ell_kw)
    planner = bsr_spmm_pallas_int8_plan if dense_impl == "pallas" else bsr_spmm_int8_plan
    dense_plan = planner(hyb.dense, calibration=calibration, device=device)
    if hyb.remainder.nnz == 0:
        return dense_plan
    rem_plan = csr_spmm_ell_int8_plan(hyb.remainder, calibration=calibration,
                                      **ell_kw)
    return sum_plan((dense_plan, rem_plan))


def hybrid_spmm(hyb: Hybrid, dense, **kw) -> torch.Tensor:
    return hybrid_spmm_plan(hyb, **kw)(dense)
