"""The user-facing ``spmm_plan`` entry point (twin of
``spmm_denseblock_tpu/ops/dispatch.py``, for the tiers ported so far).

    plan = spmm_plan(matrix, impl="bsr_pallas", grad=False)   # on the card
    C = plan(B)

Plans go to the card unless the caller passes ``device="cpu"`` (or
another device); with no GPU and no device given, spmm_plan raises
RuntimeError.

The impl names are the JAX package's, so one call line works on both.
``impl="auto"`` reproduces the JAX router's BSR branch: CSR input, the
wide/narrow operand split at feat_dim 256, b >= 64, the 4 GiB byte
budget and the fill-amplification guard at 32x. Those constants were
measured on a TPU v5e and are copied as they are. ``dtype=int8`` maps
the chosen tier, picked by "auto" or named, to its quantized variant, as
the JAX router does. Where that gives a tier this port does not have
yet, spmm_plan raises NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr, csr_to_bsr
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import bsr_spmm_int8_plan, dtype_name
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import bsr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import bsr_spmm_pallas_int8_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm import bcoo_spmm_plan, csr_spmm_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import csr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.ops.plan import Plan
from spmm_denseblock_tpu_torch.ops.reference import spmm_dense_torch

# where each tier the JAX router can pick stands in the port's ROADMAP
_NOT_PORTED = {
    "csr_ell": "ROADMAP queue 1 item 9",
    "csr_ell_int8": "ROADMAP queue 1 item 9",
    "hybrid": "ROADMAP queue 1 item 10",
    "hybrid_int8": "ROADMAP queue 1 item 10",
    "windowed": "ROADMAP queue 1 item 10",
    "windowed_int8": "ROADMAP queue 1 item 10",
    "repack_bsr": "ROADMAP queue 1 item 10",
}

# dtype=int8 maps a tier to its quantized variant (inference only)
_INT8_VARIANT = {
    "bsr_pallas": "bsr_int8_pallas",
    "bsr_xla": "bsr_int8",
    "csr_ell": "csr_ell_int8",
    "hybrid": "hybrid_int8",
    "windowed": "windowed_int8",
}


def _dense_apply(statics, arrays, dense, plain: bool = False):
    # one torch matmul: plain=True runs the same op
    (a,) = arrays
    return spmm_dense_torch(a, torch.as_tensor(dense, device=a.device))


def _dense_plan(mat, device=None, **kw):
    return Plan((mat.to_dense(),), _dense_apply, device=resolve_device(device))


def _as_csr(m) -> CSR:
    if isinstance(m, CSR):
        return m
    if isinstance(m, BSR):
        return bsr_to_csr(m)
    raise TypeError(f"cannot route {type(m).__name__} to a CSR-tier impl")


PLANNERS: Dict[str, Callable] = {
    # CSR tier; csr_xla and bcoo take no other arguments, as in JAX
    "csr_xla": lambda m, device=None, **kw: csr_spmm_plan(_as_csr(m), device=device),
    "csr_pallas": lambda m, **kw: csr_spmm_pallas_plan(_as_csr(m), **kw),
    "bcoo": lambda m, device=None, **kw: bcoo_spmm_plan(_as_csr(m), device=device),
    # BSR tier
    "bsr_pallas": lambda m, **kw: bsr_spmm_pallas_plan(m, **kw),
    "bsr_xla": lambda m, **kw: bsr_spmm_xla_plan(m, **kw),
    "bsr_int8": lambda m, **kw: bsr_spmm_int8_plan(m, **kw),
    "bsr_int8_pallas": lambda m, **kw: bsr_spmm_pallas_int8_plan(m, **kw),
    "dense": _dense_plan,
}


def _calculate_nnzb(csr: CSR, b: int) -> int:
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    nbc = -(-csr.shape[1] // b)
    return int(np.unique((rows // b) * nbc + cols // b).shape[0])


def _prefer_repack128(bsr: BSR) -> bool:
    """The JAX router's small-b score: repack to 128-wide supertiles when
    the supertile path's modelled bytes beat the direct path's."""
    b = bsr.block_size
    g = 128 // b
    srow = np.asarray(bsr.block_rows[: bsr.nnzb], np.int64) // g
    scol = np.asarray(bsr.block_cols[: bsr.nnzb], np.int64) // g
    n_sup = np.unique(srow * (-(-bsr.n_block_cols // g)) + scol).size
    direct_cost = bsr.nnzb * b * 2 / min(230.0, 30.0 * b)
    repack_cost = n_sup * 128 / 420.0
    return repack_cost < direct_cost


def _auto_impl(matrix, block_size: int, feat_dim, budget: int) -> str:
    """The JAX router's choice for a CSR or BSR input."""
    if isinstance(matrix, BSR) and matrix.block_size < 32 and _prefer_repack128(matrix):
        return "repack_bsr"
    b_eff = matrix.block_size if isinstance(matrix, BSR) else block_size
    wide = feat_dim is None or feat_dim >= 256
    impl = "bsr_pallas" if (wide and b_eff >= 64) else "bsr_xla"
    if isinstance(matrix, CSR):
        nnzb = _calculate_nnzb(matrix, block_size)
        block_bytes = nnzb * block_size * block_size * 4
        fill_amp = nnzb * block_size * block_size / max(matrix.nnz, 1)
        if fill_amp > 32 and block_bytes <= budget:
            impl = "csr_ell"
        elif block_bytes > budget:
            impl = "hybrid"  # or csr_ell, by the JAX threshold scorer
    return impl


def spmm_plan(matrix, impl: str = "auto", block_size: int = 128,
              feat_dim=None, **kw) -> Plan:
    """Build an SpMM executor for `matrix` (CSR or BSR).

    impl: "bsr_pallas", "bsr_xla", "bsr_int8", "bsr_int8_pallas",
    "csr_pallas", "csr_xla", "bcoo", "dense" or "auto". feat_dim steers
    "auto" (None assumes a wide operand). dtype=torch.int8 maps the tier
    to its int8 variant (bsr_pallas -> bsr_int8_pallas, bsr_xla ->
    bsr_int8); pass calibration= for static operand scales. Other keyword
    arguments go to the planner, e.g. grad=False (bsr_pallas and
    csr_pallas plans are differentiable by default),
    dtype=torch.bfloat16, precision="high". device: None (the default)
    is the card; CPU callers pass device="cpu"."""
    kw["device"] = resolve_device(kw.get("device"))
    budget = kw.pop("bsr_bytes_budget", 4 << 30)
    picked = impl == "auto"
    if picked:
        impl = _auto_impl(matrix, block_size, feat_dim, budget)
    dtype = kw.get("dtype")
    if dtype is not None and dtype_name(dtype) == "int8":
        if impl in _INT8_VARIANT:
            impl = _INT8_VARIANT[impl]
        if impl in _INT8_VARIANT.values():  # the quantized tiers take no dtype
            kw.pop("dtype")
    if impl in _NOT_PORTED:
        how = "impl='auto' picks" if picked else "impl resolves to"
        raise NotImplementedError(
            f"{how} {impl!r} for this input, which is not ported yet "
            f"({_NOT_PORTED[impl]})"
        )
    if impl not in PLANNERS:
        raise KeyError(f"unknown impl {impl!r}; have {sorted(PLANNERS)}")
    if impl.startswith("bsr") and isinstance(matrix, CSR):
        matrix = csr_to_bsr(matrix, block_size)
    return PLANNERS[impl](matrix, **kw)
