"""int8 quantized BSR SpMM, the serving tier (twin of
``spmm_denseblock_tpu/ops/bsr_spmm_int8.py``).

Scheme (symmetric, no zero point): A's blocks are quantized once at plan
time, per block, q_k = rint(block_k / s_k) with s_k = max|block_k| / 127;
the operand is quantized per call, per column, s_col[f] = max|B[:, f]| /
127 (or fixed at plan time from a calibration batch). The products run
int8 x int8 with an exact integer sum and are rescaled as
C = sum_k (q_k @ q_B) * s_k * s_col. Inference only.

The quantizers are bit-equal to the JAX package's. ``bsr_spmm_int8_plan``
is the tier the JAX package compiles with XLA (``impl="bsr_int8"``); here
it is plain torch ops, and it is the cross-check of the consecutive
layouts of the kernel tier (``ops/bsr_spmm_pallas_int8.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.plan import Plan

# Elements of gathered operand per chunk of the plain products.
_CHUNK_ELEMS = 1 << 26


def dtype_name(dtype) -> str:
    """'int8', 'bfloat16', ... for a torch dtype, a numpy dtype or type,
    or a string."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def quantize_blocks(blocks: np.ndarray):
    """(nnzb, b, b) f32 -> int8 values + (nnzb,) f32 scales.

    A reciprocal multiply, then rint and clip in place, exactly as the
    JAX package does (bit-equal; a true divide would flip ~5e-7 of the
    entries by one quantum)."""
    blocks = np.asarray(blocks, dtype=np.float32)
    absmax = np.abs(blocks).max(axis=(1, 2))
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = blocks * (np.float32(1.0) / scales)[:, None, None]
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.astype(np.int8), scales


def static_col_scale(calibration) -> np.ndarray:
    """Per-column operand scales from a calibration batch, once on the
    host. The 5% margin keeps later batches with slightly larger
    activations from clipping."""
    if isinstance(calibration, torch.Tensor):
        calibration = calibration.detach().cpu().numpy()
    cal = np.asarray(calibration, dtype=np.float32)
    absmax = np.abs(cal).max(axis=0) * 1.05
    return np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)


def quantize_per_column(dense: torch.Tensor, col_scale=None):
    """Symmetric per-column int8 quantization of an f32 operand: a true
    divide, then round half to even (as ``jnp.round``), then clamp to
    +-127; a NaN quotient becomes 0, as JAX's clip and cast make it (a
    NaN entry, or an Inf one in a column whose dynamic scale is Inf).
    col_scale None computes the scales from this operand (a column of
    zeros, or one holding a NaN, gets scale 1) as absmax times the f32
    reciprocal of 127, which is what XLA compiles the JAX package's
    absmax / 127.0 into: bit-equal scales. Returns (q int8, col_scale
    f32). With the pad rows, it is the plain version of the kernel
    tier's operand quantization
    (``bsr_spmm_pallas_int8.quantize_int8``), bit-equal to it."""
    if col_scale is None:
        col_absmax = dense.abs().amax(dim=0)
        col_scale = torch.where(
            col_absmax > 0, col_absmax * (1.0 / 127.0), torch.ones_like(col_absmax)
        )
    q = torch.round(dense / col_scale[None, :])
    q = q.nan_to_num_(nan=0.0, posinf=127.0, neginf=-127.0).clamp_(-127, 127)
    return q.to(torch.int8), col_scale.to(torch.float32)


def reject_int8_cast(dtype, tier: str) -> None:
    """The cast-based tiers take dtype= as a plain cast of the operand; a
    cast to int8 truncates without scaling and would answer wrongly
    without a sound. int8 needs the quantized tiers."""
    if dtype is not None and dtype_name(dtype) == "int8":
        raise ValueError(
            f"{tier} casts the operand, and a cast to int8 would truncate "
            "silently; use the quantized tier (bsr_int8 / bsr_int8_pallas, "
            "or spmm_plan(dtype=int8)) instead"
        )


def reject_grad_request(kw: dict, tier: str) -> None:
    """int8 tiers are inference only: rounding has zero gradient almost
    everywhere, so a plan built for training would train on zero operand
    gradients. An explicit grad=True is an error."""
    if kw.get("grad"):
        raise ValueError(
            f"{tier} is inference-only (int8 quantization has zero "
            "gradient); build the f32/bf16 plan for training or pass "
            "grad=False explicitly"
        )


def bsr_spmm_int8_plan(bsr: BSR, calibration=None, device=None, **kw) -> Plan:
    """Quantize the blocks once -> Plan computing C = A @ dense in f32.

    calibration: an optional representative operand batch; it fixes the
    per-column scales at plan time (no per-call absmax pass). device:
    None is the card."""
    device = resolve_device(device)
    reject_grad_request(kw, "bsr_int8")
    qblocks, scales = quantize_blocks(bsr.blocks[: bsr.nnzb])
    arrays = [bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb],
              qblocks, scales]
    if calibration is not None:
        arrays.append(static_col_scale(calibration))
    n_rows, n_cols = bsr.shape
    statics = (bsr.n_block_rows, n_rows, n_cols, bsr.n_block_cols * bsr.b,
               calibration is not None)
    # work figures (ops/plan): every block's b² products
    return Plan(arrays, _int8_apply, statics, device=device, name="bsr_int8",
                nnz=bsr.nnz_inside(), positions=bsr.nnzb * bsr.b * bsr.b)


def _int8_apply(statics, arrays, dense, plain: bool = False):
    # plain torch ops already: plain=True runs the same ops
    n_block_rows, n_rows, n_cols, k_needed, calibrated = statics
    rows, cols, qblocks, scales = arrays[:4]
    dense = torch.as_tensor(dense, device=qblocks.device).to(torch.float32)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    if k_needed > n_cols:
        dense = torch.nn.functional.pad(dense, (0, 0, 0, k_needed - n_cols))
    qdense, col_scale = quantize_per_column(
        dense, arrays[4] if calibrated else None
    )
    b = qblocks.shape[1]
    F = dense.shape[1]
    qdense_b = qdense.reshape(-1, b, F)
    out = torch.zeros(n_block_rows, b, F, dtype=torch.float32, device=dense.device)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * F))
    for k0 in range(0, rows.shape[0], chunk):
        k1 = min(rows.shape[0], k0 + chunk)
        # int8 products summed over b in f32 are exact integers:
        # 127^2 * b <= 2,064,512 < 2^24
        prod = torch.bmm(qblocks[k0:k1].float(),
                         qdense_b[cols[k0:k1].long()].float())
        prod = prod * scales[k0:k1, None, None] * col_scale[None, None, :]
        out.index_add_(0, rows[k0:k1].long(), prod)
    return out.reshape(n_block_rows * b, F)[:n_rows]


def bsr_spmm_int8(bsr: BSR, dense, device=None) -> torch.Tensor:
    return bsr_spmm_int8_plan(bsr, device=device)(dense)
