"""SpMM over the windowed dense-tile format (twin of
``spmm_denseblock_tpu/ops/windowed_spmm.py``): a batched dense matmul of
each row tile's (R, W) tiles by their operand windows, one contiguous
(W, F) slice each, summed over the tile's windows, plus the remainder
through the ELL tier. Output rows of tile t are rows [t*R, (t+1)*R), so
there is no scatter either.

The window product is XLA code in the JAX package and a torch matmul
here, with TF32 switched off for the call (f32 products; bf16 tiles and
operands are widened to f32, where their products are exact, as the JAX
plan's preferred_element_type=f32 gives). The int8 tier keeps the JAX
plan's exact int32 sums: PyTorch has no int32 batched matmul on CUDA,
so the int8 values are multiplied in f32 over spans of at most
INT8_SPAN = 1,024 window columns, where every partial sum is an integer
below 1,024 * 127^2 < 2^24 and so exact in f32, and the spans' sums are
added in int32.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.convert.divide import auto_threshold, divide
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.formats.windowed import Windowed, divide_windowed
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    dtype_name,
    quantize_blocks,
    reject_grad_request,
    reject_int8_cast,
    static_col_scale,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import quantize_int8
from spmm_denseblock_tpu_torch.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import _operand, csr_spmm_ell_plan
from spmm_denseblock_tpu_torch.ops.plan import Plan, sum_plan

# window columns per f32 span of the int8 product: 1,024 * 127^2 < 2^24
INT8_SPAN = 1024


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32, TF32 off for the call."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def windowed_spmm_plan(wt: Windowed, dtype=None, grad: bool = True,
                       device=None) -> Plan:
    """Host prep once -> Plan computing C = A @ dense in f32. dtype: None
    or float32, or bfloat16 (the tiles and the operand rounded to bf16);
    int8 raises ValueError (use windowed_spmm_int8_plan). grad reaches
    the remainder's ELL plan (the window product is differentiable as
    it is). device: None is the card."""
    device = resolve_device(device)
    reject_int8_cast(dtype, "windowed (use windowed_int8)")
    dtype_key = None if dtype is None else dtype_name(dtype)
    if dtype_key not in (None, "float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {dtype!r} (None, float32 or bfloat16)")
    W = wt.window
    n_rows, n_cols = wt.shape
    k_padded = -(-n_cols // W) * W
    tiles = torch.as_tensor(wt.tiles, device=device)
    if dtype_key is not None:
        tiles = tiles.to(getattr(torch, dtype_key))
    # work figures (ops/plan): the tiles' nonzero entries; every tile entry
    win_plan = Plan((tiles, wt.win_idx), _windowed_apply,
                    (n_rows, n_cols, k_padded, W, dtype_key), device=device,
                    name="windowed", nnz=wt.captured_nnz(), positions=wt.tiles.size)
    if not wt.remainder.nnz:
        return win_plan
    return sum_plan((win_plan, csr_spmm_ell_plan(wt.remainder, grad=grad,
                                                 device=device)))


def _windowed_apply(statics, arrays, dense, plain: bool = False):
    # plain torch ops already: plain=True runs the same ops
    n_rows, n_cols, k_padded, W, dtype_key = statics
    tiles, win_idx = arrays
    d = _operand(dense, n_cols, tiles.device, dtype_key)
    d = torch.nn.functional.pad(d, (0, 0, 0, k_padded - n_cols))
    F = d.shape[1]
    wins = d.reshape(k_padded // W, W, F)[win_idx.long()]  # (T, K, W, F)
    out = _f32_matmul(tiles, wins).sum(1)  # (T, R, F)
    return out.reshape(-1, F)[:n_rows]


def windowed_spmm(wt: Windowed, dense, **kw) -> torch.Tensor:
    return windowed_spmm_plan(wt, **kw)(dense)


def windowed_spmm_int8_plan(wt: Windowed, calibration=None, device=None,
                            **_ignored) -> Plan:
    """The windowed tier in int8: each (tile, slot) quantized with its
    own scale (quantize_blocks), the operand per column (quantize_int8;
    static scales from `calibration` when given), exact int32 products,
    rescaled in f32; the remainder through the f32 ELL plan. Inference
    only (grad=True raises). device: None is the card."""
    device = resolve_device(device)
    reject_grad_request(_ignored, "windowed_int8")
    R, W = wt.tile_rows, wt.window
    n_rows, n_cols = wt.shape
    k_padded = -(-n_cols // W) * W
    T, K = wt.n_tiles, wt.n_windows_per_tile
    q, scales = quantize_blocks(np.asarray(wt.tiles, np.float32).reshape(T * K, R, W))
    arrays = [q.reshape(T, K, R, W), scales.reshape(T, K), wt.win_idx]
    if calibration is not None:
        arrays.append(static_col_scale(calibration))
    win_plan = Plan(arrays, _windowed_int8_apply,
                    (n_rows, n_cols, k_padded, W, calibration is not None),
                    device=device, name="windowed_int8", nnz=wt.captured_nnz(),
                    positions=wt.tiles.size)
    if not wt.remainder.nnz:
        return win_plan
    # inference only: no Aᵀ layout for the remainder
    return sum_plan((win_plan, csr_spmm_ell_plan(wt.remainder, grad=False,
                                                 device=device)))


def int8_window_products(q_tiles: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """(T, K, R, W) int8 @ (T, K, W, F) int8 -> (T, K, R, F) int32,
    exactly: f32 products over spans of INT8_SPAN window columns, each
    span's sum an integer below 2^24, the spans added in int32."""
    out = None
    for w0 in range(0, q_tiles.shape[-1], INT8_SPAN):
        part = _f32_matmul(q_tiles[..., w0:w0 + INT8_SPAN],
                           wins[:, :, w0:w0 + INT8_SPAN]).to(torch.int32)
        out = part if out is None else out.add_(part)
    return out


def _windowed_int8_apply(statics, arrays, dense, plain: bool = False):
    # plain=True quantizes with quantize_int8's plain version; the rest is
    # plain torch ops either way
    n_rows, n_cols, k_padded, W, calibrated = statics
    q_tiles, sc, win_idx = arrays[:3]
    dense = _operand(dense, n_cols, q_tiles.device, None)
    # zero rows up to the window grid, quantized with the operand
    qd, col_scale = quantize_int8(dense, k_padded, arrays[3] if calibrated else None,
                                  plain=plain)
    F = qd.shape[1]
    wins = qd.reshape(k_padded // W, W, F)[win_idx.long()]  # (T, K, W, F) int8
    prod = int8_window_products(q_tiles, wins)
    out = (prod.float() * sc[:, :, None, None]).sum(1).reshape(-1, F)[:n_rows]
    return out * col_scale[None, :]


def tiered_spmm_plan(csr: CSR, tile_rows: int = 256, window: int = 1024,
                     block_size: int = 128, density_threshold=None,
                     dtype=None, grad: bool = True, device=None) -> Plan:
    """Three tiers summed: the row-band window tiles (windowed_spmm_plan),
    the square dense blocks mined from their remainder at
    `density_threshold` (auto_threshold when None) on the bsr_xla tier,
    and the final remainder on the ELL tier. device: None is the card."""
    device = resolve_device(device)
    wt = divide_windowed(csr, tile_rows=tile_rows, window=window)
    # the windows alone: the next tiers take their remainder
    wt_only = Windowed(
        tiles=wt.tiles,
        win_idx=wt.win_idx,
        remainder=CSR.from_coo([], [], None, csr.shape),
        shape=wt.shape,
        tile_rows=wt.tile_rows,
        window=wt.window,
    )
    runs = [windowed_spmm_plan(wt_only, dtype=dtype, grad=grad, device=device)]
    rem = wt.remainder
    if density_threshold is None:
        density_threshold = auto_threshold(rem, block_size)
    hyb = divide(rem, block_size, density_threshold)
    if hyb.dense.nnzb:
        runs.append(bsr_spmm_xla_plan(hyb.dense, dtype=dtype, device=device))
    if hyb.remainder.nnz:
        runs.append(csr_spmm_ell_plan(hyb.remainder, grad=grad, device=device))
    return runs[0] if len(runs) == 1 else sum_plan(runs)
