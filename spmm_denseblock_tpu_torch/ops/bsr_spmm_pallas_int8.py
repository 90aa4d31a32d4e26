"""int8 BSR SpMM plan on hand-written CUDA kernels (twin of
``spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py``; its kernels are CUDA
C++ for Hopper, in ``csrc/bsr_spmm_int8.cu``).

The plan packs the f32 blocks with the f32 plan's packers, then
quantizes the packed list (pad slots are zero blocks, so they quantize
to 0), bit-equal to the JAX plan. Each call quantizes the operand per
column (or with scales fixed from a calibration batch) and runs one of
four kernels:

- K6, flat gather (``spmm_int8_flat``), replacing ``_pallas_int8_spmm``;
- K7, depth-sorted row groups (``spmm_int8_sorted``), replacing
  ``_pallas_int8_spmm_sorted``, with one scale per slot or one per
  lane-step (group-scale, the plan's default);
- K8, consecutive row groups (``spmm_int8_rowgroup``), replacing
  ``_pallas_int8_spmm_rowgroup``;
- K9, single-row resident (``spmm_int8_resident``), replacing
  ``_pallas_int8_spmm_resident``: K6's kernels on K6's packed arrays,
  launched and counted through K9's own entry, the operand viewed as
  (nbc, b, F), as K5 is K1's.

Every kernel sums int8 x int8 products exactly in int32, scales the sum
to f32 with the slot's (or the lane-step's) block scale, and multiplies
the f32 sum by the column's operand scale before the store. They run on
the int8 tensor cores (the wgmma ring at b = 64 and 128, the small-block
mma.sync loop at b = 16 and 32, which takes its CTAs' lanes from the
plan's ``lane_order``, deepest first), whose s8 products take the
operand K-major: they read the transposed operand, (F, N). On the card a
plan's call makes it with one kernel (``quantize_int8``: the f32 operand
quantized, zero-padded and written (F, N)), in place of the JAX plan's
``_quantize_cols`` and the pad; an operand quantized elsewhere, (N, F),
is transposed by ``transpose_operand``. Beside each kernel sits its
plain PyTorch version on the same packed arrays: the int8 products in
f32 (exact: |q q| b <= 127^2 * 128 < 2^24), a group-scale lane sum in
float64 (exact, as the int32 sum is), then the scales in f32; the
quantization's is ``quantize_per_column`` with the pad, then
``transpose_operand``. The wrapper alone chooses between them: it
runs the plain version for CPU tensors and where its caller passes
plain=True, and otherwise launches the kernel or raises. Inference
only.

Layout policy: the JAX plan's gate without the TPU's VMEM fit checks,
SMEM chunking and environment knobs. ``f_tile`` is taken for its
routing only: an explicit one turns the row-group layouts off, as in
JAX, and the kernels' answer does not depend on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_denseblock_tpu_torch.convert.pack import round_up
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.ops import _kernels
from spmm_denseblock_tpu_torch.ops._device import _device_of, _sm_count, resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    quantize_blocks,
    quantize_per_column,
    reject_grad_request,
    static_col_scale,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    _ROWGROUP_GH_CAP,
    _auto_group_pow2,
    _depth_sort_policy,
    _ensure_covering,
    _flat_view,
    _pack_groups,
    _pack_rowgroups,
    _pack_rowgroups_sorted,
    _rowgroup_policy,
    _lane_order_arg,
    _small_bn,
    check_cuda_operands,
    check_rowgroup_geometry,
    group_pointer,
    lane_order,
    lane_scatter,
    rowgroup_lanes,
    sorted_lanes,
    tile_geometry,
    walked_slots,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan

# -- plain PyTorch versions of the kernels --------------------------------


def _int8_lane_sums(slot_cols, qblocks, scales, qdense, R: int, gh: int,
                    group_scale: bool):
    """lane_sums(j0, j1) for lane_scatter: (j1-j0, R, b, F) f32 of the
    scaled int8 slot products. Per-slot scales multiply each slot's
    product; a group-scale lane sums its gh products first (in float64,
    exact) and multiplies once by the lane-step's scale."""
    b = qblocks.shape[1]
    F = qdense.shape[1]
    qdense_b = qdense.reshape(-1, b, F)
    G = R * gh

    def lane_sums(j0, j1):
        cols = slot_cols[j0 * G:j1 * G].long()
        # exact integers in f32: |sum| <= 127^2 * b < 2^24
        prod = torch.bmm(qblocks[j0 * G:j1 * G].float(), qdense_b[cols].float())
        prod = prod.reshape(j1 - j0, R, gh, b, F)
        if group_scale:
            isum = prod.sum(dim=2, dtype=torch.float64).float()
            return isum * scales[j0 * R:j1 * R].reshape(-1, R, 1, 1)
        s = scales[j0 * G:j1 * G].reshape(-1, R, gh, 1, 1)
        return (prod * s).sum(dim=2)

    return lane_sums


def spmm_int8_flat_plain(step_rows, slot_cols, qblocks, scales, qdense,
                         col_scale, n_block_rows: int,
                         group: int) -> torch.Tensor:
    """Plain version of K6 on the flat layout: step j's `group` scaled
    slot products add into block-row step_rows[j]; the sum is multiplied
    by the column scales. Returns (n_block_rows*b, F) f32."""
    return col_scale * lane_scatter(
        step_rows.long()[:, None], None, n_block_rows, qblocks.shape[1],
        qdense.shape[1], 1, group,
        _int8_lane_sums(slot_cols, qblocks, scales, qdense, 1, group, False),
    )


def spmm_int8_resident_plain(step_rows, slot_cols, qblocks, scales, qdense3,
                             col_scale, n_block_rows: int,
                             group: int) -> torch.Tensor:
    """Plain version of K9: K6's packed arrays with the operand qdense3
    (nbc, b, F), whose slot s reads qdense3[col], as
    ``_resident_int8_kernel`` indexes it. That is K6's plain version on
    the (nbc*b, F) view. Returns (n_block_rows*b, F) f32."""
    return spmm_int8_flat_plain(step_rows, slot_cols, qblocks, scales,
                                _flat_view(qdense3, qblocks.shape[1]),
                                col_scale, n_block_rows, group)


def spmm_int8_sorted_plain(win_ids, pos, slot_cols, qblocks, scales, qdense,
                           col_scale, lane_valid, group_ptr,
                           n_block_rows: int, R: int, gh: int, window: int,
                           group_scale: bool) -> torch.Tensor:
    """Plain version of K7 on the depth-sorted layout: scales are (T*G,)
    per slot, or (T*R,) per lane-step with group_scale. Absent lanes add
    nothing. Returns (n_block_rows*b, F) f32."""
    dest, valid = sorted_lanes(win_ids, pos, lane_valid, group_ptr, R, window)
    return col_scale * lane_scatter(
        dest, valid, n_block_rows, qblocks.shape[1], qdense.shape[1], R, gh,
        _int8_lane_sums(slot_cols, qblocks, scales, qdense, R, gh, group_scale),
    )


def spmm_int8_rowgroup_plain(step_groups, slot_cols, qblocks, scales, qdense,
                             col_scale, n_block_rows: int, R: int,
                             gh: int) -> torch.Tensor:
    """Plain version of K8 on the consecutive row-group layout, per-slot
    scales; phantom lanes add nothing. Returns (n_block_rows*b, F) f32."""
    dest, valid = rowgroup_lanes(step_groups, R, n_block_rows)
    return col_scale * lane_scatter(
        dest, valid, n_block_rows, qblocks.shape[1], qdense.shape[1], R, gh,
        _int8_lane_sums(slot_cols, qblocks, scales, qdense, R, gh, False),
    )


# -- kernel wrappers --------------------------------------------------------


def _check_int8_operands(qblocks, qdense, scales, n_scales: int, col_scale,
                         index_arrays, contiguous: bool = True):
    """int8 blocks and operand, f32 scales of the layout's length (per
    slot or per lane-step: one layout's scales fed to another answer
    wrongly without a sound), f32 column scales of the operand's width.
    contiguous=False takes an operand of any strides (the wrapper copies
    it into the layout its kernel reads)."""
    check_cuda_operands(qblocks, qdense, {
        **index_arrays,
        "scales": (scales, torch.float32),
        "col_scale": (col_scale, torch.float32),
    }, dtypes=(torch.int8,), contiguous=contiguous)
    if scales.shape != (n_scales,):
        raise ValueError(
            f"scales must be ({n_scales},) for this layout, got "
            f"{tuple(scales.shape)}"
        )
    if col_scale.shape != (qdense.shape[1],):
        raise ValueError(
            f"col_scale must be ({qdense.shape[1]},), got {tuple(col_scale.shape)}"
        )
    if qblocks.data_ptr() % 16:
        raise ValueError("qblocks must be 16-byte aligned (word loads)")


def _launch(kernel, dev, *args):
    with torch.cuda.device(dev):
        kernel(*args, torch.cuda.current_stream(dev).cuda_stream)


def _operand_view(qdense, qdense_t):
    """The operand as (N, F): qdense, or where the caller passes only the
    transposed operand, a view of qdense_t (F, N)."""
    if qdense is not None:
        return qdense
    if qdense_t is None:
        raise ValueError("the int8 kernels need qdense (N, F) or qdense_t (F, N)")
    return qdense_t.t()


def spmm_int8_flat(step_rows, step_ptr, slot_cols, qblocks, scales, qdense,
                   col_scale, group: int, resident: bool = False,
                   qdense_t=None, lane_order=None,
                   depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K6: C (n_block_rows*b, F) f32 on the flat layout, per-slot scales
    (S,). step_ptr (n_block_rows+1,) int64 points each block-row at its
    steps. qdense, qdense_t, lane_order, depth and plain as for
    spmm_int8_sorted. resident=True launches the same kernels through
    K9's entry (``spmm_int8_resident``). CPU tensors, and any with
    plain=True, run spmm_int8_flat_plain."""
    op = _operand_view(qdense, qdense_t)
    dev = _device_of(step_rows, step_ptr, slot_cols, qblocks, scales, op,
                     col_scale)
    n_block_rows = step_ptr.shape[0] - 1
    if plain or dev.type == "cpu":
        return spmm_int8_flat_plain(step_rows, slot_cols, qblocks, scales,
                                    op, col_scale, n_block_rows, group)
    _check_int8_operands(qblocks, op, scales, qblocks.shape[0], col_scale, {
        "step_ptr": (step_ptr, torch.int64),
        "slot_cols": (slot_cols, torch.int32),
    }, contiguous=False)
    if slot_cols.shape[0] != qblocks.shape[0] or qblocks.shape[0] % group:
        raise ValueError("slot_cols and qblocks must hold n_steps*group slots")
    b = qblocks.shape[1]
    N, F = op.shape
    qdense_t, bn = _launch_args(qblocks, qdense, qdense_t, n_block_rows, dev, depth)
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    kernel = (_kernels.bsr_spmm_int8_resident if resident
              else _kernels.bsr_spmm_int8_flat)
    _launch(kernel, dev,
            step_ptr.data_ptr(), slot_cols.data_ptr(),
            _lane_order_arg(lane_order, n_block_rows, dev), qblocks.data_ptr(),
            scales.data_ptr(), qdense_t.data_ptr(), col_scale.data_ptr(),
            out.data_ptr(), n_block_rows, qblocks.shape[0], N, F, group, b, bn)
    return out


def spmm_int8_resident(step_rows, step_ptr, slot_cols, qblocks, scales,
                       qdense3, col_scale, group: int, qdense_t=None,
                       lane_order=None, depth: Optional[int] = None,
                       plain: bool = False) -> torch.Tensor:
    """K9: C (n_block_rows*b, F) f32 on K6's packed arrays with the
    operand qdense3 viewed as (nbc, b, F) (or None, with qdense_t its
    (F, nbc*b) transpose). On the TPU the layout keeps the whole operand
    slice in VMEM; on the card nothing is kept resident, and K9's entry
    runs K6's CTA walk on the (nbc*b, F) view. CPU tensors, and any with
    plain=True, run spmm_int8_resident_plain."""
    b = qblocks.shape[1]
    qdense = None if qdense3 is None else _flat_view(qdense3, b)
    op = _operand_view(qdense, qdense_t)
    if plain or _device_of(step_rows, step_ptr, slot_cols, qblocks, scales, op,
                           col_scale).type == "cpu":
        return spmm_int8_resident_plain(step_rows, slot_cols, qblocks, scales,
                                        op.reshape(-1, b, op.shape[1]), col_scale,
                                        step_ptr.shape[0] - 1, group)
    return spmm_int8_flat(step_rows, step_ptr, slot_cols, qblocks, scales,
                          qdense, col_scale, group, resident=True,
                          qdense_t=qdense_t, lane_order=lane_order, depth=depth)


# How many CTAs of a grid's average work a hub lane's CTA may take on
# the small-block int8 tensor-core loop (as F32_SMALL_HUB_SHARE and
# BF16_SMALL_HUB_SHARE for the f32 and bf16 loops): on the arxiv stand-in
# this share picked the fastest of BN = 32, 64 and 128 for int8 K7 at b
# = 32 and 16 and K6 at 32 under gorder (64 each) and K7 at 32 under rcmk
# (128, no hub); 2 took 32 at b = 16, 5% slower than 64
# (scripts/torch_kernel_variants.py int8_small)
INT8_SMALL_HUB_SHARE = 1.5


def int8_small_geometry(b: int, F: int, n_sms: int, n_slots: int, depth: int) -> int:
    """The F tile width of the int8 entries at b = 16 and 32 (the
    small-block tensor-core loop: 4 warps a CTA, each bn/4 columns of the
    b x bn tile) for a plan of n_slots slots whose deepest lane holds
    `depth`: _small_bn's width, 32, 64 or 128, at INT8_SMALL_HUB_SHARE.
    The loop reads the transposed operand, whose rows need no padding."""
    return _small_bn(F, n_sms, n_slots, depth, INT8_SMALL_HUB_SHARE)


def int8_tile_bn(b: int, n_rows: int, F: int, n_sms: int, n_slots: int = 0,
                 depth: Optional[int] = None) -> int:
    """The F tile width of an int8 launch over n_rows block-rows (K7's
    valid lanes, K8's lanes, K6's and K9's rows) of n_slots slots whose
    deepest lane holds `depth`: at b = 64 and 128 (the int8 ring)
    tile_geometry's, 64 or 128 columns; at b = 16 and 32 (the small-block
    loop) int8_small_geometry's, which needs the depth (it raises
    without one)."""
    if b >= 64:
        return tile_geometry(b, n_rows, F, n_sms, 1)[0]
    if depth is None:
        raise ValueError("the int8 entries at b = 16 and 32 need the plan's "
                         "deepest lane (depth) and lane_order")
    return int8_small_geometry(b, F, n_sms, n_slots, depth)


def transpose_operand(qdense: torch.Tensor) -> torch.Tensor:
    """qdense (N, F) int8 as the int8 kernels read it: (F, N), K-major for
    the tensor cores' s8 products, a contiguous copy that starts on 16
    bytes (the TMA map's base, the 16-byte copies' source) whatever the
    strides and offset of qdense."""
    qt = qdense.t().contiguous()
    return qt.clone() if qt.data_ptr() % 16 else qt


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_args(qblocks, qdense, qdense_t, n_block_rows: int, dev,
                 depth: Optional[int]) -> tuple:
    """(qdense_t, bn) of an int8 launch; one of qdense (N, F) and
    qdense_t (F, N) may be None. The kernels read qdense_t at every b,
    made here (transpose_operand) unless the caller passes it; bn is
    int8_tile_bn's for the plan's deepest lane (`depth` slots)."""
    b = qblocks.shape[1]
    N, F = _operand_view(qdense, qdense_t).shape
    bn = int8_tile_bn(b, n_block_rows, F, _sm_count(dev.index), qblocks.shape[0],
                      depth)
    if qdense_t is None:
        qdense_t = transpose_operand(qdense)
    elif (qdense_t.shape != (F, N) or qdense_t.dtype != torch.int8
          or qdense_t.device != dev or not qdense_t.is_contiguous()
          or qdense_t.data_ptr() % 16):
        raise ValueError(f"qdense_t must be transpose_operand(qdense): ({F}, {N}) "
                         "int8 on the operand's device, contiguous, 16-byte aligned")
    return qdense_t, bn


def spmm_int8_sorted(win_ids, pos, slot_cols, qblocks, scales, qdense,
                     col_scale, lane_valid, group_ptr, n_block_rows: int,
                     R: int, gh: int, window: int, group_scale: bool,
                     qdense_t=None, lane_order=None,
                     depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K7: C (n_block_rows*b, F) f32 on the depth-sorted layout. scales:
    (T*R,) one per lane-step with group_scale (int32 lane sums), else
    (T*G,) one per slot. qdense may have any strides. The kernels (the
    int8 ring at b = 64 and 128, the small-block tensor-core loop at 16
    and 32) read transpose_operand(qdense), or qdense_t where the caller
    made it already (qdense may then be None). lane_order (n_groups*R,)
    int32 and depth, the plan's (``lane_order``), are read at b = 16 and
    32, which needs them. CPU tensors, and any with plain=True, run
    spmm_int8_sorted_plain on the operand (qdense, else qdense_t's
    transposed view)."""
    op = _operand_view(qdense, qdense_t)
    dev = _device_of(win_ids, pos, slot_cols, qblocks, scales, op,
                     col_scale, lane_valid, group_ptr)
    if plain or dev.type == "cpu":
        return spmm_int8_sorted_plain(
            win_ids, pos, slot_cols, qblocks, scales, op, col_scale,
            lane_valid, group_ptr, n_block_rows, R, gh, window, group_scale)
    n_steps = win_ids.shape[0]
    _check_int8_operands(
        qblocks, op, scales, n_steps * (R if group_scale else R * gh),
        col_scale, {
            "win_ids": (win_ids, torch.int32),
            "pos": (pos, torch.int32),
            "slot_cols": (slot_cols, torch.int32),
            "lane_valid": (lane_valid, torch.bool),
            "group_ptr": (group_ptr, torch.int64),
        }, contiguous=False)
    n_lanes = lane_valid.shape[0]
    if n_lanes != (group_ptr.shape[0] - 1) * R:
        raise ValueError("lane_valid must hold n_groups*R lanes")
    if slot_cols.shape[0] != qblocks.shape[0] or qblocks.shape[0] != n_steps * R * gh:
        raise ValueError("slot_cols and qblocks must hold n_steps*R*gh slots")
    b = qblocks.shape[1]
    N, F = op.shape
    qdense_t, bn = _launch_args(qblocks, qdense, qdense_t, n_block_rows, dev, depth)
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    _launch(_kernels.bsr_spmm_int8_sorted, dev,
            group_ptr.data_ptr(), win_ids.data_ptr(), pos.data_ptr(),
            lane_valid.data_ptr(), slot_cols.data_ptr(),
            _lane_order_arg(lane_order, n_lanes, dev), qblocks.data_ptr(),
            scales.data_ptr(), qdense_t.data_ptr(), col_scale.data_ptr(),
            out.data_ptr(), n_lanes, qblocks.shape[0], N, F, R, gh, window, b,
            bn, int(group_scale))
    return out


def spmm_int8_rowgroup(step_groups, group_ptr, slot_cols, qblocks, scales,
                       qdense, col_scale, n_block_rows: int, R: int,
                       gh: int, qdense_t=None, lane_order=None,
                       depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K8: C (n_block_rows*b, F) f32 on the consecutive row-group layout,
    per-slot scales (T*G,). Phantom lanes store nothing. qdense,
    qdense_t, lane_order (n_groups*R,), depth and plain as for
    spmm_int8_sorted. CPU tensors, and any with plain=True, run
    spmm_int8_rowgroup_plain."""
    op = _operand_view(qdense, qdense_t)
    dev = _device_of(step_groups, group_ptr, slot_cols, qblocks, scales,
                     op, col_scale)
    if plain or dev.type == "cpu":
        return spmm_int8_rowgroup_plain(step_groups, slot_cols, qblocks,
                                        scales, op, col_scale,
                                        n_block_rows, R, gh)
    _check_int8_operands(qblocks, op, scales, qblocks.shape[0], col_scale, {
        "group_ptr": (group_ptr, torch.int64),
        "slot_cols": (slot_cols, torch.int32),
    }, contiguous=False)
    check_rowgroup_geometry(step_groups, group_ptr, slot_cols, qblocks,
                            n_block_rows, R, gh)
    b = qblocks.shape[1]
    N, F = op.shape
    qdense_t, bn = _launch_args(qblocks, qdense, qdense_t, n_block_rows, dev, depth)
    n_lanes = (group_ptr.shape[0] - 1) * R
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    _launch(_kernels.bsr_spmm_int8_rowgroup, dev,
            group_ptr.data_ptr(), slot_cols.data_ptr(),
            _lane_order_arg(lane_order, n_lanes, dev), qblocks.data_ptr(),
            scales.data_ptr(), qdense_t.data_ptr(), col_scale.data_ptr(),
            out.data_ptr(), n_lanes, n_block_rows, qblocks.shape[0], N, F, R, gh,
            b, bn)
    return out


def route_pallas_int8_spmm(step_rows, slot_cols, qblocks, scales, qdense,
                           col_scale, n_block_rows: int, n_rows: int, walk: dict,
                           group: int = 1, row_group=0,
                           plain: bool = False) -> torch.Tensor:
    """int8 twin of ``ops.bsr_spmm_pallas.route_pallas_spmm`` (the JAX
    package's ``route_pallas_int8_spmm``): a packed bucket layout, its
    int8 blocks and scales, the local int8 operand qdense (K_local, F)
    and its column scales col_scale (F,), fused into the kernel's store
    -> C (n_rows, F) f32.

    row_group ("sorted", R, gh, W) or ("sorted_gs", R, gh, W) runs K7,
    with one scale per slot or one per lane-step (the group-scale
    quantization); a plain R > 0 runs K8 on the consecutive row groups;
    0 runs K6, the flat gather (single-row residency is a measured
    negative for int8 in the JAX package, so the router never picks K9).
    walk and plain as for route_pallas_spmm."""
    order = {"lane_order": walk["lane_order"], "depth": walk["depth"], "plain": plain}
    if (isinstance(row_group, tuple) and row_group
            and row_group[0] in ("sorted", "sorted_gs")):
        tag, R, gh, W = row_group
        T = step_rows.shape[0] // (1 + R)
        out = spmm_int8_sorted(step_rows[:T], step_rows[T:], slot_cols, qblocks,
                               scales, qdense, col_scale, walk["lane_valid"],
                               walk["ptr"], n_block_rows, R, gh, W,
                               tag == "sorted_gs", **order)
    elif row_group:
        out = spmm_int8_rowgroup(step_rows, walk["ptr"], slot_cols, qblocks,
                                 scales, qdense, col_scale, n_block_rows,
                                 row_group, group, **order)
    else:
        out = spmm_int8_flat(step_rows, walk["ptr"], slot_cols, qblocks, scales,
                             qdense, col_scale, group, **order)
    return out[:n_rows]


# -- the operand's quantization ---------------------------------------------


def quantize_int8_plain(dense, n_out: int, col_scale=None,
                        transposed: bool = False):
    """Plain version of quantize_int8: zero rows up to n_out,
    quantize_per_column, then transpose_operand where the ring's layout
    is asked for. Returns (q int8, col_scale f32)."""
    if n_out > dense.shape[0]:
        dense = torch.nn.functional.pad(dense, (0, 0, 0, n_out - dense.shape[0]))
    q, cs = quantize_per_column(dense, col_scale)
    return (transpose_operand(q) if transposed else q.contiguous()), cs.contiguous()


def quantize_int8(dense, n_out: int, col_scale=None, transposed: bool = False,
                  plain: bool = False):
    """The int8 kernels' operand from the f32 dense (n_rows, F): n_out >=
    n_rows rows (rows past n_rows are zeros) quantized per column with
    the static scales col_scale (F,), or with this operand's own (None),
    as (F, n_out) contiguous and 16-byte aligned with transposed (the
    ring's operand) or (n_out, F). Returns (q int8, col_scale f32: the
    static scales themselves, or new ones). CPU tensors, and any with
    plain=True, run quantize_int8_plain; CUDA tensors launch
    quantize_int8_kernel (with col_absmax_kernel first for dynamic
    scales), bit-equal to it, NaN and +-Inf entries included."""
    if plain or dense.device.type == "cpu":
        return quantize_int8_plain(dense, n_out, col_scale, transposed)
    if dense.dtype != torch.float32 or dense.dim() != 2:
        raise TypeError(f"quantize_int8 takes a 2-D f32 operand, got dtype "
                        f"{dense.dtype}, shape {tuple(dense.shape)}")
    n_rows, F = dense.shape
    ldx = dense.stride(0) if n_rows > 1 else F
    if (F > 1 and dense.stride(1) != 1) or ldx < F:
        dense, ldx = dense.contiguous(), F
    if n_out < n_rows or (transposed and n_out % 16):
        raise ValueError(f"n_out={n_out} must be >= {n_rows} rows (and a "
                         "multiple of 16 for the transposed layout)")
    dev = dense.device
    if col_scale is not None:
        if (col_scale.dtype != torch.float32 or col_scale.shape != (F,)
                or col_scale.device != dev or not col_scale.is_contiguous()):
            raise ValueError(f"col_scale must be ({F},) f32, contiguous, on "
                             f"{dev}")
        cs, absmax = col_scale, None
    else:
        # the scales, then the absmax words the kernels reduce into
        scratch = torch.empty(2 * F, dtype=torch.float32, device=dev)
        cs, absmax = scratch[:F], scratch[F:]
    q = torch.empty((F, n_out) if transposed else (n_out, F), dtype=torch.int8,
                    device=dev)
    _launch(_kernels.quantize_int8, dev,
            dense.data_ptr(), _ptr(col_scale), _ptr(absmax), q.data_ptr(),
            cs.data_ptr(), ldx, n_rows, F, n_out, int(transposed))
    return q, cs


# -- the plan ---------------------------------------------------------------


def _group_scale_quantize(blocks_pad: np.ndarray, n_steps: int, R: int,
                          gh: int):
    """Group-scale quantization of the sorted layout, bit-equal to the
    JAX plan: the gh slots of each lane-step share one scale (the lane's
    absmax / 127), so a kernel sums the lane in int32 and scales once.
    Returns (qblocks (T*G, b, b) int8, scales (T*R,) f32)."""
    b = blocks_pad.shape[1]
    lanes = blocks_pad.reshape(n_steps, R, gh, b, b)
    lane_absmax = np.abs(lanes).max(axis=(2, 3, 4))
    lane_scales = np.where(
        lane_absmax > 0, lane_absmax / 127.0, 1.0
    ).astype(np.float32)
    q = lanes * (np.float32(1.0) / lane_scales)[:, :, None, None, None]
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.reshape(n_steps * R * gh, b, b).astype(np.int8), lane_scales.reshape(-1)


def bsr_spmm_pallas_int8_plan(
    bsr: BSR,
    f_tile: Optional[int] = None,
    calibration=None,
    group: Optional[int] = None,
    resident: Optional[bool] = None,
    depth_sort: Optional[bool] = None,
    device=None,
    group_scale: bool = True,
    grad: bool = False,
) -> Plan:
    """Host quantization and layout prep once -> Plan computing
    C = A @ dense in f32. Inference only: grad=True raises ValueError.

    calibration: an optional representative operand batch; it fixes the
    per-column scales at plan time (static_col_scale), else each call
    quantizes per column. group: slots per step (flat) or per lane (row
    groups); None picks the JAX plan's rule. device: where the packed
    arrays live, None for the card.

    Layout (the JAX plan's gate): resident=False, or an explicit f_tile,
    takes the flat layout, run by K9 with resident=True and by K6
    otherwise. Else depth_sort (default: >= 8 real blocks per block-row)
    takes the depth-sorted layout (K7) at (R, gh, W) = (8, 8, 32), with
    one scale per lane-step unless group_scale=False (the JAX plan's
    SDB_INT8_GROUP_SCALE=0); below the gate it takes consecutive row
    groups (K8) at R = 8, gh = min(group, 16). f_tile changes no answer:
    the K9 plan checks at call time that it divides the operand's width
    rounded up to 128, as the JAX plan does; the TPU's VMEM budget is
    not checked.

    Arrays: the layout's packed arrays (the JAX plan's, then the port's
    group or step pointer), the CTA -> lane order of the kernels at b = 16
    and 32 (``lane_order``), then, when calibrated, the static column
    scales. Statics: (layout, nbr, n_rows, n_cols, k_needed, geom, depth,
    calibrated), depth the deepest lane's slots. Work figures
    (``ops/plan``): nnz, the nonzero entries of the f32 blocks;
    positions, b² for each slot the kernel multiplies (``walked_slots``)."""
    device = resolve_device(device)
    reject_grad_request({"grad": grad}, "bsr_int8_pallas")
    covered = _ensure_covering(bsr)
    b = covered.b
    n_rows, n_cols = bsr.shape
    nbr = covered.n_block_rows
    k_needed = covered.n_block_cols * b
    rows_h = np.asarray(covered.block_rows[: covered.nnzb])
    cols_h = np.asarray(covered.block_cols[: covered.nnzb])
    blocks_h = np.asarray(covered.blocks[: covered.nnzb], dtype=np.float32)
    group_was_auto = group is None
    if group is None:
        group = _auto_group_pow2(covered.nnzb, np.unique(rows_h).size)
    if depth_sort is None:
        depth_sort = bsr.nnzb / max(nbr, 1) >= 8.0

    # an explicit f_tile turns the row-group layouts off (JAX's
    # rowgroup_likely without its VMEM fit)
    rowgroup_likely = resident is not False and f_tile is None
    # pack the f32 blocks, then quantize the packed list: pad slots are
    # zero blocks and quantize to 0, and the scales line up with slots
    if rowgroup_likely and depth_sort:
        R, gh, W = _depth_sort_policy(1, None if group_was_auto else group)
        (win_ids, pos, slot_cols, blocks_pad, _, lane_valid,
         steps_per_group) = _pack_rowgroups_sorted(
            rows_h, cols_h, blocks_h, gh, R, W
        )
        if group_scale:
            qblocks, scales = _group_scale_quantize(
                blocks_pad, win_ids.shape[0], R, gh)
        else:
            qblocks, scales = quantize_blocks(blocks_pad)
        group_ptr = np.concatenate([[0], np.cumsum(steps_per_group)])
        order, depth = lane_order(group_ptr, R, gh)
        arrays = [win_ids, slot_cols, qblocks, scales, pos, lane_valid, group_ptr,
                  order]
        layout, geom = "sorted", (R, gh, W, group_scale)
        slots = walked_slots(group_ptr, lane_valid, gh)
    elif rowgroup_likely:
        if group_was_auto:
            group = min(group, _ROWGROUP_GH_CAP)
        R, _ = _rowgroup_policy(1, group)
        step_groups, slot_cols, blocks_pad, n_groups = _pack_rowgroups(
            rows_h, cols_h, blocks_h, group, R
        )
        qblocks, scales = quantize_blocks(blocks_pad)
        group_ptr = group_pointer(step_groups, n_groups)
        order, depth = lane_order(group_ptr, R, group)
        arrays = [step_groups, slot_cols, qblocks, scales, group_ptr, order]
        layout, geom = "rowgroup", (R, group)
        slots = walked_slots(group_ptr, np.arange(n_groups * R) < nbr, group)
    else:
        step_rows, slot_cols, blocks_pad = _pack_groups(
            rows_h, cols_h, blocks_h, group
        )
        qblocks, scales = quantize_blocks(blocks_pad)
        step_ptr = np.searchsorted(step_rows, np.arange(nbr + 1)).astype(np.int64)
        order, depth = lane_order(step_ptr, 1, group)
        arrays = [step_rows, slot_cols, qblocks, scales, step_ptr, order]
        slots = walked_slots(step_ptr, np.ones(nbr, bool), group)
        if resident:  # only with an explicit f_tile: K9
            layout, geom = "resident", (group, int(f_tile))
        else:
            layout, geom = "flat", group
    # the layout's arrays end with the CTA -> lane order (deepest lane
    # first), then a calibrated plan's static column scales
    if calibration is not None:
        arrays.append(static_col_scale(calibration))
    statics = (layout, nbr, n_rows, n_cols, k_needed, geom, depth,
               calibration is not None)
    return Plan(arrays, _int8_pallas_apply, statics, device=device,
                name="bsr_int8_pallas", nnz=bsr.nnz_inside(),
                positions=slots * b * b)


def quantize_operand(plan: Plan, dense, transposed: bool = False):
    """The operand of an int8 kernel plan: f32, zero rows up to the
    block grid, quantized per column with the plan's static scales or
    this operand's: quantize_int8 (the kernel on CUDA tensors, its plain
    version on CPU ones). Returns (qdense (N, F) int8, col_scale f32), or
    with transposed=True the kernels' (F, N) operand in place of qdense."""
    return _quantize(plan.statics, plan.arrays, dense, transposed)


def run_quantized(plan: Plan, qdense, col_scale, plain: bool = False,
                  qdense_t=None) -> torch.Tensor:
    """The plan's kernel (or its plain version) on an operand already
    quantized by quantize_operand: C (n_rows, F) f32. qdense_t: the
    operand already transposed (quantize_operand(transposed=True) or
    transpose_operand(qdense)), which the kernels then read instead of
    making it; qdense may then be None."""
    return _run(plan.statics, plan.arrays, qdense, col_scale, plain, qdense_t)


def _quantize(statics, arrays, dense, transposed: bool = False,
              plain: bool = False):
    n_cols, k_needed, calibrated = statics[3], statics[4], statics[7]
    dense = torch.as_tensor(dense, device=arrays[2].device).to(torch.float32)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    _check_f_tile(statics, dense.shape[1])  # before any launch
    return quantize_int8(dense, k_needed, arrays[-1] if calibrated else None,
                         transposed, plain=plain)


def _run(statics, arrays, qdense, col_scale, plain: bool, qdense_t=None):
    layout, nbr, n_rows, _, _, geom, depth, _ = statics
    n_layout = 7 if layout == "sorted" else 5  # the lane order follows
    # the walk's CTA -> lane order and deepest lane (read at b = 16 and 32)
    walk = {"qdense_t": qdense_t, "lane_order": arrays[n_layout], "depth": depth,
            "plain": plain}
    if layout == "sorted":
        win_ids, slot_cols, qblocks, scales, pos, lane_valid, group_ptr = arrays[:7]
        out = spmm_int8_sorted(win_ids, pos, slot_cols, qblocks, scales, qdense,
                               col_scale, lane_valid, group_ptr, nbr, *geom, **walk)
    elif layout == "rowgroup":
        step_groups, slot_cols, qblocks, scales, group_ptr = arrays[:5]
        out = spmm_int8_rowgroup(step_groups, group_ptr, slot_cols, qblocks, scales,
                                 qdense, col_scale, nbr, *geom, **walk)
    elif layout == "resident":
        step_rows, slot_cols, qblocks, scales, step_ptr = arrays[:5]
        F = _operand_view(qdense, qdense_t).shape[1]
        _check_f_tile(statics, F)
        qdense3 = None if qdense is None else qdense.reshape(-1, qblocks.shape[1], F)
        out = spmm_int8_resident(step_rows, step_ptr, slot_cols, qblocks, scales,
                                 qdense3, col_scale, geom[0], **walk)
    else:
        step_rows, slot_cols, qblocks, scales, step_ptr = arrays[:5]
        out = spmm_int8_flat(step_rows, step_ptr, slot_cols, qblocks, scales,
                             qdense, col_scale, geom, **walk)
    return out[:n_rows]


def _check_f_tile(statics, F: int) -> None:
    """A K9 plan's f_tile must divide the operand's width rounded up to
    128, as the JAX plan checks at call time."""
    layout, geom = statics[0], statics[5]
    if layout == "resident" and round_up(F, 128) % geom[1]:
        raise ValueError(
            f"resident=True with f_tile={geom[1]}: f_tile must divide the "
            f"operand's width rounded up to 128 ({round_up(F, 128)})"
        )


def _int8_pallas_apply(statics, arrays, dense, plain: bool = False):
    # on the card one quantize_int8 launch writes the operand in the
    # layout the kernels read, transposed
    transposed = not plain and arrays[2].device.type == "cuda"
    q, col_scale = _quantize(statics, arrays, dense, transposed, plain)
    if transposed:
        return _run(statics, arrays, None, col_scale, False, qdense_t=q)
    return _run(statics, arrays, q, col_scale, plain)
