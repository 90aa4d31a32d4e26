"""BSR SpMM plan on hand-written CUDA kernels (twin of
``spmm_denseblock_tpu/ops/bsr_spmm_pallas.py``; the module keeps that
name so the pair is easy to find, but its kernels are CUDA C++ for
Hopper, in ``csrc/bsr_spmm.cu``).

The plan packs the blocks on the host once, with the JAX package's
packers ported verbatim (bit-equal outputs), and the apply runs one of
four kernels on the packed arrays:

- K1, flat grouped gather (``spmm_flat``), replacing ``_pallas_spmm``;
- K2, depth-sorted row groups (``spmm_sorted``), replacing
  ``_pallas_spmm_rowgroup_sorted``;
- K4, consecutive row groups (``spmm_rowgroup``), replacing
  ``_pallas_spmm_rowgroup``;
- K5, single-row resident (``spmm_resident``), replacing
  ``_pallas_spmm_resident``: K1's kernels on K1's packed arrays, launched
  and counted through K5's own entries, the operand viewed as (nbc, b,
  F).

``precision="high"`` on f32 operands runs K3, the bf16x3 product of
``_dot3`` (hi·hi + hi·lo + lo·hi of bf16 splits, f32 sums), as its own
instance of K1, K2 or K5 (``bf16x3=True`` in the wrappers). A "high"
plan splits its blocks once, at build, and holds their two bf16 planes
(``split_planes``) instead of the f32 blocks; each call splits the
operand once (``split_operand``, a kernel of its own), and K3 runs on the
tensor cores. ``precision="default"`` on f32 operands is the TPU's
single pass (``Precision.DEFAULT``: both operands rounded to bf16, f32
products and sums): the plan rounds its blocks to bf16 once, each call
rounds the operand once, and the bf16 entries of K1 or K5 run it (the
JAX plan never sorts or row-groups a "default" plan); on bf16 operands
"default" is the bf16 product itself. bf16 operands run every kernel through its own entry
(``sdb_bsr_spmm_{flat,sorted,rowgroup,resident}_bf16``), on the tensor
cores: at b = 64 and 128 on the wgmma ring, at ``bf16_tile_geometry``'s F
tile width, at b = 16 and 32 (K3 too) on the small-block mma.sync loop,
at ``bf16_small_geometry``'s. Exact-f32 K1, K2, K4 and K5 run one
pipelined FFMA loop at every b: at b = 64 and 128 at ``tile_geometry``'s
tile width, at b = 16 and 32 at ``f32_small_geometry``'s. Both small
geometries keep the plan's deepest lane in view, and every entry at b =
16 and 32 takes the lanes in the plan's ``lane_order`` (deepest first;
``_f32_launch_args``, ``_bf16_launch_args``, ``_k3_launch_args``).

Beside each kernel sits its plain PyTorch version (``spmm_flat_plain``,
``spmm_sorted_plain``, ``spmm_rowgroup_plain``,
``spmm_resident_plain``): gather, ``bmm`` in f32 (three of them for
bf16x3) and ``index_add_`` over the same packed arrays. The wrapper
alone chooses between them: it runs the plain version for CPU tensors
and where its caller passes plain=True (``run(plan, x, plain=True)``),
and otherwise launches the kernel or raises.

Layout policy: the occupancy gate of the JAX plan. The TPU's VMEM fit
checks, SMEM chunking and environment knobs are not carried over; their
arguments are. ``grad=True`` (the default) returns a ``grad_plan`` of
the forward plan and a plan of Aᵀ built with the same arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.ops import _kernels
from spmm_denseblock_tpu_torch.ops._device import (
    _device_of,
    _sm_count,
    check_arrays,
    resolve_device,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import dtype_name, reject_int8_cast
from spmm_denseblock_tpu_torch.ops.plan import Plan, grad_plan, run

# -- host packing (verbatim ports, bit-equal to the JAX package) ----------


def _ensure_covering(bsr: BSR) -> BSR:
    """Insert an explicit zero block in every empty block-row, so every
    output tile has at least one slot and is written."""
    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    present = np.zeros(bsr.n_block_rows, dtype=bool)
    present[rows] = True
    missing = np.nonzero(~present)[0]
    if missing.size == 0:
        return bsr
    return BSR.from_parts(
        np.concatenate([rows, missing.astype(np.int32)]),
        np.concatenate(
            [np.asarray(bsr.block_cols[: bsr.nnzb]), np.zeros(missing.size, np.int32)]
        ),
        np.concatenate(
            [
                np.asarray(bsr.blocks[: bsr.nnzb]),
                np.zeros((missing.size, bsr.b, bsr.b), np.asarray(bsr.blocks).dtype),
            ]
        ),
        bsr.shape,
        bsr.block_size,
    )


def per_buffer_col_fill(cols2d, real_mask, fallback=None):
    """Pad-slot col fill: a pad slot at (step j, buffer g) repeats buffer
    g's most recent real col (on the TPU the repeated index skips the
    B-tile copy; here it only keeps the arrays equal to the JAX ones).
    Leading pads take `fallback` when given, else keep their col.
    cols2d: (T, G); real_mask: (T, G) bool."""
    step_idx = np.where(real_mask, np.arange(cols2d.shape[0])[:, None], -1)
    src = np.maximum.accumulate(step_idx, axis=0)
    filled = np.take_along_axis(cols2d, np.maximum(src, 0), axis=0)
    lead = cols2d if fallback is None else fallback
    return np.where(src >= 0, filled, lead)


def _pack_groups(rows, cols, blocks, group: int):
    """Group-pad a row-sorted flat block list: each block-row's blocks are
    padded with zero blocks to a multiple of `group`.

    Returns (step_rows (n_steps,), slot_cols (n_steps*group,),
    blocks_padded (n_steps*group, b, b))."""
    nnzb, b, _ = blocks.shape
    uniq, first = np.unique(rows, return_index=True)  # rows sorted
    counts = np.diff(np.append(first, nnzb))
    steps_per_row = -(-counts // group)
    n_steps = int(steps_per_row.sum())
    slot_base = np.concatenate([[0], np.cumsum(steps_per_row * group)[:-1]])
    rank = np.arange(nnzb) - np.repeat(first, counts)
    dest = np.repeat(slot_base, counts) + rank

    n_slots = n_steps * group
    blocks_pad = np.zeros((n_slots, b, b), blocks.dtype)
    blocks_pad[dest] = blocks
    cols_pad = np.full(n_slots, -1, np.int64)
    cols_pad[dest] = cols
    # fallback fill: the row's last real block (flat forward fill)
    ffill = np.maximum.accumulate(
        np.where(cols_pad >= 0, np.arange(n_slots), 0)
    )
    flat_fill = cols_pad[ffill]
    if group > 1:
        c2 = cols_pad.reshape(n_steps, group)
        cols_pad = per_buffer_col_fill(
            c2, c2 >= 0, flat_fill.reshape(n_steps, group)
        ).reshape(-1)
    else:
        cols_pad = flat_fill
    cols_pad = cols_pad.astype(np.int32)
    step_rows = np.repeat(uniq, steps_per_row).astype(np.int32)
    return step_rows, cols_pad, blocks_pad


def _pack_rowgroups(rows, cols, blocks, group_half: int, R: int):
    """Consecutive row-group packing: block-rows g*R .. g*R+R-1 share the
    steps of group g, lane r holding group_half slots per step. `rows`
    must cover every block-row (see _ensure_covering). The last group is
    padded to R lanes with phantom rows that hold no blocks. Returns
    (step_groups (T,), slot_cols (T*G,), blocks_padded (T*G, b, b),
    n_groups)."""
    nnzb, b, _ = blocks.shape
    order = np.argsort(rows, kind="stable")
    rows_s = np.asarray(rows)[order]
    uniq, first = np.unique(rows_s, return_index=True)
    # output rows land at uniq's rank, so a gap in uniq would compress
    # the result's rows
    assert uniq.size and uniq[0] == 0 and uniq[-1] == uniq.size - 1, (
        "_pack_rowgroups requires a covering rows list "
        "(every block-row present at least once)"
    )
    counts = np.diff(np.append(first, rows_s.size))
    n_rows_cov = uniq.size
    pad_rows = (-n_rows_cov) % R
    counts_p = np.append(counts, np.zeros(pad_rows, counts.dtype))
    groups = (n_rows_cov + pad_rows) // R
    per_row_steps = -(-counts_p // group_half)
    steps_per_group = np.maximum(
        per_row_steps.reshape(groups, R).max(axis=1), 1
    )
    T = int(steps_per_group.sum())
    G = R * group_half
    step_base = np.concatenate([[0], np.cumsum(steps_per_group)[:-1]])
    rank = np.arange(rows_s.size) - np.repeat(first, counts)
    krank = np.searchsorted(uniq, rows_s)
    grp = krank // R
    lane = krank % R
    dest_s = ((step_base[grp] + rank // group_half) * G
              + lane * group_half + rank % group_half)
    dest = np.empty(rows_s.size, np.int64)
    dest[order] = dest_s
    blocks_pad = np.zeros((T * G, b, b), np.asarray(blocks).dtype)
    blocks_pad[dest] = np.asarray(blocks)
    cols_pad = np.full(T * G, -1, np.int64)
    cols_pad[dest] = np.asarray(cols)
    c2 = cols_pad.reshape(T, G)
    cols_filled = per_buffer_col_fill(c2, c2 >= 0, np.zeros_like(c2))
    step_groups = np.repeat(
        np.arange(groups), steps_per_group
    ).astype(np.int32)
    return (step_groups, cols_filled.reshape(-1).astype(np.int32),
            blocks_pad, int(groups))


def walked_slots(group_ptr, lane_valid, gh: int) -> int:
    """The slots the kernels multiply: each valid lane walks every slot
    of its group's steps, gh a step, the zero blocks of pad and covering
    slots included; an absent (K2, K7) or phantom (K4, K8) lane returns
    before its first slot. group_ptr (n_groups + 1,), lane_valid
    (n_groups * R,) bool; K1's layout is R = 1, its step pointer and
    every lane valid."""
    steps = np.diff(np.asarray(group_ptr, np.int64))
    valid = np.asarray(lane_valid, bool).reshape(steps.size, -1)
    return int(gh * (steps[:, None] * valid).sum())


def f32_walk(block_rows, n_block_rows: int):
    """(walked_slots, depth) of the exact-f32 plan that
    bsr_spmm_pallas_plan builds with its default options over blocks in
    these block-rows, counted without packing: each empty block-row
    takes a covering zero block, and the plan's gate (_layout_gate)
    picks the depth-sorted layout (K2) or K1's flat one and its group.
    depth is the deepest lane's slots (lane_order's)."""
    counts = np.bincount(np.asarray(block_rows, np.int64), minlength=n_block_rows)
    covered = np.maximum(counts, 1)
    layout, group = _layout_gate(int(counts.sum()), int(covered.sum()), n_block_rows)
    if layout == "flat":
        steps = -(-covered // group)
        return int(steps.sum() * group), int(steps.max(initial=0) * group)
    R, gh, W = _depth_sort_policy(4)
    slots = deepest = 0
    for lo in range(0, n_block_rows, W):
        # a window's rows by ascending count, R lanes a group; a group
        # walks its deepest lane's steps on each of its real lanes
        c = np.sort(covered[lo:lo + W], kind="stable")
        pad = (-c.size) % R
        steps = -(-np.concatenate([c, np.zeros(pad, c.dtype)]) // gh)
        steps = np.maximum(steps.reshape(-1, R).max(axis=1), 1)
        lanes = np.full(steps.size, R)
        lanes[-1] -= pad
        slots += int(gh * (steps * lanes).sum())
        deepest = max(deepest, int(steps.max()))
    return slots, deepest * gh


def group_pointer(step_groups, n_groups: int) -> np.ndarray:
    """(n_groups+1,) int64: the steps of group g are ptr[g] .. ptr[g+1]-1
    (step_groups is nondecreasing). A CUDA CTA walks its group's steps
    with it."""
    return np.searchsorted(step_groups, np.arange(n_groups + 1)).astype(np.int64)


def lane_order(ptr, R: int, slots_per_step: int):
    """The port's CTA -> lane order of a walk whose group g holds steps
    ptr[g] .. ptr[g+1]-1 for each of its R lanes (K2's and K4's group
    pointer; K1's step pointer with R = 1), and the deepest lane's slots.
    Returns (order (n_groups*R,) int32: the lanes by step count, deepest
    first, ties in packed order; depth = max steps * slots_per_step). The
    order moves which CTA starts when, never an output's sum."""
    steps = np.repeat(np.diff(np.asarray(ptr)), R)
    order = np.argsort(-steps, kind="stable").astype(np.int32)
    return order, int(steps.max(initial=0)) * slots_per_step


def _pack_rowgroups_sorted(rows, cols, blocks, gh: int, R: int, W: int):
    """Depth-sorted row-group packing. `rows` must cover every block-row.

    Within each window of W consecutive block-rows, rows are ordered by
    ascending block count (stable) and grouped R at a time; a group's
    step count is its deepest lane's ceil(count / gh). Each lane carries
    its row's position inside the window (pos = row - window*W).

    Returns the five arrays of the JAX packer, (win_ids (T,) int32,
    pos (T*R,) int32, slot_cols (T*G,) int32, blocks_padded (T*G, b, b),
    n_windows), and two more that the CUDA kernel needs and the packed
    arrays cannot express: lane_valid (n_groups*R,) bool, False for the
    lanes that pad a window to a multiple of R (their pos is 0, the same
    as a real row's), and steps_per_group (n_groups,) int64."""
    assert W % R == 0, (W, R)
    nnzb, b, _ = blocks.shape
    order0 = np.argsort(rows, kind="stable")
    rows_s = np.asarray(rows)[order0]
    uniq, first = np.unique(rows_s, return_index=True)
    assert uniq.size and uniq[0] == 0 and uniq[-1] == uniq.size - 1, (
        "_pack_rowgroups_sorted requires a covering rows list"
    )
    counts = np.diff(np.append(first, rows_s.size))
    nbr = uniq.size
    n_win = -(-nbr // W)

    lane_rows = []  # (n_groups_tot, R) row ids, -1 = absent lane
    for w in range(n_win):
        lo, hi = w * W, min((w + 1) * W, nbr)
        ids = lo + np.argsort(counts[lo:hi], kind="stable")
        padn = (-ids.size) % R
        if padn:
            ids = np.concatenate([ids, np.full(padn, -1, np.int64)])
        lane_rows.append(ids.reshape(-1, R))
    lane_rows = np.concatenate(lane_rows)  # (n_groups, R)
    cnt_g = np.where(lane_rows >= 0, counts[np.maximum(lane_rows, 0)], 0)
    steps_per_group = np.maximum(
        (-(-cnt_g // gh)).max(axis=1), 1
    ).astype(np.int64)
    T = int(steps_per_group.sum())
    G = R * gh
    win_of_group = lane_rows.max(axis=1) // W
    pos_g = np.where(
        lane_rows >= 0, lane_rows - win_of_group[:, None] * W, 0
    ).astype(np.int32)
    step_base = np.concatenate([[0], np.cumsum(steps_per_group)[:-1]])

    grp_of_row = np.empty(nbr, np.int64)
    lane_of_row = np.empty(nbr, np.int64)
    gi, li = np.nonzero(lane_rows >= 0)
    grp_of_row[lane_rows[gi, li]] = gi
    lane_of_row[lane_rows[gi, li]] = li

    rank = np.arange(rows_s.size) - np.repeat(first, counts)
    g_of = grp_of_row[rows_s]
    dest_s = (
        (step_base[g_of] + rank // gh) * G
        + lane_of_row[rows_s] * gh
        + rank % gh
    )
    dest = np.empty(rows_s.size, np.int64)
    dest[order0] = dest_s
    blocks_pad = np.zeros((T * G, b, b), np.asarray(blocks).dtype)
    blocks_pad[dest] = np.asarray(blocks)
    cols_pad = np.full(T * G, -1, np.int64)
    cols_pad[dest] = np.asarray(cols)
    c2 = cols_pad.reshape(T, G)
    cols_filled = per_buffer_col_fill(c2, c2 >= 0, np.zeros_like(c2))
    win_ids = np.repeat(win_of_group, steps_per_group).astype(np.int32)
    pos = np.repeat(
        pos_g, steps_per_group, axis=0
    ).reshape(-1).astype(np.int32)
    lane_valid = (lane_rows >= 0).reshape(-1)
    return (win_ids, pos, cols_filled.reshape(-1).astype(np.int32),
            blocks_pad, n_win, lane_valid, steps_per_group)


_ROWGROUP_GH_CAP = 16


def _rowgroup_policy(itemsize: int, group=None):
    """(R, gh) of the consecutive row-group layout: R = 8 lanes for int8,
    16 for 2-byte operands; gh = 16 slots per lane and step unless a
    group is given. The values are the JAX plan's, so the packed arrays
    match it."""
    R = 8 if itemsize == 1 else 16
    gh = _ROWGROUP_GH_CAP if group in (None, "auto") else int(group)
    return R, gh


def _auto_group(nnzb: int, n_rows_with_blocks: int) -> int:
    """Blocks per step for the flat layout: larger when rows are
    block-dense, small when they are sparse (pads cost G/2 per row)."""
    avg = nnzb / max(1, n_rows_with_blocks)
    if avg < 4:
        return 1
    if avg < 8:
        return 2
    if avg < 16:
        return 4
    return 8


def _auto_group_pow2(nnzb: int, n_rows_with_blocks: int, cap: int = 32) -> int:
    """Smallest power of two >= the average row occupancy, capped (the
    JAX plan's group rule for 2-byte operands)."""
    avg = nnzb / max(1, n_rows_with_blocks)
    g = 1
    while g < avg and g < cap:
        g *= 2
    return g


def _layout_gate(n_real: int, n_covered: int, n_block_rows: int, itemsize: int = 4,
                 precision: Optional[str] = None, resident: Optional[bool] = None,
                 depth_sort: Optional[bool] = None, group: Optional[int] = None):
    """The (layout, group) that bsr_spmm_pallas_plan's gate picks for
    n_real blocks in n_block_rows block-rows (n_covered with the covering
    zero blocks): "sorted" (group None: the policy's), "rowgroup" or
    "flat", the group the caller's or the layout's automatic one."""
    avg_real = n_real / max(n_block_rows, 1)
    # 2-byte operands at the default precision: the JAX plan's resident
    # regime (sorted or consecutive row groups, power-of-two groups)
    resident_likely = itemsize == 2 and resident is not False and precision is None
    if depth_sort is None:
        depth_sort = avg_real >= 2.0
    wide_sorted = (itemsize == 4 and resident is not False
                   and precision in (None, "high") and avg_real >= 8.0)
    if depth_sort and (resident_likely or wide_sorted):
        return "sorted", group
    layout = "rowgroup" if resident_likely else "flat"
    if group is None:
        group = (min(_auto_group_pow2(n_covered, n_block_rows), _ROWGROUP_GH_CAP)
                 if resident_likely else _auto_group(n_covered, n_block_rows))
    return layout, group


def _depth_sort_policy(itemsize: int, group=None):
    """(R, gh, W) of the depth-sorted layout: R lanes per group, gh slots
    per lane and step, windows of W block-rows. The values are the JAX
    plan's, so the packed arrays match it."""
    if itemsize == 1:
        R, gh, W = 8, 8, 32
    else:
        R, gh, W = 16, 4, 128
    if group not in (None, "auto"):
        gh = int(group)
    return R, gh, W


# -- plain PyTorch versions of the kernels --------------------------------

# Elements of gathered operand (and of products) per plain-version chunk.
_PLAIN_CHUNK_ELEMS = 1 << 26


def split_bf16(x: torch.Tensor):
    """(hi, lo) of f32 x, each a bf16 value widened to f32: hi = bf16(x),
    lo = bf16(x - hi), both rounded to nearest even (as ``_dot3`` splits
    with ``astype(bfloat16)``)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def split_planes(blocks: torch.Tensor) -> torch.Tensor:
    """K3's blocks as a "high" plan holds them: the two bf16 planes of the
    f32 (S, b, b) blocks, hi = bf16(a) and lo = bf16(a - hi) (``_dot3``'s
    lh and ll), in one contiguous (2*S*b, b) bf16 tensor, hi in rows 0 ..
    S*b-1 and lo after them."""
    b = blocks.shape[-1]
    hi, lo = split_bf16(blocks.float())
    return torch.cat([hi.reshape(-1, b), lo.reshape(-1, b)]).to(torch.bfloat16)


def block_planes(planes: torch.Tensor):
    """(hi, lo) of split_planes' (2*S*b, b) tensor, each an (S, b, b)
    bf16 view."""
    b = planes.shape[1]
    hi, lo = planes.reshape(2, -1, b, b).unbind(0)
    return hi, lo


def split_operand_plain(dense: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's operand split (``split_operand``): the f32
    (N, F) operand as one (2N, ld) bf16 tensor, rows 0 .. N-1 hi =
    bf16(x) and rows N .. 2N-1 lo = bf16(x - hi), ld = F rounded up to a
    multiple of 8 with zero pad columns (16-byte rows for TMA)."""
    n, F = dense.shape
    hi, lo = split_bf16(dense.float())
    out = torch.zeros(2 * n, -(-F // 8) * 8, dtype=torch.bfloat16,
                      device=dense.device)
    out[:n, :F] = hi
    out[n:, :F] = lo
    return out


def _gathered_products(slot_cols, blocks, dense_b, s0, s1, bf16x3=False):
    """f32 products blocks[s0:s1] @ dense_b[slot_cols[s0:s1]], (n, b, F);
    dense_b is the operand viewed as (nbc, b, F). bf16x3: blocks are
    split_planes' two planes, and the products are the three f32 products
    of the bf16 splits, hi·hi + hi·lo + lo·hi, as ``_dot3`` sums them (a
    product of two bf16 values is exact in f32)."""
    cols = slot_cols[s0:s1].long()
    x = dense_b[cols].float()
    if not bf16x3:
        return torch.bmm(blocks[s0:s1].float(), x)
    ah, al = (p[s0:s1].float() for p in block_planes(blocks))
    xh, xl = split_bf16(x)
    return torch.bmm(ah, xh) + torch.bmm(ah, xl) + torch.bmm(al, xh)


def lane_scatter(dest, valid, n_block_rows: int, b: int, F: int, R: int,
                 gh: int, lane_sums) -> torch.Tensor:
    """The plain versions' common loop. Every layout is steps of R lanes
    of gh slots; lane_sums(j0, j1) gives the (j1-j0, R, b, F) f32 lane
    sums of steps j0 .. j1-1, and lane (j, r) adds into block-row
    dest[j, r] where valid[j, r] (None: all valid). Chunked over steps
    to bound the gathered operand's memory. Returns (n_block_rows*b, F)
    f32."""
    out = torch.zeros(n_block_rows, b, F, dtype=torch.float32, device=dest.device)
    n_steps = dest.shape[0]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, R * gh * b * F))
    for j0 in range(0, n_steps, chunk):
        j1 = min(n_steps, j0 + chunk)
        sums = lane_sums(j0, j1)
        if valid is None:
            out.index_add_(0, dest[j0:j1].reshape(-1), sums.reshape(-1, b, F))
        else:
            m = valid[j0:j1]
            out.index_add_(0, dest[j0:j1][m], sums[m])
    return out.reshape(n_block_rows * b, F)


def sorted_lanes(win_ids, pos, lane_valid, group_ptr, R: int, window: int):
    """(dest, valid), each (T, R), of the depth-sorted layout: lane r of
    step j belongs to block-row win_ids[j]*window + pos[j*R + r]; absent
    lanes (window padding) are not valid."""
    n_groups = group_ptr.shape[0] - 1
    step_group = torch.repeat_interleave(
        torch.arange(n_groups, device=win_ids.device), group_ptr.diff()
    )
    valid = lane_valid.reshape(n_groups, R)[step_group]
    dest = win_ids.long()[:, None] * window + pos.long().reshape(-1, R)
    return dest, valid


def rowgroup_lanes(step_groups, R: int, n_block_rows: int):
    """(dest, valid), each (T, R), of the consecutive row-group layout:
    lane r of step j belongs to block-row step_groups[j]*R + r; the
    phantom lanes that pad the last group (rows >= n_block_rows) are not
    valid."""
    lanes = torch.arange(R, device=step_groups.device)
    dest = step_groups.long()[:, None] * R + lanes
    return dest, dest < n_block_rows


def _f32_lane_sums(slot_cols, blocks, dense_b, R: int, gh: int,
                   bf16x3: bool = False):
    """lane_sums for lane_scatter; dense_b is the operand viewed as
    (nbc, b, F)."""
    b, F = dense_b.shape[1:]

    def lane_sums(j0, j1):
        prod = _gathered_products(slot_cols, blocks, dense_b,
                                  j0 * R * gh, j1 * R * gh, bf16x3)
        return prod.reshape(j1 - j0, R, gh, b, F).sum(dim=2)

    return lane_sums


def _blocked(dense, b: int) -> torch.Tensor:
    """The (nbc*b, F) operand viewed as (nbc, b, F)."""
    return dense.reshape(-1, b, dense.shape[1])


def spmm_flat_plain(step_rows, slot_cols, blocks, dense, n_block_rows: int,
                    group: int, bf16x3: bool = False) -> torch.Tensor:
    """Plain version of K1 (and of K3 on its layout, bf16x3=True) on the
    flat layout: step j's `group` slot products are summed and added
    into block-row step_rows[j]. Returns (n_block_rows*b, F) f32."""
    b = blocks.shape[1]
    return lane_scatter(
        step_rows.long()[:, None], None, n_block_rows, b, dense.shape[1], 1,
        group, _f32_lane_sums(slot_cols, blocks, _blocked(dense, b), 1, group,
                              bf16x3),
    )


def _flat_view(dense3, b: int) -> torch.Tensor:
    """K5's operand, (nbc, b, F), as the (nbc*b, F) operand K1's walk
    reads (a view of a contiguous dense3)."""
    if dense3.dim() != 3 or dense3.shape[1] != b:
        raise ValueError(f"dense3 must be (nbc, b, F), got {tuple(dense3.shape)}")
    return dense3.flatten(0, 1)


def spmm_resident_plain(step_rows, slot_cols, blocks, dense3,
                        n_block_rows: int, group: int,
                        bf16x3: bool = False) -> torch.Tensor:
    """Plain version of K5 (and of K3 on its layout): K1's packed arrays
    with the operand dense3 (nbc, b, F), whose slot s reads dense3[col],
    as ``_resident_kernel`` indexes it. That is K1's plain version on the
    (nbc*b, F) view. Returns (n_block_rows*b, F) f32."""
    return spmm_flat_plain(step_rows, slot_cols, blocks,
                           _flat_view(dense3, blocks.shape[1]), n_block_rows,
                           group, bf16x3)


def spmm_sorted_plain(win_ids, pos, slot_cols, blocks, dense, lane_valid,
                      group_ptr, n_block_rows: int, R: int, gh: int,
                      window: int, bf16x3: bool = False) -> torch.Tensor:
    """Plain version of K2 (and of K3 on its layout) on the depth-sorted
    layout: lane r of step j sums its gh slot products into block-row
    win_ids[j]*window + pos[j*R + r]; absent lanes add nothing. Returns
    (n_block_rows*b, F) f32."""
    b = blocks.shape[1]
    dest, valid = sorted_lanes(win_ids, pos, lane_valid, group_ptr, R, window)
    return lane_scatter(
        dest, valid, n_block_rows, b, dense.shape[1], R, gh,
        _f32_lane_sums(slot_cols, blocks, _blocked(dense, b), R, gh, bf16x3),
    )


def spmm_rowgroup_plain(step_groups, slot_cols, blocks, dense,
                        n_block_rows: int, R: int, gh: int) -> torch.Tensor:
    """Plain version of K4 on the consecutive row-group layout: lane r of
    step j sums its gh slot products into block-row step_groups[j]*R +
    r; phantom lanes add nothing. Returns (n_block_rows*b, F) f32."""
    b = blocks.shape[1]
    dest, valid = rowgroup_lanes(step_groups, R, n_block_rows)
    return lane_scatter(
        dest, valid, n_block_rows, b, dense.shape[1], R, gh,
        _f32_lane_sums(slot_cols, blocks, _blocked(dense, b), R, gh),
    )


# -- kernel wrappers --------------------------------------------------------

SUPPORTED_BLOCK_SIZES = (16, 32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_BN = 128  # the widest F tile of a BSR entry (tile_geometry, _small_bn)


def check_cuda_operands(blocks, dense, index_arrays, dtypes=_KERNEL_DTYPES,
                        bf16x3: bool = False, contiguous: bool = True):
    """What the CUDA kernels take: b in SUPPORTED_BLOCK_SIZES, blocks and
    dense of one dtype of `dtypes` (K3, bf16x3=True: split_planes' bf16
    planes and an f32 operand), dense rows a multiple of b, all
    contiguous (dense of any strides with contiguous=False: the wrapper
    copies it), the other arrays ({name: (tensor, dtype)}) of their
    expected types. Returns the number of slots S."""
    if bf16x3:
        b = blocks.shape[-1]
        if blocks.dim() != 2 or blocks.shape[0] % (2 * b):
            raise ValueError(f"K3's blocks must be the (2*S*b, b) planes of "
                             f"split_planes, got {tuple(blocks.shape)}")
        if blocks.dtype != torch.bfloat16 or dense.dtype != torch.float32:
            raise TypeError(f"K3 takes bf16 block planes and an f32 operand, "
                            f"got dtypes {blocks.dtype} and {dense.dtype}")
        n_slots = blocks.shape[0] // (2 * b)
    else:
        if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
            raise ValueError(f"blocks must be (S, b, b), got {tuple(blocks.shape)}")
        b, n_slots = blocks.shape[1], blocks.shape[0]
        if blocks.dtype not in dtypes or dense.dtype != blocks.dtype:
            raise TypeError(
                f"blocks {blocks.dtype} and dense {dense.dtype} must share one "
                f"dtype of {dtypes}"
            )
    if b not in SUPPORTED_BLOCK_SIZES:
        raise ValueError(
            f"block size {b} not supported by the CUDA kernels "
            f"(supported: {SUPPORTED_BLOCK_SIZES})"
        )
    if dense.dim() != 2 or dense.shape[0] % b:
        raise ValueError(
            f"dense must be (nbc*b, F) with b={b}, got {tuple(dense.shape)}"
        )
    checked = [("blocks", blocks, None)] + [("dense", dense, None)] * contiguous
    check_arrays(checked + [(n, t, dtype) for n, (t, dtype) in index_arrays.items()])
    return n_slots


def tile_geometry(b: int, n_rows: int, F: int, n_sms: int, row_align: int):
    """(bn, ld) of a launch over n_rows block-rows (its valid lanes, one
    CTA row each) on a card of n_sms SMs: the F tile width and the
    operand's row length as the kernel reads it.

    The kernels' 16-byte copies need rows of a multiple of row_align
    elements (8 bf16, 4 f32; 1 for int8, whose ring reads a transposed
    operand): ld is F rounded up to one (the wrapper pads the operand's
    columns only then). b = 64 and 128 run the tensor-core ring or the
    exact-f32 kernels' pipelined FFMA loop: bn is 128 where F needs more
    than 64 columns and the grid (n_rows * ceil(F / 128) CTAs) still
    covers the SMs, else 64 (the ring's two-level sums hold 2 x bn/2
    registers a thread, which caps bn at 128). b = 16 and 32: 64-column
    tiles, at which no entry launches: the bf16, K3, exact-f32 and int8
    entries there take bf16_small_geometry's, f32_small_geometry's or
    int8_small_geometry's width, which keeps the plan's deepest lane in
    view."""
    ld = -(-F // row_align) * row_align
    if b < 64:
        return 64, ld
    bn = MAX_BN if F > 64 and n_rows * -(-F // MAX_BN) >= n_sms else 64
    return bn, ld


# How many CTAs of a grid's average work a hub lane's CTA may take: it
# shares its SM with other CTAs, and on the arxiv stand-in (gorder, F =
# 128) its instance ran fastest at the BN this share picks, at b = 32 and
# at 16 (scripts/torch_kernel_variants.py f32_small)
F32_SMALL_HUB_SHARE = 2
# The same for the small-block tensor-core loop (bf16 and K3 at b = 16 and
# 32), whose hub CTA waits on its slots' reads rather than on FMAs: on the
# arxiv stand-in this share picked the fastest of BN = 32, 64 and 128 for
# bf16 K2 and K3 at b = 32 and 16 under gorder (64 and 32) and at b = 32
# under rcmk (128, no hub) (scripts/torch_kernel_variants.py bf16_small)
BF16_SMALL_HUB_SHARE = 2


def _small_bn(F: int, n_sms: int, n_slots: int, depth: int, share: float) -> int:
    """The widest of 128, 64 and 32 columns that F needs and at which the
    deepest lane's CTA, depth * bn slot-columns, stays within n_slots * F
    / (n_sms * share); else 32. A lane's sum cannot be split across CTAs,
    so each of its F tiles is one CTA walking all its slots, and a
    narrower tile puts more CTAs on a hub lane."""
    limit = n_slots * F / (n_sms * share)
    for bn in (MAX_BN, 64):
        if F > bn // 2 and depth * bn <= limit:
            return bn
    return 32


def f32_small_geometry(b: int, F: int, n_sms: int, n_slots: int, depth: int):
    """(bn, ld) of the exact-f32 entries at b = 16 and 32 (the pipelined
    FFMA loop's small instances: b/8 warps a CTA, microtiles of bn/4
    outputs) for a plan of n_slots slots whose deepest lane holds `depth`:
    _small_bn's width at F32_SMALL_HUB_SHARE (a hub lane's CTA does depth
    * 2b² * bn FLOP; a narrower tile puts more warps on it, b·F/(8·bn) of
    them, at fewer FMAs a shared load). ld is F rounded up to a multiple
    of 4 (the loop's 16-byte copies)."""
    return _small_bn(F, n_sms, n_slots, depth, F32_SMALL_HUB_SHARE), -(-F // 4) * 4


def bf16_small_geometry(b: int, F: int, n_sms: int, n_slots: int, depth: int):
    """(bn, ld) of the bf16 and K3 entries at b = 16 and 32 (the
    small-block tensor-core loop: 4 warps a CTA, each bn/4 columns of the
    b x bn tile) for a plan of n_slots slots whose deepest lane holds
    `depth`: _small_bn's width at BF16_SMALL_HUB_SHARE. ld is F rounded up
    to a multiple of 8 (16-byte copies of bf16 rows; K3's split operand
    has rows of this ld)."""
    return _small_bn(F, n_sms, n_slots, depth, BF16_SMALL_HUB_SHARE), -(-F // 8) * 8


def bf16_tile_geometry(b: int, n_rows: int, F: int, n_sms: int):
    """tile_geometry of the tensor-core ring (bf16 K1, K2, K4 and K5, and
    K3, whose split operand has rows of this ld, at b = 64 and 128): rows
    of a multiple of 8 bf16."""
    return tile_geometry(b, n_rows, F, n_sms, 8)


def _operand_rows(dense, ld: int):
    """The operand the kernel reads: padded to ld columns where ld > F,
    else the operand itself, copied when it does not start on 16 bytes (a
    view at an odd offset; TMA maps and 16-byte copies need an aligned
    base)."""
    if ld != dense.shape[1]:
        return torch.nn.functional.pad(dense, (0, ld - dense.shape[1]))
    return dense.clone() if dense.data_ptr() % 16 else dense


def _tile_launch_args(b: int, n_slots: int, dense, n_rows: int,
                      row_align: int) -> tuple:
    """(n_slots, n_dense_rows, F, ld), bn, and the operand the kernel
    reads (_operand_rows at tile_geometry's ld)."""
    F = dense.shape[1]
    bn, ld = tile_geometry(b, n_rows, F, _sm_count(dense.device.index), row_align)
    dense = _operand_rows(dense, ld)
    return (n_slots, dense.shape[0], F, ld), bn, dense


def _small_bn_of(geometry, b: int, n_slots: int, dense, depth) -> tuple:
    """(bn, ld) of an entry at b = 16 and 32 from `geometry`
    (f32_small_geometry or bf16_small_geometry) for the plan's deepest
    lane; without a depth it raises (no geometry to fall back to)."""
    if depth is None:
        raise ValueError("the entries at b = 16 and 32 need the plan's deepest "
                         "lane (depth) and lane_order")
    return geometry(b, dense.shape[1], _sm_count(dense.device.index), n_slots, depth)


def _bf16_launch_args(blocks, dense, n_rows: int, depth: Optional[int] = None) -> tuple:
    """The trailing arguments of a bf16 entry, (n_slots, n_dense_rows,
    F, ld), then bn, and the operand the kernel reads, rows of a multiple
    of 8 bf16: at b = 64 and 128 _tile_launch_args's, at b = 16 and 32
    bf16_small_geometry's for the plan's deepest lane (`depth` slots)."""
    b, n_slots, F = blocks.shape[1], blocks.shape[0], dense.shape[1]
    if b >= 64:
        return _tile_launch_args(b, n_slots, dense, n_rows, 8)
    bn, ld = _small_bn_of(bf16_small_geometry, b, n_slots, dense, depth)
    return (n_slots, dense.shape[0], F, ld), bn, _operand_rows(dense, ld)


def _f32_launch_args(blocks, dense, n_rows: int, depth: Optional[int] = None) -> tuple:
    """(F, ld), bn and the operand an exact-f32 entry (K1, K2, K4, K5)
    reads, rows of a multiple of 4 f32 (the pipelined FFMA loop's 16-byte
    copies): at b = 64 and 128 _tile_launch_args's, at b = 16 and 32
    f32_small_geometry's for the plan's deepest lane (`depth` slots)."""
    b, F = blocks.shape[1], dense.shape[1]
    if b >= 64:
        sizes, bn, dense = _tile_launch_args(b, blocks.shape[0], dense, n_rows, 4)
        return sizes[2:], bn, dense
    bn, ld = _small_bn_of(f32_small_geometry, b, blocks.shape[0], dense, depth)
    return (F, ld), bn, _operand_rows(dense, ld)


def _lane_order_arg(lane_order, n_lanes: int, dev) -> int:
    """The lane_order pointer a BSR entry takes (0: none, which the
    entries refuse at b = 16 and 32; the rings at b = 64 and 128 do not
    read it)."""
    if lane_order is None:
        return 0
    if (lane_order.device != dev or lane_order.dtype != torch.int32
            or lane_order.shape != (n_lanes,) or not lane_order.is_contiguous()):
        raise ValueError(f"lane_order must be a contiguous ({n_lanes},) int32 "
                         f"tensor on {dev}")
    return lane_order.data_ptr()


def split_operand(dense: torch.Tensor) -> torch.Tensor:
    """K3's operand split: the f32 (N, F) operand as split_operand_plain's
    (2N, ld) bf16 planes. CPU tensors run split_operand_plain; CUDA
    tensors launch split_bf16_kernel (any alignment of the operand; the
    result is a fresh, 16-byte-aligned buffer)."""
    if dense.device.type == "cpu":
        return split_operand_plain(dense)
    if dense.dtype != torch.float32 or dense.dim() != 2 or not dense.is_contiguous():
        raise TypeError(f"split_operand takes a contiguous 2-D f32 operand, got "
                        f"dtype {dense.dtype}, shape {tuple(dense.shape)}")
    n, F = dense.shape
    out = torch.empty(2 * n, -(-F // 8) * 8, dtype=torch.bfloat16, device=dense.device)
    with torch.cuda.device(dense.device):
        _kernels.split_bf16(dense.data_ptr(), out.data_ptr(), n, F, out.shape[1],
                            torch.cuda.current_stream(dense.device).cuda_stream)
    return out


def _k3_launch_args(b: int, n_slots: int, dense, n_rows: int,
                    depth: Optional[int] = None) -> tuple:
    """The trailing arguments of a K3 entry, (n_slots, n_dense_rows, F,
    ld), then bn (bf16_tile_geometry's at b = 64 and 128,
    bf16_small_geometry's for the plan's deepest lane at b = 16 and 32,
    which raises without a depth before any launch), and the operand's
    planes (one split per call, rows of ld)."""
    F = dense.shape[1]
    if b >= 64:
        bn = bf16_tile_geometry(b, n_rows, F, _sm_count(dense.device.index))[0]
    else:
        bn = _small_bn_of(bf16_small_geometry, b, n_slots, dense, depth)[0]
    xp = split_operand(dense)
    return (n_slots, dense.shape[0], F, xp.shape[1]), bn, xp


def spmm_flat(step_rows, step_ptr, slot_cols, blocks, dense, group: int,
              bf16x3: bool = False, resident: bool = False, lane_order=None,
              depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K1 (K3 with bf16x3=True): C (n_block_rows*b, F) f32 on the flat
    grouped layout. resident=True launches the same kernel through K5's
    entries (``spmm_resident``).

    step_ptr (n_block_rows+1,) int64 points each block-row at its steps
    (derived from the sorted step_rows at plan time). CPU tensors, and
    any with plain=True, run spmm_flat_plain; CUDA tensors run the CUDA
    kernel: f32 operands the
    FFMA entry, bf16 the bf16 entry, as spmm_sorted, at the geometry of
    n_block_rows lanes; bf16x3 (blocks: split_planes' planes, f32
    operand) K3's entry after split_operand. lane_order and depth (the
    plan's, ``lane_order``) are read by every entry at b = 16 and 32,
    which needs them."""
    dev = _device_of(step_rows, step_ptr, slot_cols, blocks, dense)
    n_block_rows = step_ptr.shape[0] - 1
    if plain or dev.type == "cpu":
        return spmm_flat_plain(step_rows, slot_cols, blocks, dense,
                               n_block_rows, group, bf16x3)
    n_slots = check_cuda_operands(blocks, dense, {
        "step_ptr": (step_ptr, torch.int64),
        "slot_cols": (slot_cols, torch.int32),
    }, bf16x3=bf16x3)
    if slot_cols.shape[0] != n_slots or n_slots % group:
        raise ValueError("slot_cols and blocks must hold n_steps*group slots")
    b = blocks.shape[1]
    F = dense.shape[1]
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    bf16 = blocks.dtype == torch.bfloat16 and not bf16x3
    kernel = getattr(_kernels, "bsr_spmm_" + ("resident" if resident else "flat")
                     + ("_bf16x3" if bf16x3 else "_bf16" if bf16 else ""))
    pointers = (step_ptr.data_ptr(), slot_cols.data_ptr(),
                _lane_order_arg(lane_order, n_block_rows, dev))
    with torch.cuda.device(dev):
        if bf16x3:
            sizes, bn, dense = _k3_launch_args(b, n_slots, dense, n_block_rows, depth)
        elif bf16:
            sizes, bn, dense = _bf16_launch_args(blocks, dense, n_block_rows, depth)
        else:
            sizes, bn, dense = _f32_launch_args(blocks, dense, n_block_rows, depth)
        kernel(*pointers, blocks.data_ptr(), dense.data_ptr(), out.data_ptr(),
               n_block_rows, *sizes, group, b, bn,
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def spmm_resident(step_rows, step_ptr, slot_cols, blocks, dense3, group: int,
                  bf16x3: bool = False, lane_order=None,
                  depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K5 (K3 with bf16x3=True): C (n_block_rows*b, F) f32 on K1's packed
    arrays with the operand dense3 viewed as (nbc, b, F).

    On the TPU this layout keeps the whole operand slice in VMEM and
    indexes it per slot; on the card nothing is kept resident, and K5's
    entries run K1's CTA walk on the (nbc*b, F) view. CPU tensors, and
    any with plain=True, run spmm_resident_plain; CUDA tensors run the
    CUDA kernel."""
    if plain or _device_of(step_rows, step_ptr, slot_cols, blocks, dense3).type == "cpu":
        return spmm_resident_plain(step_rows, slot_cols, blocks, dense3,
                                   step_ptr.shape[0] - 1, group, bf16x3)
    return spmm_flat(step_rows, step_ptr, slot_cols, blocks,
                     _flat_view(dense3, blocks.shape[1]), group, bf16x3,
                     resident=True, lane_order=lane_order, depth=depth)


def spmm_sorted(win_ids, pos, slot_cols, blocks, dense, lane_valid, group_ptr,
                n_block_rows: int, R: int, gh: int, window: int,
                bf16x3: bool = False, lane_order=None,
                depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K2 (K3 with bf16x3=True): C (n_block_rows*b, F) f32 on the
    depth-sorted layout.

    lane_valid (n_groups*R,) bool and group_ptr (n_groups+1,) int64 come
    from the port's packer, lane_order (n_groups*R,) int32 and depth from
    ``lane_order`` (every entry at b = 16 and 32 needs them). CPU
    tensors, and any with plain=True, run spmm_sorted_plain; CUDA tensors
    run the CUDA kernel: f32 operands
    the pipelined FFMA loop (at tile_geometry's tile width at b >= 64, at
    f32_small_geometry's below, the operand's columns padded to a
    multiple of 4 where F is ragged: _f32_launch_args), bf16 the bf16
    entry (the wgmma ring at bf16_tile_geometry's tile width at b >= 64,
    the small-block mma.sync loop at bf16_small_geometry's below, the
    operand's columns padded to a multiple of 8 where F is ragged:
    _bf16_launch_args), bf16x3 (blocks: split_planes' planes) K3's entry
    after split_operand, on the same two loops."""
    dev = _device_of(win_ids, pos, slot_cols, blocks, dense, lane_valid, group_ptr)
    if plain or dev.type == "cpu":
        return spmm_sorted_plain(win_ids, pos, slot_cols, blocks, dense,
                                 lane_valid, group_ptr, n_block_rows, R, gh,
                                 window, bf16x3)
    n_slots = check_cuda_operands(blocks, dense, {
        "win_ids": (win_ids, torch.int32),
        "pos": (pos, torch.int32),
        "slot_cols": (slot_cols, torch.int32),
        "lane_valid": (lane_valid, torch.bool),
        "group_ptr": (group_ptr, torch.int64),
    }, bf16x3=bf16x3)
    n_lanes = lane_valid.shape[0]
    if n_lanes != (group_ptr.shape[0] - 1) * R:
        raise ValueError("lane_valid must hold n_groups*R lanes")
    if slot_cols.shape[0] != n_slots or n_slots != win_ids.shape[0] * R * gh:
        raise ValueError("slot_cols and blocks must hold n_steps*R*gh slots")
    b = blocks.shape[1]
    F = dense.shape[1]
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        pointers = (group_ptr.data_ptr(), win_ids.data_ptr(), pos.data_ptr(),
                    lane_valid.data_ptr(), slot_cols.data_ptr(),
                    _lane_order_arg(lane_order, n_lanes, dev), blocks.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16x3:
            sizes, bn, xp = _k3_launch_args(b, n_slots, dense, n_block_rows, depth)
            _kernels.bsr_spmm_sorted_bf16x3(
                *pointers, xp.data_ptr(), out.data_ptr(), n_lanes, *sizes, R,
                gh, window, b, bn, stream)
        elif blocks.dtype == torch.bfloat16:
            sizes, bn, dense = _bf16_launch_args(blocks, dense, n_block_rows, depth)
            _kernels.bsr_spmm_sorted_bf16(
                *pointers, dense.data_ptr(), out.data_ptr(), n_lanes,
                *sizes, R, gh, window, b, bn, stream)
        else:
            sizes, bn, dense = _f32_launch_args(blocks, dense, n_block_rows, depth)
            _kernels.bsr_spmm_sorted(
                *pointers, dense.data_ptr(), out.data_ptr(), n_lanes, *sizes,
                R, gh, window, b, bn, stream)
    return out


def spmm_rowgroup(step_groups, group_ptr, slot_cols, blocks, dense,
                  n_block_rows: int, R: int, gh: int, lane_order=None,
                  depth: Optional[int] = None, plain: bool = False) -> torch.Tensor:
    """K4: C (n_block_rows*b, F) f32 on the consecutive row-group layout.

    group_ptr (n_groups+1,) int64 points each group at its steps
    (group_pointer at plan time). CPU tensors, and any with plain=True,
    run spmm_rowgroup_plain; CUDA tensors run the CUDA kernel, whose
    phantom lanes store nothing:
    f32 operands the FFMA entry, bf16 the bf16 entry, as spmm_sorted, at
    the geometry of n_block_rows lanes; lane_order and depth as
    spmm_sorted's."""
    dev = _device_of(step_groups, group_ptr, slot_cols, blocks, dense)
    if plain or dev.type == "cpu":
        return spmm_rowgroup_plain(step_groups, slot_cols, blocks, dense,
                                   n_block_rows, R, gh)
    check_cuda_operands(blocks, dense, {
        "group_ptr": (group_ptr, torch.int64),
        "slot_cols": (slot_cols, torch.int32),
    })
    check_rowgroup_geometry(step_groups, group_ptr, slot_cols, blocks,
                            n_block_rows, R, gh)
    b = blocks.shape[1]
    F = dense.shape[1]
    n_lanes = (group_ptr.shape[0] - 1) * R
    out = torch.empty(n_block_rows * b, F, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        pointers = (group_ptr.data_ptr(), slot_cols.data_ptr(),
                    _lane_order_arg(lane_order, n_lanes, dev), blocks.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        if blocks.dtype == torch.bfloat16:
            sizes, bn, dense = _bf16_launch_args(blocks, dense, n_block_rows, depth)
            _kernels.bsr_spmm_rowgroup_bf16(
                *pointers, dense.data_ptr(), out.data_ptr(), n_lanes,
                n_block_rows, *sizes, R, gh, b, bn, stream)
        else:
            sizes, bn, dense = _f32_launch_args(blocks, dense, n_block_rows, depth)
            _kernels.bsr_spmm_rowgroup(
                *pointers, dense.data_ptr(), out.data_ptr(), n_lanes,
                n_block_rows, *sizes, R, gh, b, bn, stream)
    return out


def check_rowgroup_geometry(step_groups, group_ptr, slot_cols, blocks,
                            n_block_rows: int, R: int, gh: int) -> None:
    """The row-group arrays agree: R*gh slots per step, and the groups'
    R lanes cover every block-row (the last group may hold phantoms)."""
    n_groups = group_ptr.shape[0] - 1
    if slot_cols.shape[0] != blocks.shape[0] or blocks.shape[0] != step_groups.shape[0] * R * gh:
        raise ValueError("slot_cols and blocks must hold n_steps*R*gh slots")
    if not (n_groups - 1) * R < n_block_rows <= n_groups * R:
        raise ValueError(
            f"{n_groups} groups of {R} lanes do not cover {n_block_rows} "
            "block-rows"
        )


def route_pallas_spmm(step_rows, slot_cols, blocks, dense, n_block_rows: int,
                      n_rows: int, walk: dict, group: int = 1,
                      precision_name: Optional[str] = None, row_group=0,
                      plain: bool = False) -> torch.Tensor:
    """The kernel router of a distributed plan's stripe (twin of the JAX
    package's ``route_pallas_spmm``): an already packed bucket layout
    (``parallel.shard.pack_buckets_pallas``, trimmed to its real steps)
    and the local dense operand (K_local, F) -> C (n_rows, F) f32.

    row_group picks the entry as the JAX router does: ("sorted", R, gh,
    W), the depth-sorted layout whose step_rows carry [win_ids (T,) |
    lane positions (T*R,)] concatenated, runs K2; a plain R > 0, the
    consecutive row groups, runs K4; 0, the flat layout, runs K5 (the
    resident entry) for a 2-byte operand under precision_name None, as
    the JAX router does where its VMEM fit holds, and K1 otherwise.
    precision_name "high" on an f32 operand runs K3's instance of the
    chosen kernel, and then `blocks` holds the bucket's bf16 planes
    (``split_planes``), as a single-card "high" plan does; on a bf16
    operand it is the exact bf16 product. precision_name "default" on an
    f32 operand is one bf16 pass: `blocks` holds the bucket's blocks
    rounded to bf16, the operand is rounded here once a call, and the
    flat layout (the only one the plans pack for it) runs bf16 K1. The
    TPU's VMEM fits are not carried over: every layout's kernel runs at
    any operand width.

    walk: the port's extras of the bucket (pack_buckets_pallas): "ptr"
    (the step or group pointer over the real steps), "lane_order",
    "depth" and, for the sorted layout, "lane_valid". plain=True runs
    the kernels' plain versions on any device (the wrappers' choice)."""
    b = blocks.shape[1]
    bf16x3 = precision_name == "high" and dense.dtype == torch.float32
    if precision_name == "default":  # one bf16 pass on the bf16 entries
        dense = dense.to(torch.bfloat16)
    order = {"lane_order": walk["lane_order"], "depth": walk["depth"], "plain": plain}
    if isinstance(row_group, tuple) and row_group and row_group[0] == "sorted":
        _, R, gh, W = row_group
        T = step_rows.shape[0] // (1 + R)
        out = spmm_sorted(step_rows[:T], step_rows[T:], slot_cols, blocks, dense,
                          walk["lane_valid"], walk["ptr"], n_block_rows, R, gh, W,
                          bf16x3=bf16x3, **order)
    elif row_group:
        out = spmm_rowgroup(step_rows, walk["ptr"], slot_cols, blocks, dense,
                            n_block_rows, row_group, group, **order)
    elif (dense.shape[0] % b == 0 and dense.dtype.itemsize == 2
          and precision_name is None):
        out = spmm_resident(step_rows, walk["ptr"], slot_cols, blocks,
                            dense.reshape(-1, b, dense.shape[1]), group, **order)
    else:
        out = spmm_flat(step_rows, walk["ptr"], slot_cols, blocks, dense, group,
                        bf16x3, **order)
    return out[:n_rows]


# -- the plan ---------------------------------------------------------------


def _plan_dtype(dtype) -> Optional[torch.dtype]:
    """None (f32 operands), torch.float32 or torch.bfloat16; int8 raises
    ValueError (it needs the quantized tier), as does anything else."""
    if dtype is None:
        return None
    reject_int8_cast(dtype, "bsr_pallas (use bsr_int8_pallas)")
    name = dtype_name(dtype)
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported dtype {dtype!r} (None, float32 or bfloat16)")


def _plan_math(precision: Optional[str], dtype) -> str:
    """The products a plan runs: "exact" (f32 FFMA; bf16 x bf16 is exact
    in f32), "bf16x3" (K3: precision="high" on f32 operands) or "bf16"
    (precision="default" on f32 operands: the TPU's one bf16 pass, both
    operands rounded to bf16 to nearest even, f32 products and sums, on
    the bf16 entries). On bf16 operands "high" and "default" are exact:
    _dot3's split of a bf16 value is the value and a zero residual, and
    one bf16 pass over bf16 values rounds nothing. "highest" on bf16
    operands raises: the TPU compiler refuses an f32 contract on bf16
    vectors (the JAX kernel's note at its precision choice)."""
    two_byte = dtype == torch.bfloat16
    if precision is None:
        return "exact"
    if precision == "highest":
        if two_byte:
            raise NotImplementedError(
                "precision='highest' with bf16 operands: the TPU compiler "
                "refuses an f32 contract on bf16 vectors, so the JAX kernel has "
                "no such instance; use None, 'high' or 'default'"
            )
        return "exact"
    if precision in ("high", "default"):
        if two_byte:
            return "exact"
        return "bf16x3" if precision == "high" else "bf16"
    raise ValueError(
        f"unknown precision {precision!r} (None, 'default', 'high' or 'highest')"
    )


def bsr_spmm_pallas_plan(
    bsr: BSR,
    dtype=None,
    group: Optional[int] = None,
    precision: Optional[str] = None,
    grad: bool = True,
    resident: Optional[bool] = None,
    depth_sort: Optional[bool] = None,
    device=None,
) -> Plan:
    """Host layout prep once -> Plan computing C = A @ dense in f32.

    dtype: None or float32 (exact f32 products) or bfloat16 (bf16 blocks
    and operand, f32 sum); int8 raises ValueError (use
    ``bsr_spmm_pallas_int8_plan``). group: slots per step (flat layouts)
    or per lane (row-group layouts); None picks the JAX plan's rule.
    precision: None or "highest" (exact f32; "highest" on bf16 raises
    NotImplementedError), "high" (bf16x3, K3, on f32 operands; exact on
    bf16) or "default" (one bf16 pass on f32 operands: the blocks and the
    operand rounded to bf16, f32 sums, the bf16 kernels; exact on bf16).
    grad: True (the default) returns a grad_plan whose backward runs a
    plan of Aᵀ built with the same arguments; False a forward plan.
    depth_sort: None follows the occupancy gate; True/False force it
    where the dtype allows the sorted layout. resident: True sends the
    flat layout to K5; False keeps bf16 on the flat layout (K1). device:
    where the packed arrays live, None for the card; the plan runs its
    kernels there (``plan.to(device)`` moves it).

    Layout (the JAX plan's gate without its VMEM fit checks): bf16 with
    precision None and resident not False takes the depth-sorted layout
    (K2) when depth_sort holds, which by default is at >= 2 real blocks
    per block-row, and the consecutive row-group layout (K4) otherwise,
    at power-of-two groups; f32 with precision None or "high" takes the
    sorted layout at >= 8 and depth_sort, unless resident=False;
    everything else packs the flat layout at the _auto_group rule, run
    by K5 with resident=True and by K1 otherwise: "default" always lands
    there. "high" runs the K3 instance of the chosen f32 kernel,
    "default" on f32 the bf16 instance of K1 or K5.

    The plan's work figures (``ops/plan``): nnz, the nonzero entries of
    the blocks; positions, b² for each slot the kernel multiplies
    (``walked_slots``)."""
    device = resolve_device(device)
    dtype = _plan_dtype(dtype)
    math = _plan_math(precision, dtype)
    if grad:
        kw = dict(dtype=dtype, group=group, precision=precision,
                  resident=resident, depth_sort=depth_sort, device=device)
        # each plan takes its own layout: Aᵀ's occupancy may differ
        return grad_plan(bsr_spmm_pallas_plan(bsr, grad=False, **kw),
                         bsr_spmm_pallas_plan(bsr.transpose(), grad=False, **kw))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    covered = _ensure_covering(bsr)
    b = covered.b
    n_rows, n_cols = bsr.shape
    nbr = covered.n_block_rows
    k_needed = covered.n_block_cols * b

    rows_h = np.asarray(covered.block_rows[: covered.nnzb])
    cols_h = np.asarray(covered.block_cols[: covered.nnzb])
    blocks_h = np.asarray(covered.blocks[: covered.nnzb])
    layout, group = _layout_gate(bsr.nnzb, covered.nnzb, nbr, itemsize, precision,
                                 resident, depth_sort, group)

    if layout == "sorted":
        R, gh, W = _depth_sort_policy(itemsize, group)
        (win_ids, pos, slot_cols, blocks_pad, _, lane_valid,
         steps_per_group) = _pack_rowgroups_sorted(
            rows_h, cols_h, blocks_h, gh, R, W
        )
        group_ptr = np.concatenate([[0], np.cumsum(steps_per_group)])
        order, depth = lane_order(group_ptr, R, gh)
        arrays = (win_ids, slot_cols, blocks_pad, pos, lane_valid, group_ptr,
                  order)
        geom = (R, gh, W)
        slots = walked_slots(group_ptr, lane_valid, gh)
    elif layout == "rowgroup":
        R, _ = _rowgroup_policy(itemsize, group)
        step_groups, slot_cols, blocks_pad, n_groups = _pack_rowgroups(
            rows_h, cols_h, blocks_h, group, R
        )
        group_ptr = group_pointer(step_groups, n_groups)
        order, depth = lane_order(group_ptr, R, group)
        arrays = (step_groups, slot_cols, blocks_pad, group_ptr, order)
        geom = (R, group)
        slots = walked_slots(group_ptr, np.arange(n_groups * R) < nbr, group)
    else:
        step_rows, slot_cols, blocks_pad = _pack_groups(
            rows_h, cols_h, blocks_h, group
        )
        step_ptr = np.searchsorted(step_rows, np.arange(nbr + 1)).astype(np.int64)
        order, depth = lane_order(step_ptr, 1, group)
        arrays = (step_rows, slot_cols, blocks_pad, step_ptr, order)
        layout, geom = ("resident" if resident else "flat"), group
        slots = walked_slots(step_ptr, np.ones(nbr, bool), group)
    arrays = list(arrays)
    # the blocks' split or cast runs where the plan lives: on the card it
    # takes a fraction of the host's time (a "high" plan of 814,720 32 x 32
    # slots split in ~9 s on the host)
    blocks_t = torch.as_tensor(arrays[2], device=device)
    if math == "bf16x3":  # K3 reads only the two bf16 planes
        arrays[2] = split_planes(blocks_t)
    elif math == "bf16":  # one bf16 pass: the blocks rounded once, here
        arrays[2] = blocks_t.to(torch.bfloat16)
    else:
        arrays[2] = blocks_t.to(dtype) if dtype is not None else blocks_t
    statics = (layout, nbr, n_rows, n_cols, k_needed, math, depth, geom)
    return Plan(arrays, _pallas_apply, statics, device=device, name="bsr_pallas",
                nnz=bsr.nnz_inside(), positions=slots * b * b)


def _pallas_apply(statics, arrays, dense, plain: bool = False):
    layout, nbr, n_rows, n_cols, k_needed, math, depth, geom = statics
    bf16x3 = math == "bf16x3"
    blocks = arrays[2]  # K3: split_planes' planes; the operand stays f32
    dense = torch.as_tensor(dense, device=blocks.device)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    # the operand in the blocks' type: a "bf16" plan rounds it here, once
    dense = dense.to(torch.float32 if bf16x3 else blocks.dtype)
    if k_needed > n_cols:  # zero rows up to the block grid
        dense = torch.nn.functional.pad(dense, (0, 0, 0, k_needed - n_cols))
    dense = dense.contiguous()
    # the walk's CTA -> lane order and deepest lane: the exact-f32 entries'
    walk = {"lane_order": arrays[-1], "depth": depth, "plain": plain}
    if layout == "sorted":
        win_ids, slot_cols, _, pos, lane_valid, group_ptr, _ = arrays
        out = spmm_sorted(win_ids, pos, slot_cols, blocks, dense, lane_valid,
                          group_ptr, nbr, *geom, bf16x3=bf16x3, **walk)
    elif layout == "rowgroup":
        step_groups, slot_cols, _, group_ptr, _ = arrays
        out = spmm_rowgroup(step_groups, group_ptr, slot_cols, blocks,
                            dense, nbr, *geom, **walk)
    else:  # flat or resident: K1's packed arrays
        step_rows, slot_cols, _, step_ptr, _ = arrays
        out = spmm_flat(step_rows, step_ptr, slot_cols, blocks, dense, geom,
                        bf16x3=bf16x3, resident=layout == "resident", **walk)
    return out[:n_rows]


def plain_apply(plan: Plan, dense) -> torch.Tensor:
    """The plan's answer through the kernels' plain PyTorch versions, on
    the plan's device: the reference a kernel is held against on the
    card. Works for the f32/bf16 and the int8 kernel plans, and for grad
    and transb plans over them (both directions run plain)."""
    return run(plan, dense, plain=True)


def bsr_spmm_pallas(bsr: BSR, dense, **kw) -> torch.Tensor:
    return bsr_spmm_pallas_plan(bsr, **kw)(dense)
