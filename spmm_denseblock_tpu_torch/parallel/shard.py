"""Host-side sharding of sparse formats across the ranks of a mesh (twin
of ``spmm_denseblock_tpu/parallel/shard.py``; every array is the JAX
package's, bit for bit).

The sparse matrix A is partitioned by contiguous **block-row stripes**:
shard s owns block-rows [s*rows_per, (s+1)*rows_per). Each shard's block
list is padded to a common nnzb so the stacked arrays have static shapes
(the multi-device analog of BSR.pad_to). Padding blocks are all-zero and
point at the shard's last local block-row, so they contribute nothing.
Every rank computes the same stacked arrays (host prep is deterministic)
and keeps its own stripe.

The per-shard nnz imbalance this padding absorbs is the distributed
analog of the per-warp nnz imbalance a single-GPU kernel fights:
reordered graphs cluster nonzeros deliberately, so stripes are uneven.
`shard_stats` reports the imbalance so benchmarks can quantify it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    _ROWGROUP_GH_CAP,
    _auto_group,
    _auto_group_pow2,
    _pack_groups,
    _pack_rowgroups,
    _pack_rowgroups_sorted,
    group_pointer,
    lane_order,
    per_buffer_col_fill,
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ShardedBSR:
    """Stacked per-shard flat-BSR arrays (host numpy; a plan puts only
    its own rank's stripe on its device).

    local_rows : (n_shards, m) int32 — block-row ids local to the stripe
    block_cols : (n_shards, m) int32 — GLOBAL block-col ids (into the
                 column space padded to n_shards * col_chunk blocks)
    blocks     : (n_shards, m, b, b)
    """

    local_rows: np.ndarray
    block_cols: np.ndarray
    blocks: np.ndarray
    shape: Tuple[int, int]  # logical dense shape of A
    block_size: int
    rows_per_shard: int  # block-rows per stripe
    col_chunk: int  # block-cols per ring chunk (= per-shard B stripe)
    nnzb: int  # real (unpadded) total
    nnzb_per_shard: np.ndarray = None  # (n_shards,) real block counts
    # optional variable contiguous stripe boundaries (n_shards+1,) in
    # block-row units; None = uniform stripes of rows_per_shard. When
    # set, local ids are relative to boundaries[s] and every stripe is
    # PADDED to rows_per_shard (= max stripe height), as in the JAX
    # package, whose one-program rule needs it; B is laid out with the
    # matching padded-stripe view (see parallel/spmm's halo apply).
    boundaries: np.ndarray = None

    @property
    def n_shards(self) -> int:
        return int(self.local_rows.shape[0])

    @property
    def b(self) -> int:
        return self.block_size


def balanced_contiguous_boundaries(bsr: BSR, n_shards: int) -> np.ndarray:
    """Contiguous stripe boundaries with near-equal nnzb per stripe
    (prefix-sum split at load quantiles). Unlike LPT block-row
    permutation, this preserves row ORDER — a banded (reordered) matrix
    stays banded, so halo's O(1)-comms eligibility survives balancing.
    Returns (n_shards+1,) block-row splits with boundaries[0]=0,
    boundaries[-1]=n_block_rows."""
    nbr = bsr.n_block_rows
    counts = np.bincount(
        np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
    ).astype(np.int64)
    csum = np.cumsum(counts)
    total = int(csum[-1])
    targets = total * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(csum, targets, side="left") + 1
    bounds = np.concatenate([[0], cuts, [nbr]]).astype(np.int64)
    # enforce strictly increasing (degenerate loads can collapse cuts)
    for i in range(1, n_shards + 1):
        lo = bounds[i - 1] + 1 if i < n_shards else bounds[i - 1]
        hi = nbr - (n_shards - i) if i < n_shards else nbr
        bounds[i] = min(max(bounds[i], lo), hi)
    return bounds


def block_index_payload(nnzb: int) -> np.ndarray:
    """(nnzb, 1, 1) int64 stand-in for a block-value array: entry i
    holds i+1 (0 = zero block). Every layout stage (shard_bsr /
    bucket_by_col_chunk / bucket_halo / pack_buckets_pallas) only
    permutes blocks, pads with np.zeros, and detects padding via
    abs().sum() != 0 — all of which hold for this payload — so the
    whole shard->bucket->pack pipeline can run on 8-byte tokens instead
    of b*b*4-byte blocks, and the real values are materialized ONCE at
    the end (materialize_packed). At the headline dist shape this cuts
    plan time from 47-89 s to seconds (round-4 verdict #4)."""
    return (np.arange(nnzb, dtype=np.int64) + 1).reshape(-1, 1, 1)


def materialize_packed(idx_payload, blocks) -> np.ndarray:
    """Expand an index payload that rode through the pack pipeline into
    real block values with one zero-init + one gather. idx_payload:
    (..., 1, 1) int64 from block_index_payload; blocks: (nnzb, b, b)."""
    idx = np.asarray(idx_payload)[..., 0, 0]
    blocks = np.asarray(blocks)
    b = blocks.shape[-1]
    out = np.zeros(idx.shape + (b, b), blocks.dtype)
    nz = idx > 0
    out[nz] = blocks[idx[nz] - 1]
    return out


def shard_bsr(
    bsr: BSR, n_shards: int, boundaries=None, payload=None
) -> ShardedBSR:
    """Partition into `n_shards` contiguous block-row stripes, pad each
    stripe's block list to the max stripe nnzb. boundaries=None gives
    uniform stripes; an (n_shards+1,) array gives variable contiguous
    stripes (balanced_contiguous_boundaries), each padded to the max
    stripe height.

    payload: optional (nnzb, pb, pb) array to shard IN PLACE OF the
    block values (block_index_payload for the fast metadata-only plan
    path); the returned ShardedBSR.blocks then carries the payload and
    block_size still reports the true b for geometry."""
    b = bsr.b
    nbr = bsr.n_block_rows
    if boundaries is None:
        rows_per = _cdiv(nbr, n_shards)
        col_chunk = _cdiv(bsr.n_block_cols, n_shards)
    else:
        boundaries = np.asarray(boundaries, dtype=np.int64)
        assert boundaries.shape == (n_shards + 1,)
        rows_per = int(np.diff(boundaries).max())
        col_chunk = rows_per  # square padded chunks (halo-only layout)

    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    cols = np.asarray(bsr.block_cols[: bsr.nnzb])
    blocks = (
        np.asarray(bsr.blocks[: bsr.nnzb]) if payload is None
        else np.asarray(payload)
    )
    pb = blocks.shape[-1]  # payload block dim (== b unless index mode)

    if boundaries is None:
        owner = rows // rows_per
        base = None
    else:
        owner = np.searchsorted(boundaries, rows, side="right") - 1
        base = boundaries
    real_counts = np.bincount(owner, minlength=n_shards)

    # per-shard covering: every LOCAL block-row gets >= 1 block (zero
    # blocks for absent rows), as in the JAX package, so a local kernel
    # writes every output tile; stripes stay sorted by local row.
    shard_lists = []
    for s in range(n_shards):
        sel = owner == s
        s_base = s * rows_per if base is None else int(base[s])
        s_height = rows_per if base is None else int(base[s + 1] - base[s])
        slr = (rows[sel] - s_base).astype(np.int64)
        sbc = cols[sel].astype(np.int64)
        sbv = blocks[sel]
        # covering applies to the stripe's REAL height only; padded rows
        # above it never receive output reads
        present = np.zeros(max(s_height, 1), dtype=bool)
        present[slr] = True
        missing = np.nonzero(~present)[0]
        if missing.size:
            slr = np.concatenate([slr, missing])
            sbc = np.concatenate([sbc, np.zeros(missing.size, np.int64)])
            sbv = np.concatenate(
                [sbv, np.zeros((missing.size, pb, pb), sbv.dtype)]
            )
        order = np.argsort(slr, kind="stable")
        shard_lists.append((slr[order], sbc[order], sbv[order]))

    m = max(max(x[0].shape[0] for x in shard_lists), 1)
    lr = np.full((n_shards, m), rows_per - 1, dtype=np.int32)
    bc = np.zeros((n_shards, m), dtype=np.int32)
    bv = np.zeros((n_shards, m, pb, pb), dtype=np.asarray(blocks).dtype)
    for s, (slr, sbc, sbv) in enumerate(shard_lists):
        k = slr.shape[0]
        lr[s, :k] = slr
        bc[s, :k] = sbc
        bv[s, :k] = sbv
    return ShardedBSR(
        local_rows=lr,
        block_cols=bc,
        blocks=bv,
        shape=bsr.shape,
        block_size=b,
        rows_per_shard=rows_per,
        col_chunk=col_chunk,
        nnzb=bsr.nnzb,
        nnzb_per_shard=real_counts,
        boundaries=base,
    )


def bucket_by_col_chunk(sh: ShardedBSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-bucket each shard's blocks by which ring chunk their block-col
    falls in, for the ppermute-ring schedule (parallel/spmm.py).

    Returns (local_rows, chunk_cols, blocks) with shape
    (n_shards, n_chunks, mb, ...); chunk_cols are block-col ids LOCAL to
    the chunk. Padding entries are zero blocks at (last local row, col 0).
    """
    n, cpc, rows_per = sh.n_shards, sh.col_chunk, sh.rows_per_shard
    b = sh.blocks.shape[-1]  # payload dim (== sh.b unless index mode)
    chunk_of = np.asarray(sh.block_cols) // cpc  # (n, m)

    # count real blocks per (shard, chunk): padding entries in sh are zero
    # blocks, harmless to include in whatever bucket they land in (chunk 0).
    mb = 1
    per = np.zeros((n, n), dtype=np.int64)
    for s in range(n):
        per[s] = np.bincount(chunk_of[s], minlength=n)[:n]
    mb = max(int(per.max(initial=0)), 1)

    lr = np.full((n, n, mb), rows_per - 1, dtype=np.int32)
    cc = np.zeros((n, n, mb), dtype=np.int32)
    bv = np.zeros((n, n, mb, b, b), dtype=sh.blocks.dtype)
    for s in range(n):
        for c in range(n):
            sel = chunk_of[s] == c
            k = int(per[s, c])
            if k:
                rows_sc = sh.local_rows[s, sel]
                order = np.argsort(rows_sc, kind="stable")
                lr[s, c, :k] = rows_sc[order]
                cc[s, c, :k] = (sh.block_cols[s, sel] - c * cpc)[order]
                bv[s, c, :k] = sh.blocks[s, sel][order]
    return lr, cc, bv


def _bucket_walk(form, packed, n_block_rows, R, slots):
    """The port's extras of one bucket's packed layout (see
    pack_buckets_pallas): the pointer of the walk over the bucket's REAL
    steps (0 .. t-1; the cross-bucket padding steps t .. t_max-1 lie past
    it, so no kernel walks them), the lane-valid mask of the sorted form,
    and the CTA -> lane order with its deepest lane's slots."""
    if form == "sorted":
        lane_valid, steps_per_group = packed[5], packed[6]
        ptr = np.concatenate([[0], np.cumsum(steps_per_group)]).astype(np.int64)
        order, depth = lane_order(ptr, R, slots // R)
        return (lane_valid, ptr, order), depth
    if form == "rowgroup":
        step_groups, n_groups = packed[0], packed[3]
        ptr = group_pointer(step_groups, n_groups)
        order, depth = lane_order(ptr, R, slots // R)
        return (ptr, order), depth
    ptr = np.searchsorted(packed[0], np.arange(n_block_rows + 1)).astype(np.int64)
    order, depth = lane_order(ptr, 1, slots)
    return (ptr, order), depth


def pack_buckets_pallas(lr, cc, bv, n_block_rows, group="auto", deep=False,
                        rowgroup=0, sorted_geom=None):
    """Convert bucketed block lists into the kernels' grouped layouts.

    lr/cc/bv: (..., mb) / (..., mb) / (..., mb, b, b) bucketed block
    lists (the bucketers above; padding entries are zero blocks). Per
    bucket: zero blocks are stripped, every local block-row in
    [0, n_block_rows) is re-covered with one zero block (every output
    tile is reached), rows are re-sorted, and blocks are group-packed
    (_pack_groups, including its pad col fill). Buckets are then padded
    to one uniform step count T with steps that repeat the previous row
    and per-buffer cols and hold zero blocks, as the JAX package pads
    them (its shard_map traces one program for every device, so grid
    shapes must agree there; torch needs no such rule, and the padding is
    kept so that the arrays stay the JAX package's bit for bit). Zero
    slots then point at the same buffer's most recent real col
    (per_buffer_col_fill).

    Returns (step_rows (..., T), slot_cols (..., T*G),
    blocks (..., T*G, b, b), G, walk), the first four the JAX package's,
    and walk the port's extras, each stacked over the buckets (see
    _bucket_walk): (step_ptr (..., n_block_rows+1) int64, lane_order
    (..., n_block_rows) int32, depth (...,) int64) for the flat form,
    (group_ptr (..., n_groups+1), lane_order (..., n_groups*R), depth)
    for row groups, (lane_valid (..., n_groups*R) bool, group_ptr,
    lane_order, depth) for the sorted form. The pointers cover each
    bucket's real steps only, so the kernels never walk the padding
    steps and the lane order never counts them.

    deep=True selects the pow2 group rule (up to G=32), as the JAX plan
    does for int8 and for bf16 row groups; the default keeps the gather
    rule (G=8 cap).

    rowgroup=R (R > 0) packs each bucket in the consecutive ROW-GROUP
    layout instead (ops/bsr_spmm_pallas._pack_rowgroups: R covered
    block-rows share each step, slots split into R lanes of `group`
    each). step_rows then holds GROUP ids; every bucket covers the same
    n_block_rows, so n_groups = ceil(n_block_rows / R) uniformly, and the
    cross-bucket step padding repeats the last step's group id.

    sorted_geom=(R, gh, W) packs the DEPTH-SORTED row-group layout
    (ops/bsr_spmm_pallas._pack_rowgroups_sorted). The per-lane window
    positions ride CONCATENATED into the step array - step_rows becomes
    [win_ids (T,) | pos (T*R,)] per bucket, as in the JAX package;
    route_pallas_spmm splits it back. Cross-bucket padding repeats the
    last window id and the last step's positions (their slots are zero
    blocks).
    """
    lr, cc, bv = np.asarray(lr), np.asarray(cc), np.asarray(bv)
    lead = lr.shape[:-1]
    b = bv.shape[-1]
    lrf = lr.reshape(-1, lr.shape[-1])
    ccf = cc.reshape(-1, cc.shape[-1])
    bvf = bv.reshape(-1, bv.shape[-3], b, b)
    n_lists = lrf.shape[0]

    covered = []
    total_real = 0
    total_rows = 0
    for i in range(n_lists):
        nz = np.abs(bvf[i]).sum(axis=(-1, -2)) != 0
        rows_i = lrf[i, nz].astype(np.int64)
        cols_i = ccf[i, nz].astype(np.int64)
        blks_i = bvf[i, nz]
        total_real += int(rows_i.size)
        total_rows += int(np.unique(rows_i).size)
        present = np.zeros(n_block_rows, dtype=bool)
        present[rows_i] = True
        missing = np.nonzero(~present)[0]
        if missing.size:
            rows_i = np.concatenate([rows_i, missing])
            cols_i = np.concatenate([cols_i, np.zeros(missing.size, np.int64)])
            blks_i = np.concatenate(
                [blks_i, np.zeros((missing.size, b, b), bvf.dtype)]
            )
        order = np.argsort(rows_i, kind="stable")
        covered.append((rows_i[order], cols_i[order], blks_i[order]))

    if group == "auto":
        rule = _auto_group_pow2 if deep else _auto_group
        group = rule(total_real, max(total_rows, 1))
        if rowgroup:
            # the single-card plan's cap on the slots of a lane
            group = min(group, _ROWGROUP_GH_CAP)

    def stacked(walks, depths):
        parts = tuple(np.stack([w[k] for w in walks]).reshape(lead + walks[0][k].shape)
                      for k in range(len(walks[0])))
        return parts + (np.asarray(depths, np.int64).reshape(lead),)

    if sorted_geom is not None:
        R, gh, W = sorted_geom
        group = gh
        slots = R * gh
        packed_s = [
            _pack_rowgroups_sorted(r, c, v, gh, R, W)
            for r, c, v in covered
        ]
        t_max = max(p[0].shape[0] for p in packed_s)
        sr = np.zeros((n_lists, t_max * (1 + R)), np.int32)
        sc = np.zeros((n_lists, t_max * slots), np.int32)
        bp = np.zeros((n_lists, t_max * slots, b, b), bvf.dtype)
        walks, depths = [], []
        for i, packed in enumerate(packed_s):
            win, pos, c, v = packed[:4]
            t = win.shape[0]
            sr[i, :t] = win
            sr[i, t_max : t_max + t * R] = pos
            sc[i, : t * slots] = c
            bp[i, : t * slots] = v
            if t < t_max:
                sr[i, t:t_max] = win[-1]
                sr[i, t_max + t * R :] = np.tile(pos[-R:], t_max - t)
                sc[i, t * slots :] = np.tile(c[-slots:], t_max - t)
            c2 = sc[i].reshape(t_max, slots)
            real = (
                np.abs(bp[i]).sum(axis=(-1, -2)) != 0
            ).reshape(t_max, slots)
            sc[i] = per_buffer_col_fill(c2, real).reshape(-1)
            walk, depth = _bucket_walk("sorted", packed, n_block_rows, R, slots)
            walks.append(walk)
            depths.append(depth)
        return (
            sr.reshape(lead + (t_max * (1 + R),)),
            sc.reshape(lead + (t_max * slots,)),
            bp.reshape(lead + (t_max * slots, b, b)),
            group,
            stacked(walks, depths),
        )
    group = int(group)
    if rowgroup:
        packed = [
            _pack_rowgroups(r, c, v, group, rowgroup)
            for r, c, v in covered
        ]
    else:
        packed = [_pack_groups(r, c, v, group) for r, c, v in covered]
    slots = group * (rowgroup if rowgroup else 1)  # slots per step
    t_max = max(p[0].shape[0] for p in packed)
    sr = np.zeros((n_lists, t_max), np.int32)
    sc = np.zeros((n_lists, t_max * slots), np.int32)
    bp = np.zeros((n_lists, t_max * slots, b, b), bvf.dtype)
    walks, depths = [], []
    for i, p in enumerate(packed):
        r, c, v = p[:3]
        t = r.shape[0]
        sr[i, :t] = r
        sc[i, : t * slots] = c
        bp[i, : t * slots] = v
        if t < t_max:
            sr[i, t:] = r[-1]
            sc[i, t * slots :] = np.tile(c[-slots:], t_max - t)
        # zero-slot col fill, extended to COVERING blocks (not just
        # _pack_groups' group pads): any all-zero slot contributes
        # nothing regardless of its col, so it points at the same
        # buffer's most recent REAL col (the JAX package's fill, kept for
        # bit-equal arrays). Leading zero slots keep their col.
        c2 = sc[i].reshape(t_max, slots)
        real = (np.abs(bp[i]).sum(axis=(-1, -2)) != 0).reshape(t_max, slots)
        sc[i] = per_buffer_col_fill(c2, real).reshape(-1)
        walk, depth = _bucket_walk("rowgroup" if rowgroup else "flat", p,
                                   n_block_rows, rowgroup or 1, slots)
        walks.append(walk)
        depths.append(depth)
    return (
        sr.reshape(lead + (t_max,)),
        sc.reshape(lead + (t_max * slots,)),
        bp.reshape(lead + (t_max * slots, b, b)),
        group,
        stacked(walks, depths),
    )


def shard_stats(sh: ShardedBSR) -> dict:
    """Per-shard load-balance diagnostics (nnzb-weighted)."""
    per = np.asarray(sh.nnzb_per_shard)
    mean = float(per.mean())
    return {
        "nnzb_per_shard": per.tolist(),
        "imbalance": float(per.max() / mean) if mean else 1.0,
        "padded_m": int(sh.local_rows.shape[1]),
    }


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Stacked per-shard COO-view arrays for row-partitioned CSR SpMM.

    local_rows : (n_shards, m) int32 — row ids local to the stripe
    col_ids    : (n_shards, m) int32 — global column ids
    vals       : (n_shards, m) float32 (padding entries are 0.0)
    """

    local_rows: np.ndarray
    col_ids: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]
    rows_per_shard: int
    nnz: int

    @property
    def n_shards(self) -> int:
        return int(self.local_rows.shape[0])


def shard_csr(csr: CSR, n_shards: int) -> ShardedCSR:
    rows_per = _cdiv(csr.n_rows, n_shards)
    rows = csr.row_ids()
    cols = np.asarray(csr.indices)
    vals = csr.values()
    owner = rows // rows_per
    counts = np.bincount(owner, minlength=n_shards)
    m = max(int(counts.max(initial=0)), 1)
    lr = np.full((n_shards, m), rows_per - 1, dtype=np.int32)
    ci = np.zeros((n_shards, m), dtype=np.int32)
    va = np.zeros((n_shards, m), dtype=np.float32)
    for s in range(n_shards):
        sel = owner == s
        k = int(counts[s])
        if k:
            lr[s, :k] = rows[sel] - s * rows_per
            ci[s, :k] = cols[sel]
            va[s, :k] = vals[sel]
    return ShardedCSR(
        local_rows=lr,
        col_ids=ci,
        vals=va,
        shape=csr.shape,
        rows_per_shard=rows_per,
        nnz=csr.nnz,
    )


def bucket_halo(sh: ShardedBSR, halo: int = 1):
    """Bucket each shard's blocks by NEIGHBOR chunk offset in
    [-halo, +halo] (mod n_shards) for the halo-exchange schedule.

    Returns (local_rows, chunk_cols, blocks) with shape
    (n_shards, 2*halo+1, mb, ...) — offset index h corresponds to chunk
    (s + h - halo) mod n — or None if any block's column falls outside
    its shard's halo (caller falls back to allgather/ring)."""
    n, cpc, rows_per = sh.n_shards, sh.col_chunk, sh.rows_per_shard
    b = sh.blocks.shape[-1]  # payload dim (== sh.b unless index mode)
    width = 2 * halo + 1
    if width >= n:
        return None  # halo covers everything; use allgather
    if sh.boundaries is None:
        chunk_of = np.asarray(sh.block_cols) // cpc  # (n, m)
        col_local = np.asarray(sh.block_cols) % cpc
    else:
        # variable contiguous stripes: B chunk s covers block-cols
        # [boundaries[s], boundaries[s+1]) padded to rows_per (square
        # matrices only — the adjacency case halo serves)
        bounds = np.asarray(sh.boundaries)
        chunk_of = (
            np.searchsorted(bounds, np.asarray(sh.block_cols), side="right")
            - 1
        )
        col_local = np.asarray(sh.block_cols) - bounds[chunk_of]
    shard_ids = np.arange(n)[:, None]
    offset = (chunk_of - shard_ids + halo) % n  # (n, m) in [0, n)
    # padding entries are zero blocks at col 0 -> chunk 0; their offset
    # may be out of halo for far shards, but they are all-zero, so remap
    # them to the center slot instead of failing the halo check.
    pad_mask = np.abs(sh.blocks).sum(axis=(-1, -2)) == 0
    offset = np.where(pad_mask, halo, offset)
    col_local = np.where(pad_mask, 0, col_local)
    if (offset >= width).any():
        return None
    per = np.zeros((n, width), dtype=np.int64)
    for s in range(n):
        per[s] = np.bincount(offset[s], minlength=width)[:width]
    mb = max(int(per.max(initial=0)), 1)
    lr = np.full((n, width, mb), rows_per - 1, dtype=np.int32)
    cc = np.zeros((n, width, mb), dtype=np.int32)
    bv = np.zeros((n, width, mb, b, b), dtype=sh.blocks.dtype)
    for s in range(n):
        for h in range(width):
            sel = offset[s] == h
            k = int(per[s, h])
            if k:
                rows_sh = sh.local_rows[s, sel]
                order = np.argsort(rows_sh, kind="stable")
                lr[s, h, :k] = rows_sh[order]
                cc[s, h, :k] = col_local[s, sel][order]
                bv[s, h, :k] = sh.blocks[s, sel][order]
    return lr, cc, bv
