"""Distributed SpMM over a DeviceMesh (twin of
``spmm_denseblock_tpu/parallel/spmm.py``), SPMD over ``torch.distributed``.

Row/block-partition A across ranks, exchange the dense operand's rows
between them, and run each rank's local block products on its own
device. Every rank builds the same host layout (deterministic) and keeps
its own stripe; see ``parallel/exchange.py`` for the exchanges, the
stripes and ``RowStripe``. A plan's call returns the rank's row stripe
of C (``output_rows(plan)`` names its global rows); ``gather_output``
gathers the whole C in caller order.

Three strategies (each produces C = A @ B with A row-striped over `axis`):

  allgather - B is row-sharded; one all_gather materializes the full
      padded B per rank, then the local stripe of A multiplies it.
      Memory: O(K*F) per rank.

  ring - B stays sharded in n chunks; at step s each rank multiplies the
      blocks whose block-col lands in its currently-held chunk and passes
      the chunk to rank (r+1) mod n. The step's exchange is posted before
      the step's kernel, so the bytes move while the kernel runs; the f32
      accumulator adds each step's stripe output. Memory: O(K*F / n).

  halo - only the 2*halo neighbour chunks move (banded matrices).

Local per-stripe compute is ``local_impl="xla"``, the flat-BSR batched
product and segment sum in torch ops (index_select, bmm, index_add_;
XLA code in the JAX package), or ``"pallas"``, the port's CUDA kernels
through the stripe routers (``ops.bsr_spmm_pallas.route_pallas_spmm``,
``ops.bsr_spmm_pallas_int8.route_pallas_int8_spmm``); accumulation is
f32. The JAX package's TPU machinery is not carried over: the Pallas F
tiling, the VMEM fits of the layout gate (its occupancy thresholds stay),
the interpret flag and the SDB_* environment reads, which are arguments
here (depth_sort=, group_scale=).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    dtype_name,
    quantize_blocks,
    static_col_scale,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    _PLAIN_CHUNK_ELEMS,
    _depth_sort_policy,
    _rowgroup_policy,
    route_pallas_spmm,
    split_planes,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import (
    quantize_int8,
    route_pallas_int8_spmm,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, run, sum_plan
from spmm_denseblock_tpu_torch.parallel import exchange as exch
from spmm_denseblock_tpu_torch.parallel.exchange import (
    DistInfo,
    OperandSplit,
    rank_device,
)
from spmm_denseblock_tpu_torch.parallel.mesh import make_mesh_1d
from spmm_denseblock_tpu_torch.parallel.shard import (
    balanced_contiguous_boundaries,
    block_index_payload,
    bucket_by_col_chunk,
    bucket_halo,
    materialize_packed,
    pack_buckets_pallas,
    shard_bsr,
    shard_csr,
)

# int8 products run through f32 matmuls: exact while b * 127^2 < 2^24
_INT8_EXACT_B = (1 << 24) // (127 * 127)


def _f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) in f32, TF32 off for the call."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _local_bsr_spmm(local_rows, cols, blocks, b_blocked, n_seg, scales=None):
    """One stripe: gather B tiles, batched products, segment sum.

    b_blocked: (n_bc, b, F) blocked view of the dense operand. f32
    blocks run exact f32 products; bf16 ones bf16 x bf16 products (exact
    in f32) with f32 sums; int8 ones int8 x int8 products in f32 matmuls
    (exact while b * 127^2 < 2^24, b <= 1,040) rescaled by the per-block
    `scales` (the separable per-column operand scale is applied by the
    caller). Returns (n_seg, b, F) f32."""
    m, b = blocks.shape[0], blocks.shape[1]
    F = b_blocked.shape[2]
    int8 = blocks.dtype == torch.int8
    if int8:
        assert b <= _INT8_EXACT_B, f"int8 block size {b} > {_INT8_EXACT_B}"
    out = torch.zeros(n_seg, b, F, dtype=torch.float32, device=blocks.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * F))
    for s0 in range(0, m, step):
        s1 = min(m, s0 + step)
        gathered = b_blocked.index_select(0, cols[s0:s1])
        prod = _f32_bmm(blocks[s0:s1], gathered)
        if int8:
            prod = prod * scales[s0:s1, None, None]
        out.index_add_(0, local_rows[s0:s1], prod)
    return out


# ---------------------------------------------------------------------------
# Each distributed plan is a port Plan: the rank's stripe arrays are its
# buffers, on the rank's device, and its statics start with the DistInfo
# (where the rank's stripes lie). plan(x) takes the whole operand or a
# RowStripe; plain=True runs the stripe routers' plain versions.
# ---------------------------------------------------------------------------


def _column_scales(info: DistInfo, x: torch.Tensor, cs) -> torch.Tensor:
    """The int8 operand's per-column scales, the JAX package's bit for
    bit: static ones (cs, sliced to the rank's columns, pad columns at 1)
    or, from the stripes, the column absmax reduced (max) over the row
    group - only over it, since a column lives in one feature slice - and
    then absmax * f32(1/127), columns of zeros at 1."""
    fs = x.shape[1]
    if cs is not None:
        F = cs.shape[0]
        _, c0, c1 = info.feature_slice(F)
        out = torch.ones(fs, dtype=torch.float32, device=x.device)
        out[: c1 - c0] = cs[c0:c1]
        return out
    absmax = x.abs().amax(dim=0) if x.shape[0] else x.new_zeros(fs)
    absmax = exch.all_reduce_max(absmax.float(), info.group)
    return torch.where(absmax > 0, absmax * (1.0 / 127.0), torch.ones_like(absmax))


def _quantize_stripe(info: DistInfo, x: torch.Tensor, cs, plain: bool):
    """(q (chunk, fs) int8, col_scale (fs,)) of the rank's f32 stripe:
    one quantize_int8 launch on the card (its plain version on the CPU or
    with plain), with the global scales."""
    return quantize_int8(x, x.shape[0], _column_scales(info, x, cs), plain=plain)


def _dist_bsr_apply(statics, arrays, dense, plain: bool = False):
    info, strategy, st = statics
    x, F = info.operand_stripe(dense)
    col_scale = None
    if st["dtype"] == "int8":
        x, col_scale = _quantize_stripe(info, x.float(), st["cs"], plain)
    elif st["dtype"] is not None:
        x = x.to(getattr(torch, st["dtype"]))
    else:
        x = x.float()

    def local(bucket, operand):
        a = [arrays[i] for i in st["buckets"][bucket]]
        if st["local_impl"] == "pallas":
            walk = dict(st["walks"][bucket])
            if isinstance(st["rg"], tuple):
                walk["lane_valid"] = a[4]
                walk["ptr"], walk["lane_order"] = a[5], a[6]
            else:
                walk["ptr"], walk["lane_order"] = a[4], a[5]
            if col_scale is not None:
                return route_pallas_int8_spmm(
                    a[0], a[1], a[2], a[3], operand, col_scale, st["rows_per"],
                    st["rows_per"] * st["b"], walk, st["group"], st["rg"], plain)
            return route_pallas_spmm(
                a[0], a[1], a[2], operand, st["rows_per"], st["rows_per"] * st["b"],
                walk, st["group"], st["precision"], st["rg"], plain)
        lr, cols, blocks = a[:3]
        out = _local_bsr_spmm(lr, cols, blocks,
                              operand.reshape(-1, st["b"], operand.shape[1]),
                              st["rows_per"], a[3] if col_scale is not None else None)
        return out.reshape(st["rows_per"] * st["b"], operand.shape[1])

    if strategy == "allgather":
        out = local(0, exch.all_gather_rows(x, info.group))
    elif strategy == "ring":
        n, me = info.n, info.me
        chunk, out = x, None
        for s in range(n):
            c = (me - s) % n  # chunk currently held
            # post this step's exchange before its kernel: the chunk's
            # bytes move to rank me+1 while the kernel reads them
            nxt = exch.shift(chunk, info.group, 1, tag=s) if s < n - 1 else None
            part = local(c, chunk)
            out = part if out is None else out + part
            if nxt is not None:
                chunk = nxt.wait()
    else:  # halo: offset off brings chunk (me + off) mod n
        halo = st["halo"]
        pending = {off: exch.shift(x, info.group, -off, tag=off + halo)
                   for off in range(-halo, halo + 1) if off}
        out = local(halo, x)
        for off, h in pending.items():
            out = out + local(off + halo, h.wait())
    if col_scale is not None and st["local_impl"] != "pallas":
        out = out * col_scale[None, :]
    return info.output(out, F)


def _lpt_apply(statics, plans, dense, plain: bool = False):
    """LPT balance: the inner plan on the permuted matrix; of its stripe,
    the rows that hold rows of A, in the inner order. The stripe names
    their global rows (output_rows), and gather_output puts them in
    caller order, so the JAX plan's undo gather moves no row here."""
    (inner,) = plans
    return statics[0].rows(run(inner, dense, plain))


def strategy_of(plan) -> str:
    """The strategy a distributed BSR plan runs ("allgather", "ring" or
    "halo"), after "lpt " for an LPT-balanced one."""
    if plan.statics[1] == "lpt":
        return "lpt " + strategy_of(plan.subplans[0])
    return plan.statics[1]


def layout_tag(plan):
    """The layout tag of a distributed BSR plan's stripes (the last
    static of the JAX plan's inner tuple): ("sorted", R, gh, W),
    ("sorted_gs", R, gh, W), a row-group R, or 0 (flat)."""
    return plan.statics[2]["rg"]


def _resolve_mesh(mesh):
    return make_mesh_1d() if mesh is None else mesh


def _contiguous_rows(lo, hi, n_rows: int):
    """out_rows of contiguous stripes: rows [lo[s], hi[s]) of C."""
    return tuple(np.arange(min(a, n_rows), min(z, n_rows), dtype=np.int64)
                 for a, z in zip(lo, hi))


def balanced_block_row_permutation(bsr: BSR, n_shards: int) -> "np.ndarray":
    """LPT (longest-processing-time) assignment of block-rows to stripes:
    returns old2new over BLOCK-ROW ids such that contiguous equal-size
    stripes of the permuted matrix have near-equal nnzb. The distributed
    answer to per-shard nnz imbalance on community-reordered graphs.
    """
    nbr = bsr.n_block_rows
    rows_per = -(-nbr // n_shards)
    counts = np.bincount(
        np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
    ).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    fill = np.zeros(n_shards, dtype=np.int64)
    assign = np.empty(nbr, dtype=np.int64)
    for r in order:
        open_shards = np.nonzero(fill < rows_per)[0]
        s = open_shards[np.argmin(load[open_shards])]
        assign[r] = s * rows_per + fill[s]
        fill[s] += 1
        load[s] += counts[r]
    return assign


def _stripe_loads_imbalance(bsr: BSR, n_dev: int) -> float:
    """max / mean of the contiguous uniform stripes' real block counts."""
    nbr = bsr.n_block_rows
    counts = np.bincount(
        np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
    ).astype(np.int64)
    rows_per0 = -(-nbr // n_dev)
    pad = n_dev * rows_per0 - nbr
    loads = np.pad(counts, (0, pad)).reshape(n_dev, rows_per0).sum(1)
    return loads.max() / max(loads.mean(), 1e-9)


def _balance(bsr: BSR, n_dev: int, strategy: str, halo: int, balance, payload):
    """The JAX plan's balancing decision: (strategy, the contiguous
    equal-load sharding or None, whether LPT permutes the block-rows)."""
    sh_bal = None
    if (
        balance
        and strategy in ("auto", "halo")
        and bsr.shape[0] == bsr.shape[1]
    ):
        # contiguous equal-load stripes FIRST: unlike LPT (which
        # scatters block-rows and destroys bandedness), prefix-sum
        # boundaries keep row order, so an imbalanced BANDED graph gets
        # both load balance and halo's O(1) comms
        if balance == "contiguous" or _stripe_loads_imbalance(bsr, n_dev) > 1.25:
            cand = balanced_contiguous_boundaries(bsr, n_dev)
            sh_c = shard_bsr(bsr, n_dev, boundaries=cand, payload=payload)
            if bucket_halo(sh_c, halo) is not None:
                sh_bal, strategy = sh_c, "halo"
    lpt = False
    if balance and strategy != "halo":
        halo_eligible = (
            strategy in ("auto",)
            and bucket_halo(shard_bsr(bsr, n_dev, payload=payload), halo)
            is not None
        )
        lpt = balance is True or (_stripe_loads_imbalance(bsr, n_dev) > 1.25
                                  and not halo_eligible)
    return strategy, sh_bal, lpt


def _route(bsr: BSR, n_dev: int, strategy: str, halo: int, balance, payload):
    """The JAX plan's choice of strategy and stripes, from the host
    layout alone: (strategy, sharding, halo buckets, lpt). With lpt the
    block-rows are LPT-permuted first (_lpt_permuted) and strategy goes
    to the plan of the permuted matrix unresolved. Else strategy is
    "allgather", "ring" or "halo" (its buckets given): strategy="auto"
    resolved, and halo's fallback to allgather taken as the JAX plan's
    recursive call takes it (balance and halo at their defaults)."""
    strategy, sh_bal, lpt = _balance(bsr, n_dev, strategy, halo, balance, payload)
    if lpt:
        return strategy, None, None, True
    sh = sh_bal if sh_bal is not None else shard_bsr(bsr, n_dev, payload=payload)
    buckets = bucket_halo(sh, halo) if strategy in ("auto", "halo") else None
    if strategy == "auto":
        # halo when the (reordered) matrix is banded enough for O(1)
        # neighbor exchange; else the one-collective allgather
        strategy = "halo" if buckets is not None else "allgather"
    if strategy == "halo" and buckets is None:
        # not banded within the requested halo
        return _route(bsr, n_dev, "allgather", 1, "auto", payload)
    return strategy, sh, buckets, False


def _lpt_permuted(bsr: BSR, n_dev: int, values):
    """(perm, the LPT-permuted BSR with these block values). LPT assigns
    into n_dev stripes of ceil(nbr / n_dev) slots each - the permuted
    grid must cover ALL slots (perm values reach the last one when nbr
    doesn't divide the mesh)."""
    perm = balanced_block_row_permutation(bsr, n_dev)
    nbr_pad = n_dev * -(-bsr.n_block_rows // n_dev)
    permuted = BSR.from_parts(
        perm[np.asarray(bsr.block_rows[: bsr.nnzb])].astype(np.int32),
        np.asarray(bsr.block_cols[: bsr.nnzb]), values,
        (nbr_pad * bsr.b, bsr.shape[1]), bsr.b)
    return perm, permuted


def plan_strategy(bsr: BSR, n_ranks: int, strategy: str = "auto", halo: int = 1,
                  balance="auto") -> str:
    """The strategy dist_bsr_spmm_plan takes for these arguments over
    n_ranks row ranks, from the host layout alone (no plan is built):
    "allgather", "ring", "halo" (with balance's contiguous boundaries
    when they were needed), each after "lpt " when LPT balancing
    permutes the block-rows."""
    payload = block_index_payload(bsr.nnzb)
    strategy, sh, _, lpt = _route(bsr, n_ranks, strategy, halo, balance, payload)
    if lpt:
        _, permuted = _lpt_permuted(bsr, n_ranks, payload)
        return "lpt " + plan_strategy(permuted, n_ranks, strategy, halo, False)
    return strategy + (" (contiguous boundaries)" if sh.boundaries is not None else "")


def _plan_dtype_key(dtype) -> Optional[str]:
    return None if dtype is None else dtype_name(dtype)


def dist_bsr_spmm_plan(
    bsr: BSR,
    mesh=None,
    axis: str = "row",
    strategy: str = "allgather",
    dtype=None,
    feature_axis: Optional[str] = None,
    local_impl: str = "xla",
    halo: int = 1,
    balance="auto",
    calibration=None,
    group="auto",
    precision=None,
    depth_sort: Optional[bool] = None,
    group_scale: bool = True,
    device=None,
) -> Plan:
    """Host shard prep once -> a Plan computing this rank's stripe of
    C = A @ B over the mesh (every rank calls it with the same arguments).

    local_impl: per-stripe compute - "xla" (batched product + segment
    sum, torch ops) or "pallas" (the port's CUDA kernels through the
    stripe routers, every strategy). For ring/halo each chunk/offset
    bucket gets its own covered + group-packed layout
    (pack_buckets_pallas) and the per-step kernel outputs accumulate in
    f32. group ("auto" or int) and precision ("high" = bf16x3, K3;
    "default" = one bf16 pass, bf16 K1 on flat stripes) are the
    single-card plan's knobs and apply to the pallas path only, as do
    depth_sort (None or True: the occupancy gate; False: consecutive row
    groups, the JAX package's SDB_DEPTH_SORT=0) and group_scale (the
    int8 depth-sorted layout's one scale a lane-step; False is
    SDB_INT8_GROUP_SCALE=0).

    dtype=int8 (inference only): blocks quantized per block at plan
    time, the operand quantized with per-column symmetric scales, global
    over the row group (calibration= fixes them at plan time; else each
    call reduces the stripes' column absmax with one all_reduce), and
    every exchange (all_gather / ring / halo) moves int8 - 4x fewer bytes
    than f32.

    The call takes the whole operand on every rank, or the rank's own
    stripe as a RowStripe; it returns the rank's stripe of C
    (output_rows). With feature_axis set (2D mesh), B's feature dim is
    also split over that axis: every exchange stays within its own mesh
    axis.

    balance: LPT block-row balancing (balanced_block_row_permutation):
    the permuted matrix is sharded, and each stripe names the global rows
    it holds. "auto" (default) fires when the contiguous partition's
    stripe loads are >1.25x imbalanced AND the matrix is not
    halo-eligible; True forces it, False disables it. Before it, with
    strategy "auto" or "halo", contiguous stripes at equal loads
    (balanced_contiguous_boundaries) are tried, which keep a banded
    matrix halo-eligible.

    device: the rank's device; None is cuda:{rank % GPUs} (RuntimeError
    without a GPU), "cpu" for CPU ranks.
    """
    mesh = _resolve_mesh(mesh)
    device = rank_device(device)
    if local_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown local_impl {local_impl!r}; use 'xla' or 'pallas'")

    # Metadata-only shard/bucket/pack: every layout stage runs on an
    # 8-byte index payload instead of the (nnzb, b, b) value array, and
    # the values of the rank's own stripe are gathered once into its
    # final packed layout (shard.block_index_payload).
    _payload = block_index_payload(bsr.nnzb)
    _blocks_src = np.asarray(bsr.blocks[: bsr.nnzb])
    n_dev = int(mesh.size(mesh.mesh_dim_names.index(axis)))

    strategy, sh, halo_buckets, lpt = _route(bsr, n_dev, strategy, halo, balance,
                                             _payload)
    if lpt:
        b = bsr.b
        perm, permuted = _lpt_permuted(bsr, n_dev, _blocks_src)
        nbr_pad = permuted.n_block_rows
        inner = dist_bsr_spmm_plan(
            permuted, mesh=mesh, axis=axis, strategy=strategy,
            dtype=dtype, feature_axis=feature_axis,
            local_impl=local_impl, halo=halo, balance=False,
            calibration=calibration, group=group, precision=precision,
            depth_sort=depth_sort, group_scale=group_scale, device=device,
        )
        # each permuted row's global row (JAX's undo gather, read the
        # other way): the inner stripe's rows that hold rows of A
        rows = np.arange(bsr.shape[0], dtype=np.int64)
        q = perm[rows // b] * b + rows % b  # permuted row of each row
        glob = np.full(nbr_pad * b, -1, np.int64)
        glob[q] = rows
        info_in = exch.dist_info(inner)
        out_rows, out_pos = [], []
        for s in range(info_in.n):
            g = glob[info_in.out_rows[s]]
            keep = np.nonzero(g >= 0)[0]
            out_rows.append(g[keep])
            out_pos.append(keep)
        info = DistInfo(mesh, axis, feature_axis, bsr.shape[0], bsr.shape[1],
                        info_in.split, tuple(out_rows), tuple(out_pos), device)
        return Plan((inner,), _lpt_apply, (info, "lpt", {"rg": layout_tag(inner)}))
    n = n_dev
    b = bsr.b
    rows_per, cpc = sh.rows_per_shard, sh.col_chunk
    k_padded = n * cpc * b
    n_rows, n_cols = bsr.shape

    dtype_key = _plan_dtype_key(dtype)
    int8_mode = dtype_key == "int8"
    if precision is not None and (local_impl != "pallas" or int8_mode):
        raise ValueError(
            "precision= applies to float local_impl='pallas' plans only"
        )
    if calibration is not None and not int8_mode:
        raise ValueError(
            "calibration= only applies to dtype=int8 serving plans; "
            f"got dtype={dtype_key!r}"
        )
    if strategy not in ("allgather", "ring", "halo"):
        raise ValueError(
            f"unknown strategy {strategy!r}; use 'allgather', 'ring', or 'halo'"
        )
    cs = None
    if int8_mode and calibration is not None:
        cs = torch.as_tensor(static_col_scale(calibration), device=device)

    def rowgroup_R():
        """The local stripes' layout, the JAX gate without its VMEM fits:
        ("sorted", R, gh, W) (int8: "sorted_gs" with group scales), a
        plain R (consecutive row groups) or 0 (the flat layout)."""
        if local_impl != "pallas":
            return 0
        if precision not in (None, "high"):
            return 0
        deep_ok = depth_sort is not False
        wide = dtype_key not in ("int8", "bfloat16")  # f32 / bf16x3
        if wide or precision == "high":
            # 4-byte local operands: sorted only, and only at deep
            # occupancy
            if not deep_ok or bsr.nnzb / max(bsr.n_block_rows, 1) < 8.0:
                return 0
            R, gh, W = _depth_sort_policy(4, group)
            return ("sorted", R, gh, W)
        if precision is not None:
            return 0
        itemsize = 1 if int8_mode else 2
        # occupancy gate shared with the single-card plans: sorted at
        # >= 2 (bf16) / 8 (int8) real blocks per block-row
        avg_real = bsr.nnzb / max(bsr.n_block_rows, 1)
        occ_ok = avg_real >= (8.0 if int8_mode else 2.0)
        if occ_ok and deep_ok:
            R, gh, W = _depth_sort_policy(itemsize, group)
            tag = "sorted_gs" if int8_mode and group_scale else "sorted"
            return (tag, R, gh, W)
        R, gh = _rowgroup_policy(itemsize, group)
        return R

    rg = rowgroup_R()
    if strategy == "allgather":
        lr_h, bc_h, bv_h = (sh.local_rows[:, None], sh.block_cols[:, None],
                            sh.blocks[:, None])
    elif strategy == "ring":
        lr_h, bc_h, bv_h = bucket_by_col_chunk(sh)  # (n, n, mb, ...)
    else:
        # true halo exchange: each stripe receives only its 2*halo
        # neighbour chunks of B (_route took the allgather fallback
        # where a block's column falls outside its stripe's halo)
        lr_h, bc_h, bv_h = halo_buckets  # (n, 2h+1, mb, ...)

    grp, walks = 1, None  # the xla path ignores the group
    if local_impl == "pallas":
        kw = ({"rowgroup": 0, "sorted_geom": rg[1:]} if isinstance(rg, tuple)
              else {"rowgroup": rg})
        # deep pow2 groups: always for int8; for bf16 only when the
        # row-group layout is active, as the JAX plan packs them
        lr_h, bc_h, bv_h, grp, walks = pack_buckets_pallas(
            lr_h, bc_h, bv_h, rows_per, group=group,
            deep=(int8_mode or (dtype_key == "bfloat16" and bool(rg))), **kw,
        )

    me = mesh.get_local_rank(axis)
    arrays, buckets, bucket_walks = [], [], []

    def put(a) -> int:
        arrays.append(torch.as_tensor(a, device=device))
        return len(arrays) - 1

    R = rg[1] if isinstance(rg, tuple) else (rg or 1)  # lanes a step
    slots = grp * R
    for k in range(lr_h.shape[1]):
        idx = np.asarray(bv_h[me, k])[..., 0, 0]
        ids = []
        if local_impl == "pallas":
            depth = int(walks[-1][me, k])
            # the bucket's real steps: its pointer's last entry
            t = int(walks[1 if isinstance(rg, tuple) else 0][me, k][-1])
            if isinstance(rg, tuple):
                srow = np.concatenate([lr_h[me, k][:t],
                                       lr_h[me, k][lr_h.shape[-1] // (1 + R):][:t * R]])
            else:
                srow = lr_h[me, k][:t]
            ids.append(put(srow))
            ids.append(put(bc_h[me, k][: t * slots]))
            idx = idx[: t * slots]
            ids += [put(a) for a in _bucket_blocks(idx, _blocks_src, b, dtype_key,
                                                   precision, rg, R, grp, t, device)]
            ids += [put(w[me, k]) for w in walks[:-1]]
            bucket_walks.append({"depth": depth})
        else:
            ids.append(put(np.asarray(lr_h[me, k]).astype(np.int64)))
            ids.append(put(np.asarray(bc_h[me, k]).astype(np.int64)))
            ids += [put(a) for a in _bucket_blocks(idx, _blocks_src, b, dtype_key,
                                                   None, 0, 1, 1, None, device)]
        buckets.append(tuple(ids))

    if sh.boundaries is not None:
        # variable contiguous stripes: B's stripe s is rows bounds[s]*b ..
        # bounds[s+1]*b - 1, padded to rows_per*b (the JAX plan's padded
        # stripe view), and so is C's
        bnd = np.asarray(sh.boundaries) * b
        split = OperandSplit.bounded(sh.boundaries, b, rows_per * b, n_cols)
        out_rows = _contiguous_rows(bnd[:-1], bnd[1:], n_rows)
    else:
        split = OperandSplit.uniform(n, cpc * b, n_cols)
        out_rows = _contiguous_rows([s * rows_per * b for s in range(n)],
                                    [(s + 1) * rows_per * b for s in range(n)],
                                    n_rows)
    info = DistInfo(mesh, axis, feature_axis, n_rows, n_cols, split, out_rows,
                    None, device)
    st = {"dtype": dtype_key, "cs": cs, "local_impl": local_impl, "rg": rg,
          "rows_per": rows_per, "b": b, "group": grp, "precision": precision,
          "buckets": tuple(buckets), "walks": tuple(bucket_walks), "halo": halo,
          "k_padded": k_padded}
    return Plan(arrays, _dist_bsr_apply, (info, strategy, st))


def _bucket_blocks(idx, blocks_src, b, dtype_key, precision, rg, R, gh, t, device):
    """The device blocks (and, for int8, scales) of one packed bucket
    from its index payload (0: a zero block). Quantization and casts are
    per block and per value, so the bucket's own source blocks are
    quantized or cast (the JAX plan does the whole list first: the same
    values): int8 per block (quantize_blocks), per-slot scales, or, with
    the depth-sorted group-scale layout, each lane-step of the
    materialized f32 values to one scale; bf16 rounded to nearest even;
    "high" on f32 holds the bf16 planes (split_planes, on the device),
    "default" on f32 the blocks rounded to bf16 (one bf16 pass)."""
    nz = idx > 0
    sel = idx[nz] - 1
    if dtype_key == "int8":
        if isinstance(rg, tuple) and rg[0] == "sorted_gs":
            bv_f32 = np.zeros(idx.shape + (b, b), np.float32)
            bv_f32[nz] = blocks_src[sel]
            lanes = bv_f32.reshape(t, R, gh, b, b)
            lane_absmax = np.abs(lanes).max(axis=(-3, -2, -1))
            ls = np.where(
                lane_absmax > 0, lane_absmax / 127.0, 1.0
            ).astype(np.float32)
            qf = lanes * (np.float32(1.0) / ls)[..., None, None, None]
            np.rint(qf, out=qf)
            np.clip(qf, -127, 127, out=qf)
            return qf.reshape(idx.shape + (b, b)).astype(np.int8), ls.reshape(-1)
        q = np.zeros(idx.shape + (b, b), np.int8)
        s = np.ones(idx.shape, np.float32)
        q[nz], s[nz] = quantize_blocks(np.asarray(blocks_src[sel], np.float32))
        return q, s
    if dtype_key == "bfloat16":
        out = torch.zeros(idx.shape + (b, b), dtype=torch.bfloat16)
        out[torch.as_tensor(np.nonzero(nz)[0])] = torch.as_tensor(
            blocks_src[sel]).to(torch.bfloat16)
        return out, np.zeros((1,), np.float32)
    bv = materialize_packed(idx[..., None, None], blocks_src)
    if dtype_key in (None, "float32") and precision == "high":
        return (split_planes(torch.as_tensor(bv, device=device)),
                np.zeros((1,), np.float32))
    if dtype_key in (None, "float32") and precision == "default":
        return (torch.as_tensor(bv, device=device).to(torch.bfloat16),
                np.zeros((1,), np.float32))
    return bv.astype(np.float32, copy=False), np.zeros((1,), np.float32)


def _ell_layout_stripes(csr: CSR, n_shards: int, compact: str = "off",
                        compact_slots: int = None, itemsize: int = 4,
                        feat_dim: int = 128, stripe_rows=None):
    """Cross-stripe-uniform degree-bucketed ELL layouts, the JAX
    package's bit for bit.

    Its shard_map traces ONE program for every device, so per-stripe
    layouts must agree statically there: each degree class K is padded to
    its maximum row count over all stripes (capacity), and every stripe
    carries the same (slots,) index buffer with pad slots pointing at
    column n_cols (a zero row of the padded operand). The port keeps the
    uniform layout so that the arrays stay the JAX package's.

    Returns (idx, vals, positions, layout, has_vals, uniq): idx/vals are
    (n_shards, slots); positions (n_shards, rows_per) maps each local row
    to its row in the class-concatenated output; layout is the shared
    tuple of (m, K, u) chunks (the single-card tier's CHUNK_SLOTS split,
    ops/csr_spmm_ell.py). u > 0 marks a chunk the two-level compaction
    chose (compact="auto"/"force", the single-card tier's byte-rate
    model): that chunk's idx slots hold LOCAL positions into its uniq
    row-slice, `uniq` is the (n_shards, sum_u) concatenation of per-chunk
    unique column ids, padded per stripe to the cross-stripe max with the
    zero-row id n_cols.

    stripe_rows: None for the JAX package's contiguous stripes of
    ceil(n_rows / n_shards) rows; else a sequence of n_shards arrays of
    global row ids, stripe s's rows in order (a distributed sum's second
    part takes its first part's rows this way), each stripe padded with
    rows of no nonzeros to the longest."""
    from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import CHUNK_SLOTS, _row_widths
    from spmm_denseblock_tpu_torch.reorder.simple import _ragged_arange

    n_rows, n_cols = csr.shape
    indptr = np.asarray(csr.indptr, np.int64)
    deg_all = np.diff(indptr)
    if stripe_rows is None:
        rows_per = -(-n_rows // n_shards)
        grow = np.arange(n_shards * rows_per, dtype=np.int64).reshape(n_shards, rows_per)
        grow[grow >= n_rows] = -1
    else:
        rows_per = max(max(len(r) for r in stripe_rows), 1)
        grow = np.full((n_shards, rows_per), -1, np.int64)
        for s, r in enumerate(stripe_rows):
            grow[s, : len(r)] = r
    real = grow >= 0
    deg_r = np.where(real, deg_all[np.maximum(grow, 0)], 0)
    start_r = np.where(real, indptr[:-1][np.maximum(grow, 0)], 0)
    cols = np.asarray(csr.indices, np.int64)
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, np.float32) if has_vals else None

    # quarter-step classes (see ops/csr_spmm_ell._row_widths)
    K_r = _row_widths(deg_r.reshape(-1), "quarter").reshape(n_shards, rows_per)
    Ks = np.unique(K_r)
    counts = np.stack([(K_r == K).sum(axis=1) for K in Ks], axis=1)
    caps = counts.max(axis=0)  # class capacity = max count over stripes

    slot_off = np.concatenate([[0], np.cumsum(caps * Ks)])
    cat_off = np.concatenate([[0], np.cumsum(caps)])
    slots = int(slot_off[-1])

    idx = np.full((n_shards, slots), n_cols, dtype=np.int32)
    val = np.zeros((n_shards, slots), np.float32) if has_vals else None
    pos = np.zeros((n_shards, rows_per), np.int32)
    for s in range(n_shards):
        for j, K in enumerate(Ks):
            loc = np.nonzero(K_r[s] == K)[0]
            if loc.size == 0:
                continue
            d = deg_r[s, loc]
            base = slot_off[j] + np.arange(loc.size, dtype=np.int64) * K
            tgt = np.repeat(base, d) + _ragged_arange(d)
            src = np.repeat(start_r[s, loc], d) + _ragged_arange(d)
            idx[s, tgt] = cols[src]
            if has_vals:
                val[s, tgt] = vals[src]
            pos[s, loc] = cat_off[j] + np.arange(loc.size, dtype=np.int64)

    if compact not in ("off", "auto", "force"):
        raise ValueError(f"unknown compact mode: {compact!r}")
    from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (
        COMPACT_SLOTS,
        _COMPACT_MIN_GAIN,
        _gather_ns_per_slot,
    )

    span = CHUNK_SLOTS
    if compact != "off":
        span = min(CHUNK_SLOTS, compact_slots or COMPACT_SLOTS)
    layout = []
    for j, K in enumerate(Ks):
        max_m = max(1, span // int(K))
        m_k = int(caps[j])
        for t in range(0, m_k, max_m):
            layout.append((int(min(max_m, m_k - t)), int(K)))

    if compact == "off":
        layout = tuple((m, K, 0) for m, K in layout)
        return idx, val, pos, layout, has_vals, np.zeros((n_shards, 1),
                                                         np.int32)

    from spmm_denseblock_tpu_torch import native

    # every stripe gathers from the all-gathered FULL table, so the
    # big/small rate brackets are exactly the single-card ones
    r_big = _gather_ns_per_slot((n_cols + 1) * feat_dim * itemsize, itemsize)
    n_vals = n_cols + 1  # pad slots hold n_cols (the zero row)
    out_layout, uniq_parts = [], []
    off = 0
    for m, K in layout:
        S = m * K
        us, invs = [], []
        for sh in range(n_shards):
            seg = idx[sh, off: off + S]
            res = native.unique_inverse(seg, n_vals)
            u, inv = res if res is not None else np.unique(
                seg, return_inverse=True
            )
            us.append(u)
            invs.append(inv)
        u_cap = max(u.size for u in us)
        r_sub = _gather_ns_per_slot(u_cap * feat_dim * itemsize, itemsize)
        win = u_cap * r_big + S * r_sub <= _COMPACT_MIN_GAIN * S * r_big
        if compact == "force" or win:
            arr = np.full((n_shards, u_cap), n_cols, np.int32)
            for sh in range(n_shards):
                arr[sh, : us[sh].size] = us[sh]
                idx[sh, off: off + S] = invs[sh].astype(np.int32)
            uniq_parts.append(arr)
            out_layout.append((m, K, int(u_cap)))
        else:
            out_layout.append((m, K, 0))
        off += S
    uniq = (
        np.concatenate(uniq_parts, axis=1)
        if uniq_parts
        else np.zeros((n_shards, 1), np.int32)
    )
    return idx, val, pos, tuple(out_layout), has_vals, uniq


def _gathered_operand(info: DistInfo, dense, st, plain: bool):
    """(the full padded operand on every rank, this rank's int8 column
    scales or None, F): the rank's stripe cast to the plan's dtype (int8:
    quantized with the global scales) and all-gathered over the row
    group, so bf16 halves and int8 quarters the exchanged bytes. At least
    `need` rows (zero rows appended where the split holds fewer)."""
    x, F = info.operand_stripe(dense)
    col_scale = None
    if st["dtype"] == "int8":
        x, col_scale = _quantize_stripe(info, x.float(), st["cs"], plain)
    elif st["dtype"] == "keep":  # SDDMM: the operands' own dtype
        pass
    elif st["dtype"] is not None:
        x = x.to(getattr(torch, st["dtype"]))
    else:
        x = x.float()
    full = exch.all_gather_rows(x, info.group)
    if full.shape[0] < st["need"]:
        full = torch.nn.functional.pad(full, (0, 0, 0, st["need"] - full.shape[0]))
    return full, col_scale, F


def _dist_ell_apply(statics, arrays, dense, plain: bool = False):
    info, st = statics
    idx, val, pos, uniq = arrays
    b_full, col_scale, F = _gathered_operand(info, dense, st, plain)
    outs = []
    off = uoff = 0
    for m, K, u in st["layout"]:
        if u:
            # two-level: one big-table gather of the chunk's unique rows,
            # then the slot gather reads the compact sub-table
            src = b_full.index_select(0, uniq[uoff:uoff + u])
            uoff += u
        else:
            src = b_full
        g = src.index_select(0, idx[off:off + m * K])
        if g.dtype == torch.int8:
            # int8 pays in the all_gather and the row gathers; widen for
            # the value multiply and the sum
            g = g.float()
        if st["has_vals"]:
            # bf16 tables: the values rounded to bf16 and the products to
            # bf16 (the JAX plan's answer), summed in f32
            g = g * val[off:off + m * K, None].to(g.dtype)
        outs.append(g.reshape(m, K, -1).sum(1, dtype=torch.float32))
        off += m * K
    cat = torch.cat(outs) if len(outs) > 1 else outs[0]
    out = cat.index_select(0, pos)
    if col_scale is not None:
        out = out * col_scale[None, :]
    return info.output(out, F)


def _dist_segment_apply(statics, arrays, dense, plain: bool = False):
    info, st = statics
    lr, ci, va = arrays
    b_full, _, F = _gathered_operand(info, dense, st, plain)
    gathered = b_full.index_select(0, ci) * va[:, None]
    out = torch.zeros(st["rows_per"], b_full.shape[1], dtype=torch.float32,
                      device=b_full.device)
    out.index_add_(0, lr, gathered)
    return info.output(out, F)


def _calibrated(calibration, dtype_key, device):
    if calibration is None:
        return None
    if dtype_key != "int8":
        raise ValueError(
            "calibration= only applies to dtype=int8 serving plans; "
            f"got dtype={dtype_key!r}"
        )
    return torch.as_tensor(static_col_scale(calibration), device=device)


def _csr_split(n: int, rows_per: int, n_rows: int, n_cols: int, chunk: int,
               stripe_rows=None, split=None):
    out_rows = (tuple(np.asarray(r, np.int64) for r in stripe_rows)
                if stripe_rows is not None else
                _contiguous_rows([s * rows_per for s in range(n)],
                                 [(s + 1) * rows_per for s in range(n)], n_rows))
    return (split if split is not None
            else OperandSplit.uniform(n, chunk, n_cols)), out_rows


def dist_csr_spmm_ell_plan(
    csr: CSR, mesh=None, axis: str = "row", dtype=None,
    calibration=None, compact: str = "off", compact_slots: int = None,
    feat_dim: int = 128, device=None, stripe_rows=None, split=None,
) -> Plan:
    """Row-partitioned ELL SpMM: the scatter-free degree-bucketed tier
    distributed over the mesh's row axis. B is cast to `dtype` BEFORE
    the all_gather, so bf16 serving also halves the exchanged bytes - and
    dtype=int8 (inference only) quarters them vs f32: the operand is
    quantized with per-column symmetric scales, global over the row group
    (calibration= for static serving scales, else one absmax all_reduce
    per call), and both the all_gather and the row gathers move int8.
    compact="auto"/"force": per-stripe-chunk two-level gathers - every
    stripe reads the all-gathered FULL table, so the single-card
    compaction model applies verbatim (see ops/csr_spmm_ell). device as
    for dist_bsr_spmm_plan. stripe_rows and split (an OperandSplit) give
    the stripes of C and of B another plan uses, so that two plans'
    stripes add (dist_hybrid_spmm_plan, dist_windowed_spmm_plan)."""
    mesh = _resolve_mesh(mesh)
    device = rank_device(device)
    n = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    n_rows, n_cols = csr.shape
    # pad strictly past n_cols so index n_cols is a guaranteed-zero row
    k_padded = -(-(n_cols + 1) // n) * n
    dtype_key = _plan_dtype_key(dtype)
    itemsize = (1 if dtype_key == "int8"
                else 4 if dtype_key is None else getattr(torch, dtype_key).itemsize)
    idx, val, pos, layout, has_vals, uniq = _ell_layout_stripes(
        csr, n, compact, compact_slots, itemsize, feat_dim, stripe_rows
    )
    cs = _calibrated(calibration, dtype_key, device)
    me = mesh.get_local_rank(axis)
    split, out_rows = _csr_split(n, -(-n_rows // n), n_rows, n_cols, k_padded // n,
                                 stripe_rows, split)
    info = DistInfo(mesh, axis, None, n_rows, n_cols, split, out_rows, None, device)
    arrays = (idx[me].astype(np.int64),
              val[me] if has_vals else np.zeros((1,), np.float32),
              pos[me].astype(np.int64), uniq[me].astype(np.int64))
    st = {"layout": layout, "has_vals": has_vals, "dtype": dtype_key, "cs": cs,
          "need": n_cols + 1}
    return Plan(arrays, _dist_ell_apply, (info, st), device=device)


def dist_csr_spmm_plan(
    csr: CSR, mesh=None, axis: str = "row",
    impl: str = "ell", dtype=None, calibration=None, device=None, **ell_kw,
) -> Plan:
    """Row-partitioned element-sparse SpMM. impl="ell" (default) is the
    scatter-free degree-bucketed tier (extra kwargs - compact,
    compact_slots, feat_dim, stripe_rows, split - reach it);
    impl="segment" keeps the per-stripe gather + segment sum after an
    all_gather of B (f32)."""
    if impl == "ell":
        return dist_csr_spmm_ell_plan(csr, mesh=mesh, axis=axis, dtype=dtype,
                                      calibration=calibration, device=device,
                                      **ell_kw)
    if ell_kw:
        raise TypeError(f"impl={impl!r} takes no extra kwargs: {ell_kw}")
    assert impl == "segment", impl
    mesh = _resolve_mesh(mesh)
    device = rank_device(device)
    n = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    sh = shard_csr(csr, n)
    n_rows, n_cols = csr.shape
    k_padded = -(-n_cols // n) * n
    me = mesh.get_local_rank(axis)
    split, out_rows = _csr_split(n, sh.rows_per_shard, n_rows, n_cols, k_padded // n)
    info = DistInfo(mesh, axis, None, n_rows, n_cols, split, out_rows, None, device)
    arrays = (sh.local_rows[me].astype(np.int64), sh.col_ids[me].astype(np.int64),
              sh.vals[me])
    st = {"dtype": None, "cs": None, "need": n_cols, "rows_per": sh.rows_per_shard}
    return Plan(arrays, _dist_segment_apply, (info, st), device=device)


def _second_part(first: Plan):
    """stripe_rows and split of a sum's first part, for its second."""
    info = exch.dist_info(first)
    return {"stripe_rows": info.out_rows, "split": info.split}


def _check_parts(first: Plan, second: Plan) -> Plan:
    a, b = exch.dist_info(first), exch.dist_info(second)
    if a.split != b.split or any(not np.array_equal(x, y)
                                 for x, y in zip(a.out_rows, b.out_rows)):
        raise AssertionError("a distributed sum's parts must share their stripes")
    return sum_plan((first, second))


def dist_hybrid_spmm_plan(
    hyb,
    mesh=None,
    axis: str = "row",
    strategy: str = "allgather",
    dtype=None,
    calibration=None,
    device=None,
) -> Plan:
    """Distributed hybrid: dense-block stripes + remainder-CSR stripes,
    summed on each rank. The remainder's ELL stripes take the dense
    part's rows (its stripes, or the rows LPT balancing gave them) and
    its operand stripes, so the sum is local. dtype (incl. int8 +
    calibration) reaches both parts. The dense part runs
    dist_bsr_spmm_plan's default local_impl, "xla" (torch ops), as in the
    JAX package."""
    mesh = _resolve_mesh(mesh)
    from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid

    assert isinstance(hyb, Hybrid)
    if hyb.dense.nnzb == 0:
        return dist_csr_spmm_plan(
            hyb.remainder, mesh=mesh, axis=axis, dtype=dtype,
            calibration=calibration, device=device,
        )
    bsr_run = dist_bsr_spmm_plan(
        hyb.dense, mesh=mesh, axis=axis, strategy=strategy, dtype=dtype,
        calibration=calibration, device=device,
    )
    if hyb.remainder.nnz == 0:
        return bsr_run
    csr_run = dist_csr_spmm_plan(
        hyb.remainder, mesh=mesh, axis=axis, dtype=dtype,
        calibration=calibration, device=device, **_second_part(bsr_run),
    )
    return _check_parts(bsr_run, csr_run)


def _dist_win_apply(statics, arrays, dense, plain: bool = False):
    info, st = statics
    tiles, sc, win = arrays
    b_full, col_scale, F = _gathered_operand(info, dense, st, plain)
    W, k_padded = st["W"], st["k_padded"]
    blocked = b_full[:k_padded].reshape(k_padded // W, W, b_full.shape[1])
    wins = blocked.index_select(0, win.reshape(-1)).reshape(win.shape + (W, -1))
    if col_scale is not None:  # (tiles_per, K, R, F) int32 * (tile, slot) scale
        from spmm_denseblock_tpu_torch.ops.windowed_spmm import int8_window_products

        out = int8_window_products(tiles, wins).float() * sc[:, :, None, None]
    else:
        from spmm_denseblock_tpu_torch.ops.windowed_spmm import _f32_matmul

        out = _f32_matmul(tiles, wins)
    out = out.sum(1).reshape(-1, b_full.shape[1])
    if col_scale is not None:
        out = out * col_scale[None, :]
    return info.output(out, F)


def dist_windowed_spmm_plan(
    wt,
    mesh=None,
    axis: str = "row",
    dtype=None,
    calibration=None,
    device=None,
) -> Plan:
    """Distributed windowed dense-tile SpMM: row-band tiles stripe
    contiguously over `axis` (tile t covers rows [t*R, (t+1)*R), so
    stripes need no index translation); each stripe all-gathers B and
    takes its windows; the remainder CSR rides the row-partitioned ELL
    plan on the tiles' stripes (dtype forwarded, so bf16 and int8 shrink
    the remainder's exchange too).

    dtype=int8 (inference only): tiles quantized per (tile, slot) at
    plan time (the windowed_spmm_int8_plan scheme), one global
    per-column operand quantization per call (calibration= makes the
    scales plan constants), int8 all_gather."""
    from spmm_denseblock_tpu_torch.formats.windowed import Windowed

    assert isinstance(wt, Windowed)
    mesh = _resolve_mesh(mesh)
    device = rank_device(device)
    n = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    R, W = wt.tile_rows, wt.window
    n_rows, n_cols = wt.shape
    T = wt.n_tiles
    tiles_per = -(-T // n)
    k_padded = -(-n_cols // W) * W

    # pad tile arrays so each stripe owns tiles_per tiles
    pad_t = n * tiles_per - T
    K = wt.n_windows_per_tile
    tiles_h = np.asarray(wt.tiles)
    win_h = np.asarray(wt.win_idx)
    if pad_t:
        tiles_h = np.concatenate(
            [tiles_h, np.zeros((pad_t, K, R, W), tiles_h.dtype)]
        )
        win_h = np.concatenate(
            [win_h, np.zeros((pad_t, K), win_h.dtype)]
        )
    dtype_key = _plan_dtype_key(dtype)
    int8_mode = dtype_key == "int8"
    cs = _calibrated(calibration, dtype_key, device)
    me = mesh.get_local_rank(axis)
    mine = slice(me * tiles_per, (me + 1) * tiles_per)
    if int8_mode:
        T_pad = tiles_h.shape[0]
        q, s = quantize_blocks(
            np.asarray(tiles_h, np.float32).reshape(T_pad * K, R, W)
        )
        tiles_d = torch.as_tensor(q.reshape(T_pad, K, R, W)[mine])
        sc_h = s.reshape(T_pad, K).astype(np.float32)[mine]
    else:
        tiles_d = torch.as_tensor(tiles_h[mine])
        if dtype_key is not None:
            tiles_d = tiles_d.to(getattr(torch, dtype_key))
        sc_h = np.zeros((tiles_per, 1), np.float32)
    split = OperandSplit.uniform(n, -(-k_padded // n), n_cols)
    out_rows = _contiguous_rows([s * tiles_per * R for s in range(n)],
                                [(s + 1) * tiles_per * R for s in range(n)], n_rows)
    info = DistInfo(mesh, axis, None, n_rows, n_cols, split, out_rows, None, device)
    st = {"W": W, "k_padded": k_padded, "dtype": dtype_key, "cs": cs,
          "need": k_padded}
    win_plan = Plan((tiles_d, sc_h, win_h[mine].astype(np.int64)), _dist_win_apply,
                    (info, st), device=device)
    if not wt.remainder.nnz:
        return win_plan
    rem_plan = dist_csr_spmm_plan(
        wt.remainder, mesh=mesh, axis=axis, dtype=dtype,
        calibration=calibration if int8_mode else None, device=device,
        **_second_part(win_plan),
    )
    return _check_parts(win_plan, rem_plan)


class DistSddmmPlan(Plan):
    """A distributed SDDMM plan: plan(x, y) gives this rank's edges'
    scores; gather_edges(plan, e) all of them in global edge order."""

    def forward(self, x, y):
        return self.apply_fn(self.statics, self.arrays, x, y)


def _dist_sddmm_apply(statics, arrays, x, y):
    info, st = statics
    lr, ci = arrays
    xs, _ = st["x_info"].operand_stripe(x)
    y_full, _, _ = _gathered_operand(info, y, st, False)
    prod = xs.index_select(0, lr) * y_full.index_select(0, ci)
    acc = torch.promote_types(prod.dtype, torch.float32)
    return prod.sum(-1, dtype=acc).to(prod.dtype)


def dist_sddmm_plan(csr: CSR, mesh=None, axis: str = "row", device=None):
    """Distributed SDDMM: edges row-partitioned with their stripe's x
    rows local; y all-gathered once. plan(x, y) returns this rank's
    edges' scores (its stripe's real edges, in row-major order; x and y
    whole, or each a RowStripe of the rank's rows of x and of y);
    gather_edges concatenates every rank's in global edge order, since
    stripes are contiguous row ranges."""
    mesh = _resolve_mesh(mesh)
    device = rank_device(device)
    n = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    sh = shard_csr(csr, n)
    rows_per = sh.rows_per_shard
    n_rows, n_cols = csr.shape
    k_padded = -(-n_cols // n) * n
    counts = np.bincount(csr.row_ids() // rows_per, minlength=n)
    me = mesh.get_local_rank(axis)
    k = int(counts[me])
    edge_off = np.concatenate([[0], np.cumsum(counts)])
    edges = tuple(np.arange(edge_off[s], edge_off[s + 1], dtype=np.int64)
                  for s in range(n))
    y_split = OperandSplit.uniform(n, k_padded // n, n_cols)
    x_split = OperandSplit.uniform(n, rows_per, n_rows)
    info = DistInfo(mesh, axis, None, csr.nnz, n_cols, y_split, edges, None, device)
    x_info = DistInfo(mesh, axis, None, n_rows, n_rows, x_split, edges, None, device)
    st = {"dtype": "keep", "cs": None, "need": n_cols, "x_info": x_info}
    return DistSddmmPlan(
        (sh.local_rows[me, :k].astype(np.int64), sh.col_ids[me, :k].astype(np.int64)),
        _dist_sddmm_apply, (info, st), device=device)


def gather_edges(plan, e: torch.Tensor) -> torch.Tensor:
    """Every rank's edge scores in global edge order, on every rank."""
    info = exch.dist_info(plan)
    return exch.gather_rows(info, e, info.out_rows, info.n_rows)
