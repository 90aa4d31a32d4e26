"""CSR SpMM through degree-bucketed ELL padding (twin of
``spmm_denseblock_tpu/ops/csr_spmm_ell.py``): a scatter-free reduction.

Rows are bucketed by their ELL width K (``_row_widths``: the next power
of two, or a multiple of a quarter of it); each class holds its rows'
column ids as an (m, K) array, pads pointing at a zero row appended to
the operand (pattern-only matrices) or at row 0 with value 0 (valued
ones). A class's product is then a gather of its slots' operand rows and
a dense sum over K, with no scatter: "matsum" gathers an (m, K, F) block
and sums its K axis, "scan" runs K gather-accumulate steps with no (m,
K, F) intermediate. The outputs come out class by class; one row gather
with the position map restores the caller's row order.

All layout work happens on the host, once, bit-equal to the JAX plan:
the degree classes, the row order, the pad indices, ``positions``, the
chunk split at CHUNK_SLOTS, the compaction spans and the matsum/scan
choice. The JAX tier is XLA code, not a Pallas kernel. On the card, an
f32 ``csr_ell`` plan runs one hand-written kernel a call
(``sdb_ell_spmm`` in ``csrc/csr_spmm.cu``, counter ``_kernels.ell_spmm``):
the plan flattens its chunks once (``_ell_flat``: the column ids and
values class-major, compacted chunks resolved to operand rows, each
row's slot start) and cuts each row's stored entries into K10's segments
(``row_segments``), and the kernel gathers, multiplies and sums each row
in registers and stores it once, at the caller's row, reading no pad and
no (m, K, F) block. ``_run_chunks`` on the same flat arrays, chunk by
chunk, is its plain PyTorch version: the CPU runs it, and so does
``plain=True``. A pattern plan (``values="call"``) takes A's values with
each call, (nnz,) or (H, nnz) for H heads in the pattern's entry order:
the kernel reads them through each segment's offset from its slots to
its entries, every head in one launch, and the chunk loop scatters them
into their slots. The bf16 ``csr_ell``, the int8 ELL (``csr_ell_int8``) and
the banded ELL (``csr_ell_banded``) are plain torch ops on the card too.
Two things of the JAX plan are left out. It stores the
matsum chunks with m > K and every scan chunk transposed, as (K, m),
because a TPU tile pads a small minor dimension to 128 lanes
(``_store_chunk``); the card has no such padding, so every chunk here is
(m, K). And its chunks are separate arguments of one jitted program;
here they are buffers of one Plan, run one after another.

The constants of the two-level gather model and of the scan/matsum
choice are the JAX package's TPU v5e fits, copied as they are: the
router's ELL options follow them until they are measured on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_denseblock_tpu_torch import native
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops import _kernels
from spmm_denseblock_tpu_torch.ops._device import (
    _device_of,
    _l2_bytes,
    check_arrays,
    resolve_device,
    runs_f32_kernels,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    dtype_name,
    reject_grad_request,
    reject_int8_cast,
    static_col_scale,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import quantize_int8
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import equal_strip_width, row_segments
from spmm_denseblock_tpu_torch.ops.plan import Plan, grad_plan
from spmm_denseblock_tpu_torch.reorder.simple import _ragged_arange
from spmm_denseblock_tpu_torch.utils import profiling

# the slots of one chunk: it bounds the (m, K, F) gather intermediate in
# device memory (4M slots: 2 GB in f32 at F = 128)
CHUNK_SLOTS = 4 << 20

# -- the two-level (unique-compacted) gather model -----------------------------
# A chunk whose rows share most neighbours can gather its U unique
# operand rows once into a compact sub-table and read its S slots from
# that: U * r_big + S * r_small(U*F*itemsize) against S * r_big, with
# per-slot gather rates (ns) that depend on the table's bytes.
GATHER_FAST_TABLE_BYTES = 96 << 20
GATHER_MID_TABLE_BYTES = 176 << 20
GATHER_NS_MID_TABLE = 4.25
ELL_NS_PER_SLOT_SMALL_TABLE = 2.6
ELL_NS_PER_SLOT_BIG_TABLE = 11.5
COMPACT_SLOTS = 1 << 20  # candidate span when compact != "off"
_COMPACT_MIN_GAIN = 0.9  # modelled two-level cost must be <= 90% of flat

# scan pays off on a big gather source and a class wide enough to carry
# its per-step cost
SCAN_MIN_SOURCE_ROWS = 1 << 19
_SCAN_MIN_M, _SCAN_MAX_K = 4096, 256


def _gather_ns_per_slot(table_bytes: int, itemsize: int) -> float:
    if table_bytes <= GATHER_FAST_TABLE_BYTES:
        return ELL_NS_PER_SLOT_SMALL_TABLE
    if table_bytes <= GATHER_MID_TABLE_BYTES:
        return GATHER_NS_MID_TABLE
    return ELL_NS_PER_SLOT_BIG_TABLE if itemsize >= 4 else 8.4


def _compact_spans(idx, m_k, K, max_m, compact, compact_slots, feat_dim,
                   itemsize, r_big, n_vals):
    """Split a degree class's m_k rows into chunk spans: a list of
    (row_start, n_rows, uniq, inv), uniq and inv None for a plain chunk
    and the span's np.unique(return_inverse) for one that the model (or
    compact="force") gathers in two levels. Rejected candidate spans
    merge back into plain chunks of max_m rows."""

    def plain(s0, m0):
        return [(s0 + o, min(max_m, m0 - o), None, None)
                for o in range(0, m0, max_m)]

    if compact == "off":
        return plain(0, m_k)
    # candidate spans never exceed max_m: CHUNK_SLOTS bounds compacted
    # chunks as it bounds plain ones
    tgt_m = max(1, min(compact_slots // K, max_m))
    spans, pend = [], None  # pend: accumulated rejected (start, len)
    for s in range(0, m_k, tgt_m):
        m = min(tgt_m, m_k - s)
        uniq, inv = native.unique_inverse(idx[s * K: (s + m) * K], n_vals)
        S, U = m * K, uniq.size
        r_sub = _gather_ns_per_slot(U * feat_dim * itemsize, itemsize)
        win = U * r_big + S * r_sub <= _COMPACT_MIN_GAIN * S * r_big
        if compact == "force" or win:
            if pend is not None:
                spans.extend(plain(*pend))
                pend = None
            spans.append((s, m, uniq, inv))
        else:
            pend = (s, m) if pend is None else (pend[0], pend[1] + m)
    if pend is not None:
        spans.extend(plain(*pend))
    return spans


def _row_widths(deg: np.ndarray, bucket: str) -> np.ndarray:
    """Per-row ELL width. "pow2": the next power of two (< 2x waste);
    "quarter": a multiple of next_pow2(deg) / 4 (<= 1.25x waste, about
    twice the classes)."""
    p2 = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64))
    if bucket == "pow2":
        return p2
    if bucket != "quarter":
        raise ValueError(f"unknown ELL bucket scheme: {bucket!r}")
    step = np.maximum(1, p2 // 4)
    return np.maximum(1, ((deg + step - 1) // step) * step)


def _chunk_mode(reduce: str, n_cols: int, m: int, K: int) -> str:
    if reduce == "matsum" or K < 2:
        return "matsum"
    if m < _SCAN_MIN_M or K > _SCAN_MAX_K:
        return "matsum"
    if reduce == "scan":
        return "scan"
    return "scan" if n_cols >= SCAN_MIN_SOURCE_ROWS else "matsum"


def _ell_layout(csr: CSR, bucket: str = "quarter", reduce: str = "auto",
                row_sort: str = "keep", compact: str = "off",
                compact_slots: int = COMPACT_SLOTS, itemsize: int = 4,
                feat_dim: int = 128):
    """The ELL layout of `csr`: (idx_chunks, val_chunks, positions,
    layout, has_vals). Each chunk of idx_chunks is an (m, K) int32 array
    of operand rows, or for a compacted chunk a pair (uniq, local): the
    chunk's unique operand rows and its (m, K) indices into them;
    val_chunks holds each chunk's (m, K) f32 values (valued matrices
    only); layout one (m, K, mode, band_start, compacted) per chunk, with
    band_start -1 (the whole table).

    row_sort: "keep" keeps the caller's row order inside each class,
    "meancol" sorts a class's rows by mean column id. compact: "off",
    "auto" (compact the spans where the model predicts a win; never when
    the whole table is small) or "force". itemsize and feat_dim size the
    model's table bytes; they change no answer."""
    deg = csr.degrees().astype(np.int64)
    n = csr.n_rows
    K_r = _row_widths(deg, bucket)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    if row_sort == "meancol":
        csum = np.concatenate([[0], np.cumsum(cols, dtype=np.int64)])
        mean_col = (csum[indptr[1:]] - csum[indptr[:-1]]) // np.maximum(deg, 1)
        order = np.lexsort((mean_col, K_r))  # class-major, mean-col minor
    elif row_sort == "keep":
        order = np.argsort(K_r, kind="stable")  # rows grouped by class
    else:
        raise ValueError(f"unknown row_sort: {row_sort!r}")
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, dtype=np.float32) if has_vals else None

    # valued layouts pad at row 0 (val 0 kills the term), pattern-only
    # ones at the zero row n_cols appended to the operand
    pad_idx = 0 if has_vals else csr.n_cols
    if compact not in ("off", "auto", "force"):
        raise ValueError(f"unknown compact mode: {compact!r}")
    table_bytes = int(csr.n_cols) * feat_dim * itemsize
    r_big = _gather_ns_per_slot(table_bytes, itemsize)
    if compact == "auto" and table_bytes <= GATHER_FAST_TABLE_BYTES:
        compact = "off"  # the whole table gathers at the fast rate already
    idx_parts, val_parts, layout = [], [], []
    for K in np.unique(K_r[order]):
        K = int(K)
        rows_k = order[K_r[order] == K]
        m_k = rows_k.size
        idx = np.full(m_k * K, pad_idx, dtype=np.int32)
        starts = indptr[rows_k]
        d = indptr[rows_k + 1] - starts
        tgt = np.repeat(np.arange(m_k, dtype=np.int64) * K, d) + _ragged_arange(d)
        src = np.repeat(starts, d) + _ragged_arange(d)
        idx[tgt] = cols[src]
        v = None
        if has_vals:
            v = np.zeros(m_k * K, dtype=np.float32)
            v[tgt] = vals[src]
        max_m = max(1, CHUNK_SLOTS // K)
        for s, m, uniq, inv in _compact_spans(idx, m_k, K, max_m, compact,
                                              compact_slots, feat_dim,
                                              itemsize, r_big, csr.n_cols + 1):
            if uniq is not None:
                idx_parts.append((uniq, inv.reshape(m, K)))
                layout.append((m, K, _chunk_mode(reduce, uniq.size, m, K), -1,
                               True))
            else:
                idx_parts.append(idx[s * K: (s + m) * K].reshape(m, K))
                layout.append((m, K, _chunk_mode(reduce, csr.n_cols, m, K), -1,
                               False))
            if has_vals:
                val_parts.append(v[s * K: (s + m) * K].reshape(m, K))

    positions = np.empty(n, dtype=np.int32)
    positions[order] = np.arange(n, dtype=np.int32)
    return (tuple(idx_parts), tuple(val_parts), positions, tuple(layout),
            has_vals)


def _banded_split(csr: CSR, band_rows: int):
    """Each row's home band (the `band_rows`-wide column band holding
    most of its nonzeros, its start clamped so that the band fits the
    table) and each nonzero's in-band mask: (row_start, in_mask)."""
    W = band_rows
    n_rows, n_cols = csr.shape
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    nbands = max(1, -(-n_cols // W))
    key = rows * nbands + cols // W
    cnt = np.bincount(key, minlength=n_rows * nbands).reshape(n_rows, nbands)
    home = cnt.argmax(1)
    row_start = np.minimum(home * W, max(0, n_cols - W)).astype(np.int64)
    in_mask = (cols >= row_start[rows]) & (cols < row_start[rows] + W)
    return row_start, in_mask


def _ell_layout_banded(csr: CSR, band_rows: int, bucket: str):
    """The in-band ELL layout: rows grouped by (home band, width class),
    indices local to the band, pads at local 0 with value 0 (every chunk
    is valued: a band slice has no zero row). Returns _ell_layout's
    first four items and the overflow COO (rows, cols, vals or None)."""
    n_rows, n_cols = csr.shape
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, np.float32) if has_vals else None

    row_start, in_mask = _banded_split(csr, band_rows)
    in_rows, in_cols = rows[in_mask], cols[in_mask]
    in_vals = vals[in_mask] if has_vals else np.ones(in_mask.sum(), np.float32)
    in_local = (in_cols - row_start[in_rows]).astype(np.int32)
    d_in = np.bincount(in_rows, minlength=n_rows).astype(np.int64)
    K_r = _row_widths(d_in, bucket)

    # rows grouped by (band start, width class), the caller's order kept
    # inside a group
    order = np.lexsort((K_r, row_start))
    in_ptr = np.concatenate([[0], np.cumsum(d_in)])

    idx_parts, val_parts, layout = [], [], []
    group_key = row_start[order] * (K_r.max() + 1) + K_r[order]
    boundaries = np.flatnonzero(
        np.concatenate([[True], group_key[1:] != group_key[:-1]])
    )
    for gi, b0 in enumerate(boundaries):
        b1 = boundaries[gi + 1] if gi + 1 < boundaries.size else order.size
        rows_g = order[b0:b1]
        K = int(K_r[rows_g[0]])
        start = int(row_start[rows_g[0]])
        m_g = rows_g.size
        idx = np.zeros(m_g * K, dtype=np.int32)  # pads: local 0, val 0
        v = np.zeros(m_g * K, dtype=np.float32)
        d = d_in[rows_g]
        tgt = np.repeat(np.arange(m_g, dtype=np.int64) * K, d) + _ragged_arange(d)
        src = np.repeat(in_ptr[rows_g], d) + _ragged_arange(d)
        idx[tgt] = in_local[src]
        v[tgt] = in_vals[src]
        max_m = max(1, CHUNK_SLOTS // K)
        for s in range(0, m_g, max_m):
            m = int(min(max_m, m_g - s))
            idx_parts.append(idx[s * K: (s + m) * K].reshape(m, K))
            val_parts.append(v[s * K: (s + m) * K].reshape(m, K))
            layout.append((m, K, "matsum", start, False))

    positions = np.empty(n_rows, dtype=np.int32)
    positions[order] = np.arange(n_rows, dtype=np.int32)
    ovf = (rows[~in_mask], cols[~in_mask], vals[~in_mask] if has_vals else None)
    return tuple(idx_parts), tuple(val_parts), positions, tuple(layout), ovf


# -- the kernel's flattened layout ---------------------------------------------


def _ell_flat(idx_chunks, val_chunks, layout, positions):
    """The f32 kernel's arrays of an _ell_layout result: (cols, vals,
    slot_start). cols (Σ m·K,) int32 holds every chunk's (m, K) operand
    rows in chunk order (class-major), a compacted chunk's resolved to
    operand rows (uniq[inv]: compaction is a TPU gather-rate device and
    changes no product or sum); vals (Σ m·K,) f32 the chunks' values in
    the same slots, or None (pattern-only); slot_start (n_rows,) int64 the
    first of each caller row's K slots, which hold its stored entries
    first (in CSR order) and its pads after them."""
    cols = [c[0][c[1]] if isinstance(c, tuple) else c for c in idx_chunks]
    cols = (np.concatenate([c.reshape(-1) for c in cols]) if cols
            else np.zeros(0, np.int32)).astype(np.int32)
    vals = (np.concatenate([v.reshape(-1) for v in val_chunks]).astype(np.float32)
            if val_chunks else None)
    widths = np.repeat(np.asarray([K for _, K, *_ in layout], np.int64),
                       np.asarray([m for m, *_ in layout], np.int64))
    start = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
    return cols, vals, start[np.asarray(positions, np.int64)]


def _flat_chunks(cols, vals, layout) -> list:
    """_run_chunks' arrays as (m, K) views of the flat ones: per chunk its
    indices, then its values (valued layouts). The layout's chunks must
    be marked uncompacted (their columns are resolved)."""
    out, o = [], 0
    for m, K, *_ in layout:
        out.append(cols[o:o + m * K].view(m, K))
        if vals is not None:
            out.append(vals[o:o + m * K].view(m, K))
        o += m * K
    return out


ELL_MAX_STRIP = 128  # the kernel's widest strip: 32 lanes x 4 columns
ELL_STRIP_UNIT = 4   # a strip is a multiple of one 16-byte load's columns
ELL_L2_SHARE = 0.85  # of the L2 a strip of X may fill


def ell_strip_width(K: int, F: int, l2_bytes: int) -> int:
    """The f32 ELL kernel's strip width W for a (K, F) f32 operand on a
    card with l2_bytes of L2: F cut into the fewest strips that are at
    most ELL_MAX_STRIP columns wide and whose (K, W) slice of X fills at
    most ELL_L2_SHARE of the L2 (one unit wide if none does), made equal
    and rounded up to a multiple of ELL_STRIP_UNIT. On an H100 the arxiv
    serve graph's remainder (X 87 MB at F = 128, 85% of the L2 holds 64
    columns) took 0.245-0.251 ms in strips of 64 or one of 128, and at F =
    256 0.471-0.476 ms in strips of 64 against 0.472-0.488 in strips of
    128 and 0.527 in one of 256 read with two loads a lane
    (scripts/torch_ell_probe.py). W == F walks all of F as one strip."""
    return equal_strip_width(K, F, l2_bytes, 4, ELL_L2_SHARE, ELL_STRIP_UNIT,
                             ELL_MAX_STRIP)


def spmm_ell(cols, vals, seg_start, seg_end, seg_dest, split_row, part_ptr,
             dense, n_rows: int, n_partials: int, seg_delta=None) -> torch.Tensor:
    """The f32 ELL tier's kernel: C (n_rows, F) f32 = A @ dense over the
    flat layout (_ell_flat), walked by the segments of each row's stored
    entries (row_segments), n_partials = part_ptr[-1] partial rows for the
    rows split into several. vals: None for a pattern-only layout, the
    plan's own (n_slots,) values in slot order, or with seg_delta (n_seg,)
    int64 a call's (H, nnz) values in the pattern's entry order: slot k of
    segment s takes entry k + seg_delta[s], and head h's row of values
    multiplies column block h of dense (F = H·D, one launch for every
    head). X in strips of ell_strip_width's width inside a head. CUDA
    tensors only: the plain version is _run_chunks on the same arrays
    (_ell_apply)."""
    seg = (seg_start, seg_end, seg_dest, split_row, part_ptr)
    valued = () if vals is None else (vals,)
    delta = () if seg_delta is None else (seg_delta,)
    dev = _device_of(cols, *valued, *seg, *delta, dense)
    if dev.type != "cuda":
        raise ValueError(f"sdb_ell_spmm runs on CUDA tensors, got {dev}")
    check_arrays([("cols", cols, torch.int32), ("dense", dense, torch.float32)]
                 + [("vals", t, torch.float32) for t in valued]
                 + [(n, t, torch.int64) for n, t in zip(
                     ("seg_start", "seg_end", "seg_dest", "split_row", "part_ptr",
                      "seg_delta"), seg + delta)])
    if dense.dim() != 2:
        raise ValueError(f"dense must be (K, F), got {tuple(dense.shape)}")
    F = dense.shape[1]
    heads, vstride = 1, 0
    if seg_delta is not None:
        if vals is None or vals.dim() != 2 or F % vals.shape[0]:
            raise ValueError("call values must be (heads, nnz) with F a multiple "
                             f"of heads, got {None if vals is None else tuple(vals.shape)}"
                             f" for F = {F}")
        heads, vstride = vals.shape
    elif vals is not None and vals.numel() != cols.numel():
        raise ValueError("cols and vals must hold the same slots")
    out = torch.empty(n_rows, F, dtype=torch.float32, device=dev)
    partial = torch.empty(n_partials, F, dtype=torch.float32, device=dev)
    W = ell_strip_width(dense.shape[0], F // heads, _l2_bytes(dev.index))
    with torch.cuda.device(dev):
        _kernels.ell_spmm(
            seg_start.data_ptr(), seg_end.data_ptr(), seg_dest.data_ptr(),
            0 if seg_delta is None else seg_delta.data_ptr(),
            cols.data_ptr(), 0 if vals is None else vals.data_ptr(),
            dense.data_ptr(), out.data_ptr(), partial.data_ptr(),
            split_row.data_ptr(), part_ptr.data_ptr(), seg_start.shape[0],
            split_row.shape[0], F, W, heads, vstride,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


# -- the call -----------------------------------------------------------------


def _chunk_arrays(idx_chunks, val_chunks) -> list:
    """The chunks' arrays in the order _run_chunks reads them: per chunk
    its unique rows (compacted chunks), its (m, K) indices, then its (m,
    K) values (valued layouts)."""
    out = []
    for i, c in enumerate(idx_chunks):
        out.extend(c if isinstance(c, tuple) else (c,))
        if val_chunks:
            out.append(val_chunks[i])
    return out


def _run_chunks(arrays, j: int, table, layout, has_vals: bool, band_rows: int):
    """Every chunk of `layout`, its arrays read from arrays[j:], against
    the operand `table`: the chunks' partial rows concatenated, (sum m,
    F) f32, and the index of the next unread array.

    bf16 tables gather in bf16 and round the values to bf16, and the
    products and sums run in f32 (a bf16 x bf16 product is exact there):
    the JAX plan's answer on the CPU, where XLA keeps the products in f32
    (rounding them to bf16 moved the answer by 1.5e-3 of its max). int8
    tables sum pattern-only chunks in int32 (exact: |sum| <= K * 127) and
    widen to f32 before a value multiply."""
    F = table.shape[1]
    # the values' dtype in the products: the table's, but f32 for int8
    vdt = torch.float32 if table.dtype == torch.int8 else table.dtype
    outs = []
    for m, K, mode, band_start, compacted in layout:
        if compacted:
            src = table.index_select(0, arrays[j])
            j += 1
        elif band_start >= 0:
            src = table.narrow(0, band_start, band_rows)
        else:
            src = table
        idx = arrays[j]
        v = arrays[j + 1].to(vdt).float() if has_vals else None
        j += 2 if has_vals else 1
        if mode == "scan":  # K gather-accumulate steps, no (m, K, F) block
            out = torch.zeros(m, F, dtype=torch.float32, device=table.device)
            for k in range(K):
                g = src.index_select(0, idx[:, k]).float()
                out += g * v[:, k, None] if has_vals else g
        else:
            g = src.index_select(0, idx.reshape(-1)).view(m, K, F)
            if has_vals:
                out = (g.float() * v[:, :, None]).sum(1)
            else:
                sum_dtype = torch.int32 if g.dtype == torch.int8 else torch.float32
                out = g.sum(1, dtype=sum_dtype).float()
        outs.append(out)
    return (torch.cat(outs) if len(outs) > 1 else outs[0]), j


def _slots(*layouts) -> int:
    """The element positions the layouts compute a call: Σ m·K over their
    chunks, pad slots included (a pad reads a zero row, or row 0 with
    value 0)."""
    return sum(m * K for layout in layouts for m, K, *_ in layout)


def _operand(dense, n_cols: int, device, dtype_key: Optional[str]) -> torch.Tensor:
    """The operand on the plan's device in the plan's dtype (f32 by
    default)."""
    dense = torch.as_tensor(dense, device=device)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    return dense.to(getattr(torch, dtype_key or "float32"))


def _plan_dtype_key(dtype) -> Optional[str]:
    """None (f32), "float32" or "bfloat16"; int8 raises ValueError (the
    quantized tier), anything else too."""
    if dtype is None:
        return None
    reject_int8_cast(dtype, "csr_ell (use csr_ell_int8)")
    name = dtype_name(dtype)
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {dtype!r} (None, float32 or bfloat16)")
    return name


# -- the plans ----------------------------------------------------------------


def _entry_slots(csr: CSR, slot_start: np.ndarray, n_slots: int, segments):
    """The map of a pattern's stored entries to their slots of the flat
    layout, and each segment's offset from its slots to its entries:
    (slot_of_entry (nnz,), seg_delta (n_seg,)), int64. A row's stored
    entries lead its slots, in CSR order, so entry e of row r lies at
    slot slot_start[r] + e - indptr[r]; a segment lies inside one row, so
    slot k of segment s holds entry k + seg_delta[s] (0 for an empty
    segment)."""
    indptr = np.asarray(csr.indptr, np.int64)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), np.diff(indptr))
    entry = np.arange(csr.nnz, dtype=np.int64)
    slot_of_entry = slot_start[rows] + entry - indptr[rows]
    offset = np.zeros(n_slots, np.int64)  # entry - slot, at each entry's slot
    offset[slot_of_entry] = entry - slot_of_entry
    seg_start, seg_end = segments[:2]
    live = seg_end > seg_start
    seg_delta = np.where(live, offset[np.where(live, seg_start, 0)], 0)
    return slot_of_entry, seg_delta.astype(np.int64)


def call_values(values, nnz: int, F: int, device) -> torch.Tensor:
    """A call's values as the valued plans take them: (H, nnz) f32,
    contiguous, on `device`, from (nnz,) (one head) or (H, nnz), in the
    entry order of the pattern the plan was built from; ValueError where
    the shape does not fit nnz or F is not a multiple of H."""
    values = torch.as_tensor(values, device=device)
    if values.dim() == 1:
        values = values[None]
    if values.dim() != 2 or values.shape[1] != nnz or values.shape[0] == 0:
        raise ValueError(f"values must be (nnz,) or (heads, nnz) with nnz = {nnz}, "
                         f"got {tuple(values.shape)}")
    if F % values.shape[0]:
        raise ValueError(f"the operand's F = {F} is not a multiple of the values' "
                         f"{values.shape[0]} heads")
    return values.to(torch.float32).contiguous()


def csr_spmm_ell_plan(csr: CSR, grad: bool = True, dtype=None,
                      bucket: str = "quarter", reduce: str = "auto",
                      row_sort: str = "keep", compact: str = "off",
                      compact_slots: int = COMPACT_SLOTS,
                      feat_dim: int = 128, device=None, values=None) -> Plan:
    """Host layout prep once -> Plan computing C = A @ dense in f32.

    dtype: None or float32 (on the card the kernel sdb_ell_spmm), or
    bfloat16 (a bf16 gather, values rounded to bf16, f32 products and
    sums; about 1e-3 relative, opt-in; torch ops on the card too); int8
    raises ValueError (use
    csr_spmm_ell_int8_plan). bucket: "quarter" or "pow2" (_row_widths).
    reduce: "auto" picks matsum or scan per chunk (_chunk_mode);
    "matsum"/"scan" force one. row_sort, compact, compact_slots,
    feat_dim: see _ell_layout. grad: True (the default) returns a
    grad_plan whose backward runs the plan of Aᵀ. device: None is the
    card. Work figures (``ops/plan``): nnz, A's; positions, the slots a
    call walks: on the card an f32 plan's kernel the nnz stored entries
    alone, the torch ops (the CPU, bf16) ``_slots``, pads included. The
    arrays: positions, the flat columns and (valued) values of _ell_flat,
    then row_segments' five arrays over the rows' stored entries.

    values="call" gives the pattern plan: its values come with each call,
    plan(dense, values=v), v (nnz,) or (H, nnz) in csr's entry order (its
    own values, if any, are not used), head h's row multiplying column
    block h of dense (F = H·D). The layout is the valued one (pads at row
    0, never read by the kernel); the plan holds _entry_slots' map and
    offsets after the flat columns, and the kernel reads each head's
    values through the offsets, in one launch for every head; the chunk
    loop scatters each head's values into its slots. No gradient: grad
    must be False, and a call that needs a gradient raises
    (``ops/plan``)."""
    device = resolve_device(device)
    dtype_key = _plan_dtype_key(dtype)
    if values not in (None, "call"):
        raise ValueError(f"values must be None or 'call', got {values!r}")
    per_call = values == "call"
    if per_call and grad:
        raise ValueError("a values='call' plan has no backward: pass grad=False")
    kw = dict(dtype=dtype, bucket=bucket, reduce=reduce, row_sort=row_sort,
              compact=compact, compact_slots=compact_slots, feat_dim=feat_dim,
              device=device)
    if grad:
        return grad_plan(csr_spmm_ell_plan(csr, grad=False, **kw),
                         csr_spmm_ell_plan(csr.transpose(), grad=False, **kw))
    itemsize = 4 if dtype_key in (None, "float32") else 2
    pattern = csr
    if per_call:  # the valued layout: pads at row 0, where a value 0 goes
        pattern = CSR(csr.indptr, csr.indices, np.ones(csr.nnz, np.float32),
                      csr.shape)
    idx_chunks, val_chunks, positions, layout, has_vals = _ell_layout(
        pattern, bucket, reduce, row_sort, compact, compact_slots, itemsize,
        feat_dim,
    )
    cols, vals, slot_start = _ell_flat(idx_chunks, val_chunks, layout, positions)
    segments = row_segments(np.append(slot_start, cols.size), csr.indptr,
                            longest_first=True)
    if per_call:
        entries = _entry_slots(csr, slot_start, cols.size, segments)
        arrays = [positions, cols, *entries, *segments]
    else:
        arrays = [positions, cols, *(() if vals is None else (vals,)), *segments]
    # the columns are resolved: no chunk is compacted any more
    flat_layout = tuple((m, K, mode, band, False) for m, K, mode, band, _ in layout)
    statics = (csr.shape, flat_layout, has_vals, dtype_key, int(segments[4][-1]),
               per_call)
    on_kernel = runs_f32_kernels(device, itemsize)
    return Plan(arrays, _ell_apply, statics, device=device, name="csr_ell",
                nnz=csr.nnz, positions=csr.nnz if on_kernel else _slots(layout),
                call_values=per_call)


def _ell_apply(statics, arrays, dense, plain: bool = False, values=None):
    # f32 on the card: the kernel; else (CPU, bf16, plain=True) its plain
    # version, the chunk loop on views of the same flat arrays
    (n_rows, n_cols), layout, has_vals, dtype_key, n_partials, per_call = statics
    positions, cols = arrays[:2]
    dense = _operand(dense, n_cols, positions.device, dtype_key)
    seg_delta = None
    if per_call:
        slot_of_entry, seg_delta = arrays[2:4]
        vals = call_values(values, slot_of_entry.numel(), dense.shape[1],
                           positions.device)
    else:
        vals = arrays[2] if has_vals else None
    if dense.is_cuda and dense.dtype == torch.float32 and not plain:
        out = spmm_ell(cols, vals, *arrays[-5:], dense.contiguous(), n_rows,
                       n_partials, seg_delta=seg_delta)
        profiling.count("sdb.kernel/csr_ell", 1)
        return out
    if not layout:  # no rows
        return torch.zeros(n_rows, dense.shape[1], dtype=torch.float32,
                           device=dense.device)
    if per_call:  # each head's values scattered into its slots, pads 0
        D = dense.shape[1] // vals.shape[0]
        outs = []
        for h, v in enumerate(vals):
            slot_vals = v.new_zeros(cols.numel()).index_copy_(0, slot_of_entry, v)
            cat, _ = _run_chunks(_flat_chunks(cols, slot_vals, layout), 0,
                                 dense[:, h * D:(h + 1) * D], layout, True, 0)
            outs.append(cat)
        return torch.cat(outs, 1).index_select(0, positions)
    if not has_vals:  # the zero row that every pad slot reads
        dense = torch.cat([dense, dense.new_zeros(1, dense.shape[1])])
    cat, _ = _run_chunks(_flat_chunks(cols, vals, layout), 0, dense, layout,
                         has_vals, 0)
    return cat.index_select(0, positions)


def csr_spmm_ell_banded_plan(csr: CSR, band_rows: int = 1 << 19,
                             grad: bool = True, dtype=None,
                             bucket: str = "quarter", reduce: str = "auto",
                             device=None) -> Plan:
    """Banded ELL: a row's nonzeros inside its home band of `band_rows`
    operand rows gather from that slice of the operand, the rest run
    through a full-table ELL layout of their own, and the two sums add.
    With the table no wider than a band, the plain ELL plan. dtype and
    grad as csr_spmm_ell_plan; device: None is the card."""
    device = resolve_device(device)
    dtype_key = _plan_dtype_key(dtype)
    if grad:
        kw = dict(dtype=dtype, bucket=bucket, reduce=reduce, device=device)
        return grad_plan(
            csr_spmm_ell_banded_plan(csr, band_rows, grad=False, **kw),
            csr_spmm_ell_banded_plan(csr.transpose(), band_rows, grad=False, **kw))
    if csr.n_cols <= band_rows:  # nothing to band
        return csr_spmm_ell_plan(csr, grad=False, dtype=dtype, bucket=bucket,
                                 reduce=reduce, device=device)
    idx_in, vals_in, pos_in, layout_in, (orows, ocols, ovals) = (
        _ell_layout_banded(csr, band_rows, bucket)
    )
    if ovals is None:  # the valued (pad-at-0) form: no zero row appended
        ovals = np.ones(orows.shape[0], np.float32)
    ovf_csr = CSR.from_coo(orows, ocols, ovals, shape=csr.shape)
    idx_ovf, vals_ovf, pos_ovf, layout_ovf, _ = _ell_layout(ovf_csr, bucket, reduce)
    arrays = [pos_in, pos_ovf, *_chunk_arrays(idx_in, vals_in),
              *_chunk_arrays(idx_ovf, vals_ovf)]
    statics = (csr.shape, layout_in, layout_ovf, dtype_key, int(band_rows))
    return Plan(arrays, _banded_apply, statics, device=device,
                name="csr_ell_banded", nnz=csr.nnz,
                positions=_slots(layout_in, layout_ovf))


def _banded_apply(statics, arrays, dense, plain: bool = False):
    # plain torch ops already: plain=True runs the same ops
    (n_rows, n_cols), layout_in, layout_ovf, dtype_key, band_rows = statics
    pos_in, pos_ovf = arrays[:2]
    dense = _operand(dense, n_cols, pos_in.device, dtype_key)
    cat_in, j = _run_chunks(arrays, 2, dense, layout_in, True, band_rows)
    cat_ovf, _ = _run_chunks(arrays, j, dense, layout_ovf, True, 0)
    return cat_in.index_select(0, pos_in) + cat_ovf.index_select(0, pos_ovf)


def csr_spmm_ell_int8_plan(csr: CSR, calibration=None, bucket: str = "quarter",
                           reduce: str = "auto", row_sort: str = "keep",
                           compact: str = "off",
                           compact_slots: int = COMPACT_SLOTS,
                           feat_dim: int = 128, device=None, **_ignored) -> Plan:
    """The ELL layout over an int8 operand, quantized per column as every
    int8 tier does (on the card by the quantize_int8 kernel, its zero pad
    row included; on the CPU by its plain version), rescaled once at the
    end: C = s[c] * (A @ q)[:, c]. Inference only (grad=True raises).

    calibration: an optional representative operand batch that fixes the
    column scales at plan time (static_col_scale); without it each call
    quantizes with the operand's own scales. device: None is the card."""
    device = resolve_device(device)
    reject_grad_request(_ignored, "csr_ell_int8")
    idx_chunks, val_chunks, positions, layout, has_vals = _ell_layout(
        csr, bucket, reduce, row_sort, compact, compact_slots, itemsize=1,
        feat_dim=feat_dim,
    )
    arrays = [positions, *_chunk_arrays(idx_chunks, val_chunks)]
    if calibration is not None:
        arrays.append(static_col_scale(calibration))
    statics = (csr.shape, layout, has_vals, calibration is not None)
    return Plan(arrays, _ell_int8_apply, statics, device=device,
                name="csr_ell_int8", nnz=csr.nnz, positions=_slots(layout))


def _ell_int8_apply(statics, arrays, dense, plain: bool = False):
    # plain=True quantizes with quantize_int8's plain version; the rest is
    # plain torch ops either way
    (n_rows, n_cols), layout, has_vals, calibrated = statics
    positions = arrays[0]
    dense = _operand(dense, n_cols, positions.device, None)
    if not layout:  # no rows
        return torch.zeros(n_rows, dense.shape[1], dtype=torch.float32,
                           device=dense.device)
    # pattern-only layouts read a zero row at n_cols: the quantizer's pad
    q, col_scale = quantize_int8(dense, n_cols + (0 if has_vals else 1),
                                 arrays[-1] if calibrated else None, plain=plain)
    cat, _ = _run_chunks(arrays, 1, q, layout, has_vals, 0)
    return cat.index_select(0, positions) * col_scale[None, :]


def csr_spmm_ell(csr: CSR, dense, **kw) -> torch.Tensor:
    return csr_spmm_ell_plan(csr, **kw)(dense)
