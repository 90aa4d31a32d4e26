"""CSR SpMM plan on a hand-written CUDA kernel (twin of
``spmm_denseblock_tpu/ops/csr_spmm_pallas.py``; the module keeps that
name so the pair is easy to find, but its kernel, K10, is CUDA C++ for
Hopper, in ``csrc/csr_spmm.cu``).

The plan keeps the JAX package's band layout, bit-equal, as the kernel's
input: the rows are cut into bands of R rows, and each band's nonzero
slice is padded with dummies (col 0, val 0) to a multiple of C, so that
no chunk of C slots straddles two bands. The port's packer adds
``row_ptr``: row r's nonzeros sit at row_ptr[r] .. row_ptr[r] + deg(r) - 1
of the padded arrays, deg(r) = indptr[r+1] - indptr[r]. The dummies lie
outside every row's span (as the lane-valid mask of K2 marks the lanes
that pad a window).

The TPU kernel turns the segmented sum into MXU work: per chunk it builds
the selector S[r, c] = val[c] * [local_row[c] == r] and adds S @ G to its
band, with G = X[cols] gathered beforehand by XLA. K10 needs neither: it
is a row split that gathers X's rows itself and sums in f32 FFMA, so no
(slots, F) gather is ever materialized (2.2 GB at ddi, F=256). The plan
cuts each row's span into segments of at most SEGMENT_NNZ slots
(``row_segments``), so that a row of 61,693 nonzeros (ddi keeps
duplicate edges) does not hold the card up; the segments of a split row
store partial rows, which a second pass adds in order. Where X is larger
than the card's L2, the kernel walks it in column strips whose width
``csr_strip_width`` picks, so that each strip's gathers hit L2.

precision="default" is the TPU kernel's single pass
(``jax.lax.Precision.DEFAULT``: the selector's values and the gathered
rows rounded to bf16, f32 products and sums): the plan holds its values
rounded to bf16 once, each call rounds the operand once, and K10's
one-bf16-pass kernel (``sdb_csr_spmm_bf16``, its own design for a bf16
operand) sums the same f32 products in the same order. It gathers 8
bf16 columns a lane in one 16-byte load and runs one task per (segment,
strip) over all of a strip's columns, several short segments to a warp,
on the equal strips of ``csr_bf16_strip_width``.

Beside it sits its plain PyTorch version on the same packed arrays
(``spmm_csr_segment_plain``): each slot adds val * X[col] into row
chunk_band * R + local_row, the TPU kernel's selector written as an
``index_add_``, in spans of at most 4 M slots. It sums in float64 and
rounds once to f32: a CSR row sums up to thousands of terms one by one,
and two f32 sums of them in different orders (the kernel's, and the
atomics' order of ``index_add_`` on the card) differ by more than the
kernel's own rounding. The wrapper alone chooses between them: it
runs the plain version for CPU tensors and where its caller passes
plain=True, and otherwise launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.ops import _kernels
from spmm_denseblock_tpu_torch.ops._device import (
    _device_of,
    _l2_bytes,
    check_arrays,
    resolve_device,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, grad_plan

# -- host packing (verbatim port, bit-equal to the JAX package) ------------


def _band_layout(csr: CSR, R: int, C: int):
    """Pad each R-row band's nonzero slice to a multiple of C.

    Returns (cols_pad, local_rows (n_chunks, 1, C), vals (n_chunks, 1,
    C), chunk_band (n_chunks,)), the JAX packer's arrays, and row_ptr
    (n_rows + 1,) int64: row r's span starts at row_ptr[r] =
    chunk_off[band] + indptr[r] - band_start[band] and holds deg(r)
    slots; row_ptr[n_rows] is the end of the last row's span. Empty
    bands get one all-dummy chunk, which no row's span reaches."""
    n = csr.n_rows
    n_bands = -(-n // R)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int32)
    vals = csr.values().astype(np.float32)
    rows = csr.row_ids().astype(np.int32)

    band_start = indptr[np.minimum(np.arange(n_bands) * R, n)]
    band_end = indptr[np.minimum(np.arange(1, n_bands + 1) * R, n)]
    band_nnz = band_end - band_start
    chunks_per_band = np.maximum(1, -(-band_nnz // C))
    n_chunks = int(chunks_per_band.sum())

    cols_pad = np.zeros(n_chunks * C, dtype=np.int32)
    lrows_pad = np.zeros(n_chunks * C, dtype=np.int32)
    vals_pad = np.zeros(n_chunks * C, dtype=np.float32)
    chunk_band = np.repeat(
        np.arange(n_bands, dtype=np.int32), chunks_per_band
    )
    chunk_off = np.concatenate([[0], np.cumsum(chunks_per_band)[:-1]]) * C
    for b in range(n_bands):
        s, e = band_start[b], band_end[b]
        o = chunk_off[b]
        cols_pad[o : o + (e - s)] = cols[s:e]
        lrows_pad[o : o + (e - s)] = rows[s:e] - b * R
        vals_pad[o : o + (e - s)] = vals[s:e]
    # port-side addition: each row's span in the padded arrays
    if n_bands == 0:
        row_ptr = np.zeros(n + 1, dtype=np.int64)
    else:
        band = np.minimum(np.arange(n + 1) // R, n_bands - 1)
        row_ptr = (chunk_off[band] + indptr - band_start[band]).astype(np.int64)
    return (
        cols_pad,
        lrows_pad.reshape(n_chunks, 1, C),
        vals_pad.reshape(n_chunks, 1, C),
        chunk_band,
        row_ptr,
    )


SEGMENT_NNZ = 512  # the kernel's longest walk: slots per segment
SEGMENT_BATCH = 32  # slots the kernels read a segment's pairs in


def row_segments(row_ptr, indptr, seg_nnz: int = SEGMENT_NNZ,
                 longest_first: bool = False):
    """The kernel's walk over row_ptr's spans: each row's span cut into
    segments of at most seg_nnz slots, an empty row one empty segment.

    Returns (seg_start, seg_end, seg_dest, split_row, part_ptr), int64:
    segment s walks slots seg_start[s] .. seg_end[s] - 1 and stores into
    row seg_dest[s] of C, or, for a row of several segments, into row
    -seg_dest[s] - 1 of the partial rows; split row h (split_row[h]) is
    the sum of partial rows part_ptr[h] .. part_ptr[h+1] - 1, in segment
    order. The segments come in row order, or with longest_first in
    order of their batches of SEGMENT_BATCH slots, most first and in row
    order among equals (the one-bf16-pass kernel's order: its long
    segments start first, and the short rows, most of a graph, keep
    their order and its locality). Each segment's sum is its own, so the
    order changes no bit of C."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    n_seg = np.maximum(1, -(-deg // seg_nnz))
    seg_row = np.repeat(np.arange(deg.size), n_seg)
    first = np.concatenate([[0], np.cumsum(n_seg)[:-1]]).astype(np.int64)
    rank = np.arange(seg_row.size) - first[seg_row]
    seg_start = row_ptr[:-1][seg_row] + rank * seg_nnz
    seg_end = np.minimum(seg_start + seg_nnz, row_ptr[:-1][seg_row] + deg[seg_row])
    split = n_seg > 1
    seg_dest = seg_row.astype(np.int64)
    in_split = split[seg_row]
    seg_dest[in_split] = -1 - np.arange(int(in_split.sum()))
    split_row = np.nonzero(split)[0].astype(np.int64)
    part_ptr = np.concatenate([[0], np.cumsum(n_seg[split])]).astype(np.int64)
    if longest_first:
        batches = -(-(seg_end - seg_start) // SEGMENT_BATCH)
        order = np.argsort(-batches, kind="stable")
        seg_start, seg_end, seg_dest = seg_start[order], seg_end[order], seg_dest[order]
    return seg_start, seg_end, seg_dest, split_row, part_ptr


# -- the kernel's strip width ------------------------------------------------

CSR_STRIP_UNIT = 32    # columns of the strip walk's tile (8 lanes x float4)
CSR_L2_SHARE = 0.7     # of the L2 a strip of X may fill
CSR_BF16_L2_SHARE = 0.85  # of the L2 a bf16 strip of X may fill
CSR_BF16_UNIT = 8      # a bf16 strip: a multiple of one 16-byte load's columns
CSR_BF16_MAX_STRIP = 256  # and at most a warp's 32 lanes of them


def csr_strip_width(K: int, F: int, l2_bytes: int) -> int:
    """f32 K10's strip width W for a (K, F) f32 operand on a card with
    l2_bytes of L2: the widest multiple of CSR_STRIP_UNIT whose (K, W)
    slice of X fills at most CSR_L2_SHARE of the L2 (one unit if none
    does), capped at F. The rest of the L2 is left to the streamed (col,
    val) pairs and the output. W == F walks all of F as one strip."""
    fit = int(CSR_L2_SHARE * l2_bytes) // max(1, 4 * K)
    return min(F, max(CSR_STRIP_UNIT, fit // CSR_STRIP_UNIT * CSR_STRIP_UNIT))


def csr_bf16_strip_width(K: int, F: int, l2_bytes: int) -> int:
    """The one-bf16-pass kernel's strip width W for a (K, F) bf16 operand
    on a card with l2_bytes of L2: F cut into the fewest strips that are
    at most CSR_BF16_MAX_STRIP columns wide and whose (K, W) bf16 slice of
    X fills at most CSR_BF16_L2_SHARE of the L2 (one unit wide if none
    does), made equal and rounded up to a multiple of CSR_BF16_UNIT, so
    the last strip may be narrower by less than a unit per strip: 4 x 128
    at F = 512 over 2^17 rows. The share is f32's 0.7 raised to 0.85: on
    an H100 one strip of the arxiv serve graph (its bf16 X is 83% of the
    L2) took 0.78x the time of two (64 + 64), and one strip won under each
    of four orderings (scripts/torch_csr_bf16_probe.py). W == F walks all
    of F as one strip."""
    return equal_strip_width(K, F, l2_bytes, 2, CSR_BF16_L2_SHARE, CSR_BF16_UNIT,
                             CSR_BF16_MAX_STRIP)


def equal_strip_width(K: int, F: int, l2_bytes: int, itemsize: int, share: float,
                      unit: int, max_strip: int) -> int:
    """F cut into the fewest strips that are at most max_strip columns
    wide and whose (K, W) slice of X (itemsize bytes an element) fills at
    most `share` of the L2 (one unit wide if none does), made equal and
    rounded up to a multiple of unit. W == F walks all of F as one
    strip."""
    fit = int(share * l2_bytes) // max(1, itemsize * K)
    widest = max(unit, min(max_strip, fit // unit * unit))
    n_strips = -(-F // widest)
    if n_strips <= 1:
        return F
    return -(-F // (n_strips * unit)) * unit


# -- the plain PyTorch version and the kernel wrapper ----------------------

_PLAIN_SPAN_SLOTS = 1 << 22  # padded slots per span of the plain version
_PLAIN_SPAN_ELEMS = 1 << 27  # and gathered operand elements per span


def spmm_csr_segment_plain(cols_pad, local_rows, vals, chunk_band, row_ptr,
                           seg_start, seg_end, seg_dest, split_row, part_ptr,
                           dense, R: int, n_partials: int) -> torch.Tensor:
    """Plain version of K10 on the band layout, as ``_seg_kernel``
    computes it: slot s of chunk k adds vals[s] * dense[cols_pad[s]] into
    row chunk_band[k] * R + local_rows[s]; a dummy adds 0 into its
    band's first row. Products and sums in float64 (exact products of
    f32 or bf16 values), rounded once to f32. row_ptr gives the row count only;
    it and the segment arrays (row_segments) are the kernel's walk, not
    read here. Chunked over slots to bound the gathered operand's
    memory. Returns (n_rows, F) f32."""
    n_rows = row_ptr.shape[0] - 1
    F = dense.shape[1]
    out = torch.zeros(n_rows, F, dtype=torch.float64, device=dense.device)
    if dense.shape[0] == 0:  # no columns: every slot is a dummy
        return out.float()
    C = local_rows.shape[-1]
    cols, lrows, v = (a.reshape(-1) for a in (cols_pad, local_rows, vals))
    band = chunk_band.long()
    span = max(1, min(_PLAIN_SPAN_SLOTS, _PLAIN_SPAN_ELEMS // max(1, F)))
    for s0 in range(0, cols.shape[0], span):
        s1 = min(cols.shape[0], s0 + span)
        slot = torch.arange(s0, s1, device=dense.device)
        dest = band[slot // C] * R + lrows[s0:s1].long()
        prod = dense[cols[s0:s1].long()].double() * v[s0:s1, None].double()
        out.index_add_(0, dest, prod)
    return out.float()


def spmm_csr_segment(cols_pad, local_rows, vals, chunk_band, row_ptr,
                     seg_start, seg_end, seg_dest, split_row, part_ptr,
                     dense, R: int, n_partials: int, plain: bool = False) -> torch.Tensor:
    """K10: C (n_rows, F) f32 = A @ dense on the band layout. The kernel
    walks the segments of row_ptr's spans (row_segments) over cols_pad
    and vals, n_partials = part_ptr[-1] partial rows for the split rows
    (local_rows and chunk_band are the plain version's). vals and dense
    are both f32 (sdb_csr_spmm, in strips of csr_strip_width's width) or
    both bf16 (one bf16 pass, sdb_csr_spmm_bf16, in strips of
    csr_bf16_strip_width's). CPU tensors, and any with plain=True, run
    spmm_csr_segment_plain; CUDA tensors run the CUDA kernel."""
    seg = (seg_start, seg_end, seg_dest, split_row, part_ptr)
    dev = _device_of(cols_pad, local_rows, vals, chunk_band, row_ptr, *seg,
                     dense)
    if plain or dev.type == "cpu":
        return spmm_csr_segment_plain(cols_pad, local_rows, vals, chunk_band,
                                      row_ptr, *seg, dense, R, n_partials)
    check_csr_operands(cols_pad, vals, seg, dense)
    n_rows = row_ptr.shape[0] - 1
    F = dense.shape[1]
    out = torch.empty(n_rows, F, dtype=torch.float32, device=dev)
    partial = torch.empty(n_partials, F, dtype=torch.float32, device=dev)
    if dense.dtype == torch.bfloat16:
        W = csr_bf16_strip_width(dense.shape[0], F, _l2_bytes(dev.index))
        kernel = _kernels.csr_spmm_bf16
    else:
        W = csr_strip_width(dense.shape[0], F, _l2_bytes(dev.index))
        kernel = _kernels.csr_spmm
    with torch.cuda.device(dev):
        kernel(
            seg_start.data_ptr(), seg_end.data_ptr(), seg_dest.data_ptr(),
            cols_pad.data_ptr(), vals.data_ptr(), dense.data_ptr(),
            out.data_ptr(), partial.data_ptr(), split_row.data_ptr(),
            part_ptr.data_ptr(), seg_start.shape[0], split_row.shape[0], F, W,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    return out


def check_csr_operands(cols_pad, vals, seg, dense) -> None:
    """What the CUDA kernel takes: a (K, F) operand and vals both f32 or
    both bf16, int32 cols of vals' length, the int64 segment arrays of
    row_segments, all contiguous."""
    if dense.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense must be float32 or bfloat16, got dtype {dense.dtype}")
    check_arrays([("cols_pad", cols_pad, torch.int32), ("vals", vals, dense.dtype),
                  ("dense", dense, dense.dtype)]
                 + [(n, t, torch.int64) for n, t in zip(
                     ("seg_start", "seg_end", "seg_dest", "split_row", "part_ptr"), seg)])
    if dense.dim() != 2:
        raise ValueError(f"dense must be (K, F), got {tuple(dense.shape)}")
    if cols_pad.numel() != vals.numel():
        raise ValueError("cols_pad and vals must hold the same slots")
    seg_start, seg_end, seg_dest, split_row, part_ptr = seg
    if not (seg_start.shape == seg_end.shape == seg_dest.shape
            and part_ptr.shape[0] == split_row.shape[0] + 1):
        raise ValueError("segment arrays of unequal lengths")


# -- the plan ---------------------------------------------------------------


def _values_dtype(precision) -> torch.dtype:
    """The type the plan holds its values in, which is the type its
    kernel reads the operand in: f32 for None and "highest" (exact f32,
    as JAX's HIGHEST), bf16 for "default" (one bf16 pass)."""
    if precision in (None, "highest"):
        return torch.float32
    if precision == "default":
        return torch.bfloat16
    raise ValueError(f"unknown precision {precision!r} (None, 'default' or 'highest')")


def csr_spmm_pallas_plan(
    csr: CSR,
    f_tile: Optional[int] = None,
    chunk: int = 1024,
    row_band: int = 256,
    precision: Optional[str] = "highest",
    grad: bool = True,
    device=None,
) -> Plan:
    """Host layout prep once -> Plan computing C = A @ dense in f32.

    chunk (C) and row_band (R) shape the band layout as in the JAX plan;
    K10's answer does not depend on them, nor on f_tile, which is taken
    for the JAX plan's signature and changes nothing. precision: None or
    "highest" (exact f32: the operand is cast to f32), or "default" (one
    bf16 pass: the values rounded to bf16 here, the operand at each
    call, f32 products and sums). grad=True (the default) returns a
    grad_plan whose backward runs a plan of Aᵀ built with the same
    arguments. device: where the packed arrays live, None for the card.
    Work figures (``ops/plan``): nnz and positions both the nonzeros."""
    device = resolve_device(device)
    vals_dtype = _values_dtype(precision)
    if grad:
        kw = dict(f_tile=f_tile, chunk=chunk, row_band=row_band,
                  precision=precision, device=device)
        return grad_plan(csr_spmm_pallas_plan(csr, grad=False, **kw),
                         csr_spmm_pallas_plan(csr.transpose(), grad=False, **kw))
    n_rows, n_cols = (int(s) for s in csr.shape)
    band = list(_band_layout(csr, row_band, chunk))
    band[2] = torch.as_tensor(band[2], device=device).to(vals_dtype)
    segments = row_segments(band[4], csr.indptr,
                            longest_first=vals_dtype == torch.bfloat16)
    statics = (n_rows, n_cols, row_band, f_tile, int(segments[4][-1]))
    return Plan((*band, *segments), _csr_pallas_apply, statics, device=device,
                name="csr_pallas", nnz=csr.nnz, positions=csr.nnz)


def _csr_pallas_apply(statics, arrays, dense, plain: bool = False):
    n_rows, n_cols, R, _, n_partials = statics
    vals = arrays[2]
    dense = torch.as_tensor(dense, device=vals.device)
    if dense.dim() != 2 or dense.shape[0] != n_cols:
        raise ValueError(f"dense must be ({n_cols}, F), got {tuple(dense.shape)}")
    # the operand in the values' type: a "default" plan rounds it here, once
    dense = dense.to(vals.dtype).contiguous()
    return spmm_csr_segment(*arrays, dense, R, n_partials, plain=plain)


def csr_spmm_pallas(csr: CSR, dense, **kw) -> torch.Tensor:
    return csr_spmm_pallas_plan(csr, **kw)(dense)
