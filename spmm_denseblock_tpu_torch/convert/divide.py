"""The hybrid splitter (twin of ``spmm_denseblock_tpu/convert/divide.py``,
bit-equal on the same input): dense b x b blocks at or above a density
threshold go to a BSR part, every other nonzero stays in a remainder
CSR (the reference's divide_matrix, divide.cu:52-127, as one vectorized
pass over the COO view), with the JAX package's threshold selection.

The cost models here (``auto_threshold``'s dense speed-up,
``score_thresholds``' slots per block) are the JAX package's TPU v5e
fits, copied as they are. The router prices a plan that runs the card's
f32 kernels by those kernels instead (``ops/dispatch.py``), on the same
block counts (``block_counts``).
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.analyze.metrics import fill_histogram
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid


def divide(csr: CSR, block_size: int, density: float) -> Hybrid:
    """Blocks with count / b^2 >= density (the reference's gate,
    divide.cu:93) form the BSR part, the rest the remainder; duplicate
    coordinates add inside a block as they do in the reference."""
    b = block_size
    n_rows, n_cols = csr.shape
    nbc = -(-n_cols // b)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    bkey = (rows // b) * nbc + (cols // b)
    uniq, inv, counts = np.unique(bkey, return_inverse=True, return_counts=True)
    dense_mask_per_block = counts.astype(np.float64) / (b * b) >= density
    dense_mask = dense_mask_per_block[inv]

    dense_keys = uniq[dense_mask_per_block]
    if dense_keys.shape[0] > 0:
        remap = np.searchsorted(dense_keys, bkey[dense_mask])
        blocks = np.zeros((dense_keys.shape[0], b, b), dtype=np.float32)
        np.add.at(
            blocks,
            (remap, rows[dense_mask] % b, cols[dense_mask] % b),
            vals[dense_mask],
        )
        bsr = BSR.from_parts(
            (dense_keys // nbc).astype(np.int32),
            (dense_keys % nbc).astype(np.int32),
            blocks,
            csr.shape,
            b,
        )
    else:
        bsr = BSR.from_parts(
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros((0, b, b), np.float32),
            csr.shape,
            b,
        )

    rem = ~dense_mask
    remainder = CSR.from_coo(rows[rem], cols[rem], vals[rem], csr.shape)
    return Hybrid(dense=bsr, remainder=remainder, shape=csr.shape)


def auto_threshold(csr: CSR, block_size: int, dense_speedup: float = 4.0) -> float:
    """A density threshold for divide(): a block at occupancy >=
    1 / dense_speedup is cheaper dense, in a model where the dense path
    runs dense_speedup times faster per element than the gather path.
    Returns that break-even, or 1.0 (everything to the remainder) when no
    block of the 10-bucket fill histogram reaches it."""
    breakeven = 1.0 / dense_speedup
    hist = fill_histogram(csr, block_size)
    occupied = np.nonzero(hist)[0]
    if occupied.size == 0:
        return 1.0
    densest_edge = occupied[-1] / hist.shape[0]
    if densest_edge < breakeven:
        return 1.0  # nothing qualifies: pure CSR
    return float(breakeven)


def ell_padded_slots(degrees: np.ndarray, bucket: str = "quarter") -> int:
    """The gather slots of the ELL tier (ops/csr_spmm_ell.py) for rows of
    these degrees: the sum of the nonempty rows' ELL widths under
    `bucket`, the scheme of the plan that runs the remainder."""
    # imported here: the ops package's router imports this module
    from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import _row_widths

    deg = np.asarray(degrees, dtype=np.int64)
    K = _row_widths(deg, bucket)
    return int(K[deg > 0].sum())


def block_counts(csr: CSR, block_size: int):
    """The threshold scorers' one expensive pass: (rows, uniq, inv,
    counts) of the b x b blocks that csr's nonzeros fall in, keyed
    block_row * n_block_cols + block_col: each nonzero's row, the
    occupied blocks' sorted keys, each nonzero's block and each block's
    count."""
    b = block_size
    nbc = -(-csr.n_cols // b)
    rows = csr.row_ids().astype(np.int64)
    bkey = (rows // b) * nbc + (np.asarray(csr.indices, np.int64) // b)
    uniq, inv, counts = np.unique(bkey, return_inverse=True, return_counts=True)
    return rows, uniq, inv, counts


def score_thresholds(
    csr: CSR,
    block_size: int,
    candidates=(0.02, 0.03, 0.05),
    slots_per_block: float = 400.0,
    dense_bytes_budget: int = 2 << 30,
    dtype_bytes: int = 4,
    margin: float = 0.02,
):
    """Threshold selection for divide() by a cost model:
        score(thr) = slots_per_block * dense_nnzb(thr)
                     + ell_padded_slots(remainder(thr)),
    so a dense block pays for itself when it drains at least
    slots_per_block padded ELL slots from the remainder. Pure ELL (None)
    is scored first, so a tie keeps no dense part.

    Returns (best threshold or None, report): one dict per candidate
    (thr, nnzb, padded_slots and score, or score None with the reason
    when its dense part exceeds dense_bytes_budget). None when no
    candidate beats pure ELL's score by more than `margin`."""
    b = block_size
    n_rows = csr.n_rows
    rows, uniq, inv, counts = block_counts(csr, b)
    occupancy = counts.astype(np.float64) / (b * b)
    block_bytes = b * b * dtype_bytes

    report = []
    best_thr, best_score = None, float("inf")
    for thr in [None] + sorted(set(candidates)):
        if thr is None:
            dense_mask_blk = np.zeros(uniq.shape[0], dtype=bool)
        else:
            dense_mask_blk = occupancy >= thr
        nnzb = int(dense_mask_blk.sum())
        if nnzb * block_bytes > dense_bytes_budget:
            report.append({"thr": thr, "nnzb": nnzb, "score": None,
                           "reason": "over dense-bytes budget"})
            continue
        rem_rows = rows[~dense_mask_blk[inv]]
        rem_deg = np.bincount(rem_rows, minlength=n_rows)
        slots = ell_padded_slots(rem_deg)
        score = slots_per_block * nnzb + slots
        report.append({"thr": thr, "nnzb": nnzb, "padded_slots": slots,
                       "score": float(score)})
        if score < best_score:
            best_thr, best_score = thr, score
        if thr is None:
            ell_score = score
    if best_thr is not None and best_score > ell_score * (1.0 - margin):
        best_thr = None
    return best_thr, report
