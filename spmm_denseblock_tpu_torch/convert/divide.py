"""The hybrid splitter (twin of ``spmm_denseblock_tpu/convert/divide.py``,
bit-equal on the same input): dense b x b blocks at or above a density
threshold go to a BSR part, every other nonzero stays in a remainder
CSR (the reference's divide_matrix, divide.cu:52-127, as one vectorized
pass over the COO view), with the JAX package's threshold selection.

The cost models here (``auto_threshold``'s dense speed-up,
``score_thresholds``' slots per block) are the JAX package's TPU v5e
fits, copied as they are. ``score_thresholds`` also prices by the card's
f32 kernels (``KernelPrices``), which the router uses where a plan will
run them.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class KernelPrices:
    """What an f32 plan costs on the card, in ns at operand width
    feat_dim. The ELL kernel (sdb_ell_spmm) reads each stored entry once
    and no pad, and does some work a row. The hybrid's dense part runs
    K1 (K2 on rows of >= 8 blocks) over its walked slots, covering zero
    blocks included: the walk's throughput, or its deepest lane, whose
    slots one CTA multiplies one after another on a tile of at most
    LANE_COLUMNS columns, whichever takes longer. A hybrid call adds the
    pad of the operand to the block grid and the sum of its two parts,
    priced by their bytes."""

    LANE_COLUMNS = 128  # K1's widest column tile

    ns_per_entry: float  # the ELL kernel: a stored entry, an operand column
    ns_per_row: float  # the ELL kernel: a row, an operand column
    ns_per_block_mac: float  # K1's walk: a slot's b² multiply-adds, a column
    ns_per_lane_mac: float  # K1's deepest lane: a slot's multiply-adds, a column
    ns_per_hybrid_byte: float  # the pad's and the sum's bytes
    feat_dim: int

    def ell(self, nnz: int, n_rows: int) -> float:
        return (self.ns_per_entry * nnz + self.ns_per_row * n_rows) * self.feat_dim

    def hybrid(self, rem_nnz: int, walked: int, depth: int, b: int, n_rows: int,
               n_cols: int) -> float:
        """The remainder's ELL, K1 over `walked` slots of b x b whose
        deepest lane holds `depth`, the pad (a copy of the operand to the
        block grid, when it is not on it) and the sum (two parts read,
        one written)."""
        F = self.feat_dim
        dense = max(self.ns_per_block_mac * b * b * walked * F,
                    self.ns_per_lane_mac * b * b * depth * min(F, self.LANE_COLUMNS))
        k_needed = -(-n_cols // b) * b
        pad_bytes = 4 * F * (n_cols + k_needed) if k_needed > n_cols else 0
        sum_bytes = 12 * F * n_rows if rem_nnz else 0  # no remainder: no sum
        return (self.ell(rem_nnz, n_rows) + dense
                + self.ns_per_hybrid_byte * (pad_bytes + sum_bytes))


def score_thresholds(
    csr: CSR,
    block_size: int,
    candidates=(0.02, 0.03, 0.05),
    slots_per_block: float = 400.0,
    dense_bytes_budget: int = 2 << 30,
    dtype_bytes: int = 4,
    margin: float = 0.02,
    prices: KernelPrices = None,
):
    """Threshold selection for divide() by a cost model. Padded pricing
    (prices None, the JAX package's):
        score(thr) = slots_per_block * dense_nnzb(thr)
                     + ell_padded_slots(remainder(thr)),
    so a dense block pays for itself when it drains at least
    slots_per_block padded ELL slots from the remainder. Kernel pricing
    (prices given): score(thr) is the ns of the f32 kernels' call,
    prices.hybrid over the remainder's stored entries and the dense
    part's walk (f32_walk), prices.ell for pure ELL.
    Pure ELL (None) is scored first, so a tie keeps no dense part.

    Returns (best threshold or None, report): one dict per candidate
    (thr, nnzb, padded_slots, or with prices walked_slots, depth and
    remainder_nnz, and score; or score None with the reason when its
    dense part exceeds dense_bytes_budget). None when no candidate beats
    pure ELL's score by more than `margin`."""
    # imported here: the ops package's router imports this module
    from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import f32_walk

    b = block_size
    n_rows, n_cols = csr.shape
    nbc = -(-n_cols // b)
    rows = csr.row_ids().astype(np.int64)
    bkey = (rows // b) * nbc + (np.asarray(csr.indices, np.int64) // b)
    uniq, inv, counts = np.unique(bkey, return_inverse=True, return_counts=True)
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
        if prices is None:
            rem_rows = rows[~dense_mask_blk[inv]]
            rem_deg = np.bincount(rem_rows, minlength=n_rows)
            slots = ell_padded_slots(rem_deg)
            score = slots_per_block * nnzb + slots
            report.append({"thr": thr, "nnzb": nnzb, "padded_slots": slots,
                           "score": float(score)})
        else:
            rem_nnz = csr.nnz - int(counts[dense_mask_blk].sum())
            if nnzb == 0:
                walked = depth = 0
                score = prices.ell(rem_nnz, n_rows)
            else:
                walked, depth = f32_walk(uniq[dense_mask_blk] // nbc, -(-n_rows // b))
                score = prices.hybrid(rem_nnz, walked, depth, b, n_rows, n_cols)
            report.append({"thr": thr, "nnzb": nnzb, "walked_slots": walked,
                           "depth": depth, "remainder_nnz": rem_nnz,
                           "score": float(score)})
        if score < best_score:
            best_thr, best_score = thr, score
        if thr is None:
            ell_score = score
    if best_thr is not None and best_score > ell_score * (1.0 - margin):
        best_thr = None
    return best_thr, report
