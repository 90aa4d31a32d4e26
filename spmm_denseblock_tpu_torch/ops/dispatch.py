"""The user-facing ``spmm_plan`` entry point (twin of
``spmm_denseblock_tpu/ops/dispatch.py``).

    plan = spmm_plan(matrix, impl="auto", feat_dim=128, grad=False)  # on the card
    C = plan(B)

Plans go to the card unless the caller passes ``device="cpu"`` (or
another device); with no GPU and no device given, spmm_plan raises
RuntimeError.

The impl names are the JAX package's, so one call line works on both,
and ``impl="auto"`` takes the JAX router's steps: Windowed and Hybrid
inputs run their tiers; a BSR input of b < 32 is repacked to 128 when
the small-b score says so; the BSR tier by operand width (feat_dim 256)
and block size; then, for a CSR input, the fill guard (32x zero fill
within the byte budget gives csr_ell) and, over the budget, the
threshold scorer (a dense part worth its blocks gives hybrid, else
csr_ell). ``dtype=int8`` maps the chosen tier, picked by "auto" or
named, to its quantized variant, and "auto"'s ELL and hybrid tiers get
compact="auto". Every constant of these steps is a TPU v5e fit of the
JAX package, copied as it is, but for the scorer's prices on the card:
a plan that will run the f32 kernels there (device CUDA, operand f32)
is priced by what they walk ("kernel" pricing: the ELL kernel's stored
entries and rows, K1's walk and deepest lane, the hybrid's pad and sum,
in ns), every
other plan by the JAX package's padded slots ("padded" pricing, so its
route is JAX's). Where the scorer's hybrid and pure-ELL
scores lie within 15% of each other and the caller passed
``tune_with=`` (a representative operand), "auto" measures the two
finalists with ``spmm_tune`` instead. ``operand_layout="col"`` gives a
plan that takes the operand transposed, (F, K).

    plan, report = spmm_tune(matrix, X, candidates=("bsr_pallas", "csr_pallas"))

times each candidate on X (CUDA events on the card) and returns the
fastest plan and every candidate's ms or error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from spmm_denseblock_tpu_torch.analyze.metrics import calculate_nnzb
from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr, csr_to_bsr
from spmm_denseblock_tpu_torch.convert.divide import (
    auto_threshold,
    block_counts,
    divide,
    score_thresholds,
)
from spmm_denseblock_tpu_torch.convert.pack import repack_bsr
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.formats.windowed import Windowed, divide_windowed
from spmm_denseblock_tpu_torch.ops._device import resolve_device, runs_f32_kernels
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import bsr_spmm_int8_plan, dtype_name
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    MAX_BN,
    bsr_spmm_pallas_plan,
    f32_walk,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import bsr_spmm_pallas_int8_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm import bcoo_spmm_plan, csr_spmm_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (
    SCAN_MIN_SOURCE_ROWS,
    csr_spmm_ell_banded_plan,
    csr_spmm_ell_int8_plan,
    csr_spmm_ell_plan,
)
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import csr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.ops.hybrid_spmm import (
    hybrid_spmm_int8_plan,
    hybrid_spmm_plan,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, transb_plan
from spmm_denseblock_tpu_torch.ops.reference import spmm_dense_torch
from spmm_denseblock_tpu_torch.ops.windowed_spmm import (
    tiered_spmm_plan,
    windowed_spmm_int8_plan,
    windowed_spmm_plan,
)
from spmm_denseblock_tpu_torch.utils import profiling

# dtype=int8 maps a tier to its quantized variant (inference only)
_INT8_VARIANT = {
    "bsr_pallas": "bsr_int8_pallas",
    "bsr_xla": "bsr_int8",
    "csr_ell": "csr_ell_int8",
    "hybrid": "hybrid_int8",
    "windowed": "windowed_int8",
}
# the tiers whose ELL layout takes compact= and feat_dim= from the router
_ELL_TIERS = ("csr_ell", "csr_ell_int8", "hybrid", "hybrid_int8")
# the router's explicit-hybrid threshold candidates, besides auto_threshold
_THRESHOLDS = (0.015, 0.02, 0.03, 0.05)
# the tier whose plans take A's values with each call (values="call")
CALL_VALUE_TIER = "csr_ell"

# -- the scored branch's prices: two sets, by route_pricing
# padded pricing, the JAX package's TPU v5e fit, for every plan that walks
# padded ELL slots through torch ops (the CPU, bf16, int8): a dense block is
# worth PADDED_SLOTS_PER_BLOCK slots, or PADDED_SLOTS_PER_BLOCK_BIG_TABLE on
# a source of SCAN_MIN_SOURCE_ROWS rows or more
PADDED_SLOTS_PER_BLOCK = 400.0
PADDED_SLOTS_PER_BLOCK_BIG_TABLE = 4000.0
# kernel pricing, an f32 plan on the card (KernelPrices, ns an operand
# column): the ELL kernel a stored entry and a row, K1 a multiply-add of
# its walk and of its deepest lane, the hybrid's pad and sum a byte. Fitted
# by scripts/torch_route_probe.py on the arxiv benchmark graph (gorder,
# 2,492,379 nonzeros; H100 80GB HBM3, 700 W), F = 128 and 256 averaged:
# csr_ell 0.2689 / 0.5135 ms, predicted 0.2638 / 0.5275; the hybrid at
# the scored thresholds 0.6020-0.7423 / 1.1137-1.1844 ms, predicted
# 0.5839-0.6833 / 1.1673-1.2069; at 0.002 (a lane 1,220 slots deep)
# 16.23 / 17.02, predicted 17.67 / 18.06
KERNEL_NS_PER_ENTRY = 3.58e-4
KERNEL_NS_PER_ROW = 6.9e-3
KERNEL_NS_PER_BLOCK_MAC = 5.9e-5
KERNEL_NS_PER_LANE_MAC = 6.75e-3
KERNEL_NS_PER_HYBRID_BYTE = 4.07e-4


@dataclass(frozen=True)
class KernelPrices:
    """What an f32 plan costs on the card, in ns at operand width
    feat_dim. The ELL kernel (sdb_ell_spmm) reads each stored entry once
    and no pad, and does some work a row. The hybrid's dense part runs
    K1 (K2 on rows of >= 8 blocks) over its walked slots, covering zero
    blocks included: the walk's throughput, or its deepest lane, whose
    slots one CTA multiplies one after another on a tile of at most
    MAX_BN columns, whichever takes longer. A hybrid call adds the pad
    of the operand to the block grid and the sum of its two parts,
    priced by their bytes."""

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
                    self.ns_per_lane_mac * b * b * depth * min(F, MAX_BN))
        k_needed = -(-n_cols // b) * b
        pad_bytes = 4 * F * (n_cols + k_needed) if k_needed > n_cols else 0
        sum_bytes = 12 * F * n_rows if rem_nnz else 0  # no remainder: no sum
        return (self.ell(rem_nnz, n_rows) + dense
                + self.ns_per_hybrid_byte * (pad_bytes + sum_bytes))


def _dense_apply(statics, arrays, dense, plain: bool = False):
    # one torch matmul: plain=True runs the same op
    (a,) = arrays
    return spmm_dense_torch(a, torch.as_tensor(dense, device=a.device))


def _dense_plan(mat, device=None, **kw):
    # work figures (ops/plan): A's nonzero entries; every entry's product
    a = mat.to_dense()
    return Plan((a,), _dense_apply, device=resolve_device(device), name="dense",
                nnz=np.count_nonzero(a), positions=a.size)


def _as_csr(m) -> CSR:
    if isinstance(m, CSR):
        return m
    if isinstance(m, BSR):
        return bsr_to_csr(m)
    raise TypeError(f"cannot route {type(m).__name__} to a CSR-tier impl")


PLANNERS: Dict[str, Callable] = {
    # CSR tier; csr_xla and bcoo take no other arguments, as in JAX
    "csr_xla": lambda m, device=None, **kw: csr_spmm_plan(_as_csr(m), device=device),
    "csr_pallas": lambda m, **kw: csr_spmm_pallas_plan(_as_csr(m), **kw),
    "csr_ell": lambda m, **kw: csr_spmm_ell_plan(_as_csr(m), **kw),
    "csr_ell_int8": lambda m, **kw: csr_spmm_ell_int8_plan(_as_csr(m), **kw),
    "csr_ell_banded": lambda m, **kw: csr_spmm_ell_banded_plan(_as_csr(m), **kw),
    "bcoo": lambda m, device=None, **kw: bcoo_spmm_plan(_as_csr(m), device=device),
    # BSR tier
    "bsr_pallas": lambda m, **kw: bsr_spmm_pallas_plan(m, **kw),
    "bsr_xla": lambda m, **kw: bsr_spmm_xla_plan(m, **kw),
    "bsr_int8": lambda m, **kw: bsr_spmm_int8_plan(m, **kw),
    "bsr_int8_pallas": lambda m, **kw: bsr_spmm_pallas_int8_plan(m, **kw),
    # composite tiers
    "hybrid": lambda m, **kw: hybrid_spmm_plan(m, **kw),
    "hybrid_int8": lambda m, **kw: hybrid_spmm_int8_plan(m, **kw),
    "windowed": lambda m, **kw: windowed_spmm_plan(m, **kw),
    "windowed_int8": lambda m, **kw: windowed_spmm_int8_plan(m, **kw),
    "tiered": lambda m, **kw: tiered_spmm_plan(m, **kw),
    # oracle
    "dense": _dense_plan,
}


def _prefer_repack128(bsr: BSR) -> bool:
    """The JAX router's small-b score: repack to 128-wide supertiles when
    the supertile path's modelled bytes beat the direct path's."""
    b = bsr.block_size
    g = 128 // b
    srow = np.asarray(bsr.block_rows[: bsr.nnzb], np.int64) // g
    scol = np.asarray(bsr.block_cols[: bsr.nnzb], np.int64) // g
    n_sup = np.unique(srow * (-(-bsr.n_block_cols // g)) + scol).size
    direct_cost = bsr.nnzb * b * 2 / min(230.0, 30.0 * b)
    repack_cost = n_sup * 128 / 420.0
    return repack_cost < direct_cost


def _itemsize(dtype) -> int:
    """Bytes of an operand element of `dtype` (None: f32)."""
    return 4 if dtype is None else getattr(torch, dtype_name(dtype)).itemsize


def route_pricing(device, dtype) -> str:
    """How "auto"'s scorer prices a plan on `device` (None: the card, as
    spmm_plan takes it) in `dtype`: "kernel" where the plan runs the f32
    kernels (runs_f32_kernels), else "padded"."""
    return "kernel" if runs_f32_kernels(device, _itemsize(dtype)) else "padded"


def _score_by_kernels(csr: CSR, block_size: int, candidates, feat_dim,
                      dense_bytes_budget: int, margin: float = 0.02):
    """score_thresholds at kernel pricing: score(thr) is the ns of the f32
    kernels' call at the plan's operand width (None: 256), KernelPrices.ell
    for pure ELL, .hybrid over the remainder's stored entries and the
    dense part's walk (f32_walk); the report gives walked_slots, depth
    and remainder_nnz in place of padded_slots."""
    prices = KernelPrices(KERNEL_NS_PER_ENTRY, KERNEL_NS_PER_ROW, KERNEL_NS_PER_BLOCK_MAC,
                          KERNEL_NS_PER_LANE_MAC, KERNEL_NS_PER_HYBRID_BYTE,
                          feat_dim=256 if feat_dim is None else feat_dim)
    b = block_size
    n_rows, n_cols = csr.shape
    _, uniq, _, counts = block_counts(csr, b)
    block_rows = uniq // -(-n_cols // b)
    occupancy = counts.astype(np.float64) / (b * b)
    report = []
    best_thr, best_score = None, float("inf")
    for thr in [None] + sorted(set(candidates)):
        dense = np.zeros(uniq.shape[0], bool) if thr is None else occupancy >= thr
        nnzb = int(dense.sum())
        if nnzb * b * b * 4 > dense_bytes_budget:  # f32 blocks
            report.append({"thr": thr, "nnzb": nnzb, "score": None,
                           "reason": "over dense-bytes budget"})
            continue
        rem_nnz = csr.nnz - int(counts[dense].sum())
        walked, depth = f32_walk(block_rows[dense], -(-n_rows // b)) if nnzb else (0, 0)
        score = (prices.hybrid(rem_nnz, walked, depth, b, n_rows, n_cols) if nnzb
                 else prices.ell(rem_nnz, n_rows))
        report.append({"thr": thr, "nnzb": nnzb, "walked_slots": walked,
                       "depth": depth, "remainder_nnz": rem_nnz, "score": float(score)})
        if score < best_score:
            best_thr, best_score = thr, score
    if best_thr is not None and best_score > report[0]["score"] * (1.0 - margin):
        best_thr = None
    return best_thr, report


def _route_costs(report, thr) -> dict:
    """The scorer's predicted cost of its pick (the hybrid at `thr`, or
    pure ELL for None) and of the cheapest other candidate (None if
    none), in the pricing's unit: ns (kernel) or padded slots."""
    scores = {r["thr"]: r["score"] for r in report if r.get("score") is not None}
    others = [v for t, v in scores.items() if t != thr]
    return {"cost": scores.get(thr), "runner_up_cost": min(others, default=None)}


def _explicit_hybrid(matrix: CSR, impl: str, block_size: int, kw: dict) -> Hybrid:
    """impl="hybrid"/"hybrid_int8" on a CSR input: divide at
    density_threshold=, else at the scorer's pick with margin 0 (the
    caller asked for a hybrid), else at auto_threshold."""
    thr = kw.pop("density_threshold", None)
    if thr is None:
        # hybrid_int8 gathers a 1-byte table: score the bytes the plan moves
        dtype_bytes = 1 if impl == "hybrid_int8" else _itemsize(kw.get("dtype"))
        thr, _ = score_thresholds(
            matrix, block_size,
            candidates={*_THRESHOLDS, auto_threshold(matrix, block_size)},
            margin=0.0, dtype_bytes=dtype_bytes,
        )
        if thr is None:  # nothing qualifies: the densest blocks only
            thr = auto_threshold(matrix, block_size)
    return divide(matrix, block_size, thr)


def _thin_margin_finalists(report):
    """The two candidates "auto" measures when score_thresholds' best
    hybrid and pure ELL lie within 15% of each other, else None. The
    hybrid's threshold is the smallest of those with the best hybrid
    score: JAX takes the scorer's pick where there is one, which is that
    threshold too (the scorer keeps the first of equal scores, in
    ascending order)."""
    scores = {r["thr"]: r["score"] for r in report if r.get("score") is not None}
    s_ell = scores.get(None)
    s_hyb = min((v for t, v in scores.items() if t is not None), default=None)
    if s_ell is None or s_hyb is None or abs(s_hyb - s_ell) > 0.15 * min(s_hyb, s_ell):
        return None
    hyb_thr = min(t for t, v in scores.items() if t is not None and v == s_hyb)
    return (("hybrid", {"density_threshold": hyb_thr, "compact": "auto"}),
            ("csr_ell", {"compact": "auto"}))


def _auto_impl(matrix, block_size: int, feat_dim, kw: dict, tune_with=None):
    """The JAX router's "auto" choice: (impl, matrix, report, threshold),
    the matrix repacked or divided where the route says so,
    score_thresholds' report where the scorer ran (else None), and the
    density threshold of the hybrid split it made (else None). The
    scorer prices by route_pricing(kw's device, kw's dtype): a kw with
    no device means the card. With `tune_with` and a thin margin between
    the scorer's finalists, ("tuned", the measured winner's plan,
    report, None). Pops bsr_bytes_budget from kw."""
    if isinstance(matrix, Windowed):
        return "windowed", matrix, None, None
    if isinstance(matrix, Hybrid):
        return "hybrid", matrix, None, None
    if isinstance(matrix, BSR) and matrix.block_size < 32 and _prefer_repack128(matrix):
        matrix = repack_bsr(matrix, 128)
    b_eff = matrix.block_size if isinstance(matrix, BSR) else block_size
    wide = feat_dim is None or feat_dim >= 256
    impl = "bsr_pallas" if (wide and b_eff >= 64) else "bsr_xla"
    if not isinstance(matrix, CSR):
        return impl, matrix, None, None
    # the memory guard: a BSR-ified element-sparse graph can exceed the
    # device's memory, and one of mostly empty blocks wastes its products
    budget = kw.pop("bsr_bytes_budget", 4 << 30)
    nnzb = calculate_nnzb(matrix, block_size)
    block_bytes = nnzb * block_size * block_size * 4
    fill_amp = nnzb * block_size * block_size / max(matrix.nnz, 1)
    if fill_amp > 32 and block_bytes <= budget:
        return "csr_ell", matrix, None, None
    if block_bytes <= budget:
        return impl, matrix, None, None
    candidates = {*_THRESHOLDS, auto_threshold(matrix, block_size)}
    if route_pricing(kw.get("device"), kw.get("dtype")) == "kernel":
        best_thr, report = _score_by_kernels(matrix, block_size, candidates, feat_dim,
                                             budget // 4)
    else:
        big_table = matrix.n_cols >= SCAN_MIN_SOURCE_ROWS
        best_thr, report = score_thresholds(
            matrix, block_size, candidates=candidates,
            slots_per_block=(PADDED_SLOTS_PER_BLOCK_BIG_TABLE if big_table
                             else PADDED_SLOTS_PER_BLOCK),
            dense_bytes_budget=budget // 4, dtype_bytes=_itemsize(kw.get("dtype")),
        )
    finalists = None if tune_with is None else _thin_margin_finalists(report)
    if finalists is not None:
        # the scorer's prices are fits: on a thin margin, measure the
        # finalists on the caller's operand
        plan, _ = spmm_tune(matrix, tune_with, candidates=finalists,
                            block_size=block_size, **kw)
        return "tuned", plan, report, None
    if best_thr is None:  # densification pays nothing here
        return "csr_ell", matrix, report, None
    return "hybrid", divide(matrix, block_size, best_thr), report, best_thr


def spmm_plan(matrix, impl: str = "auto", block_size: int = 128,
              feat_dim=None, **kw) -> Plan:
    """Build an SpMM executor for `matrix` (CSR, BSR, Hybrid or
    Windowed).

    impl: a key of PLANNERS or "auto". feat_dim: the operand width that
    "auto" and the ELL tiers' compaction model expect (None assumes a
    wide operand). repack_to= re-blocks a BSR input first.
    impl="hybrid"/"hybrid_int8" on a CSR input divides it
    (density_threshold=, else the scored threshold); "windowed*" on a CSR
    input cuts its tiles (tile_rows=, window=, min_fill=, n_windows=).
    bsr_bytes_budget= (4 GiB) is "auto"'s memory guard. dtype=torch.int8
    maps the tier to its int8 variant (bsr_pallas -> bsr_int8_pallas,
    bsr_xla -> bsr_int8, csr_ell -> csr_ell_int8, hybrid -> hybrid_int8,
    windowed -> windowed_int8); pass calibration= for static operand
    scales. tune_with= (an operand) lets "auto" measure its two
    finalists where the scorer's margin is thin (spmm_tune).
    operand_layout="col" returns a plan of the operand's transpose, (F,
    K) -> (M, F). values="call" builds a pattern plan that takes A's
    values with each call, plan(B, values=v), v (nnz,) or (heads, nnz) in
    the matrix's entry order (ops/plan): "auto" takes
    CALL_VALUE_TIER, another impl raises ValueError, and grad
    defaults to False (such a plan has no backward). Other keyword
    arguments go to the planner, e.g.
    grad=False, dtype=torch.bfloat16, precision="high", compact=.
    device: None (the default) is the card; CPU callers pass
    device="cpu"."""
    kw["device"] = resolve_device(kw.get("device"))
    was_auto = impl == "auto"
    per_call = kw.get("values") == "call"
    if per_call:
        if not was_auto and impl != CALL_VALUE_TIER:
            raise ValueError(f"impl {impl!r} takes no values per call (values='call');"
                             f" the tier that does: {CALL_VALUE_TIER}")
        dtype = kw.get("dtype")
        if dtype is not None and dtype_name(dtype) == "int8":
            raise ValueError("values='call' plans are f32 or bf16; no int8 tier takes "
                             "values per call")
        kw.setdefault("grad", False)
    operand_layout = kw.pop("operand_layout", "row")
    if operand_layout not in ("row", "col"):
        raise ValueError(f"operand_layout must be 'row' or 'col', got {operand_layout!r}")
    if operand_layout == "col":
        # the reference's transB = 1 axis: the plan takes B^T, (F, K)
        return transb_plan(spmm_plan(matrix, impl=impl, block_size=block_size,
                                     feat_dim=feat_dim, **kw))
    repack_to = kw.pop("repack_to", None)
    tune_with = kw.pop("tune_with", None)
    if repack_to is not None and isinstance(matrix, BSR):
        matrix = repack_bsr(matrix, repack_to)
    if impl in ("hybrid", "hybrid_int8") and isinstance(matrix, CSR):
        matrix = _explicit_hybrid(matrix, impl, block_size, kw)
    if impl.startswith("windowed") and isinstance(matrix, CSR):
        matrix = divide_windowed(
            matrix,
            tile_rows=kw.pop("tile_rows", 256),
            window=kw.pop("window", 1024),
            min_fill=kw.pop("min_fill", 0.0),
            n_windows=kw.pop("n_windows", 1),
        )
    if was_auto:
        with profiling.span("sdb.route") as route:
            report = None
            if per_call:
                impl, thr = CALL_VALUE_TIER, None
            else:
                impl, matrix, report, thr = _auto_impl(matrix, block_size, feat_dim,
                                                       kw, tune_with)
            route.set(impl=impl, threshold=thr)
            if report is not None:  # the scorer ran: how it priced, what it predicted
                route.set(pricing=route_pricing(kw["device"], kw.get("dtype")))
                if impl != "tuned":
                    route.set(**_route_costs(report, thr))
        if impl == "tuned":
            return matrix
    kw.pop("bsr_bytes_budget", None)
    dtype = kw.get("dtype")
    if dtype is not None and dtype_name(dtype) == "int8":
        if impl in _INT8_VARIANT:
            impl = _INT8_VARIANT[impl]
        if impl in _INT8_VARIANT.values():  # the quantized tiers take no dtype
            kw.pop("dtype")
    if impl in _ELL_TIERS:
        if was_auto:  # two-level gathers where the model predicts a win
            kw.setdefault("compact", "auto")
        if feat_dim is not None:  # the compaction model's operand width
            kw["feat_dim"] = feat_dim
    if impl not in PLANNERS:
        raise KeyError(f"unknown impl {impl!r}; have {sorted(PLANNERS)}")
    if impl.startswith("bsr") and isinstance(matrix, CSR):
        matrix = csr_to_bsr(matrix, block_size)
    return PLANNERS[impl](matrix, **kw)


def _device_fault(e: Exception) -> bool:
    """A CUDA launch failure or an error the card reported (an illegal
    address, say), which leaves the context unusable; out-of-memory is
    not one."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, torch.AcceleratorError):
        return True
    msg = str(e)
    return isinstance(e, RuntimeError) and ("cudaError_t" in msg or "CUDA error" in msg)


def spmm_tune(
    matrix,
    sample_dense,
    candidates=("bsr_pallas", "bsr_xla", "csr_ell", "csr_xla", "hybrid", "windowed"),
    block_size: int = 128,
    **kw,
):
    """Empirical dispatch: build each candidate plan, time it briefly on
    the caller's representative operand, return (best_plan, report):
    report[label] = {"ms": ...} or {"error": ...}, report["best"] the
    fastest label.

    A candidate is an impl name or an (impl, kwargs) pair, labelled
    "impl(key, ...)" by its sorted keys, e.g. ("csr_ell", {"compact":
    "auto"}) -> "csr_ell(compact)". On the card each plan is timed with
    time_chained (CUDA events), on the CPU with time_synced(iters=3). A
    candidate whose planner rejects the input, or that runs out of device
    memory, gets an error entry; a CUDA launch failure or a fault the
    card reports is raised, as it leaves the device unusable."""
    from spmm_denseblock_tpu_torch.bench.timing import time_chained, time_synced

    dev = kw["device"] = resolve_device(kw.get("device"))
    if dev.type == "cuda":
        def timer(f, x):
            return time_chained(f, x, iters=5)
    else:
        def timer(f, x):
            return time_synced(f, x, iters=3)
    x = torch.as_tensor(sample_dense, device=dev)
    report = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        name, ckw = cand if isinstance(cand, tuple) else (cand, {})
        label = name if not ckw else f"{name}({', '.join(sorted(ckw))})"
        plan = None  # the last candidate's plan goes before this one is built
        try:
            plan = spmm_plan(matrix, impl=name, block_size=block_size, **{**kw, **ckw})
            with torch.no_grad():
                t = timer(plan, x)
        except Exception as e:  # not applicable to this matrix, or no memory
            if _device_fault(e):
                raise
            report[label] = {"error": str(e)[:120]}
            continue
        report[label] = {"ms": t * 1e3}
        if t < best_t:
            best, best_t = plan, t
            report["best"] = label
    if best is None:
        raise RuntimeError(f"no candidate worked: {report}")
    return best, report
