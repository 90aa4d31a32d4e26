"""Communication-volume model for the distributed SpMM strategies (twin of
``spmm_denseblock_tpu/parallel/comms.py``, its formulas unchanged).

Why this exists: ranks that share one machine, or one GPU, cannot show
how a strategy scales across cards - they share the cores (or the SMs)
and their exchanges run through host memory. What such a run CAN check
is correctness, partitioning overhead and throughput retention. A
multi-card efficiency claim needs the link arithmetic made explicit:
per-rank compute time against per-rank exchange bytes over the link.

The default model is the NVIDIA H100 SXM (80 GB HBM3): the peaks of
``utils/profiling`` (67 TFLOP/s f32 FFMA, 989 TFLOP/s bf16 tensor cores,
3.35 TB/s HBM), 450 GB/s a direction over NVLink 4 (NVIDIA's
specification for the SXM card, not a measurement; a PCIe card's link
is PCIe Gen5's ~64 GB/s a direction) and the measured share of the FFMA
peak that the K2 kernel reaches at bench.py's op shape (0.56: the
``bench`` record of PERF.md). Every field is overridable.

Per-call, per-rank bytes for C = A @ B, A row-striped over n ranks, B
row-sharded (K x F, dtype s bytes):

  allgather - every rank RECEIVES the other shards of B once:
              (n-1)/n * K * F * s        (one all-gather)
  ring      - the same total volume, moved in n-1 neighbour steps of
              K/n * F * s each; each step's exchange is posted before the
              step's kernel, so the two overlap.
  halo      - only 2*halo neighbour chunks ever move:
              2*halo/n * K * F * s       (O(1) in n; needs bandedness)

Per-rank compute: 2 * (nnzb/n) * b^2 * F flops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from spmm_denseblock_tpu_torch.utils.profiling import HBM_BYTES_S, PEAK_OPS_S


@dataclass(frozen=True)
class ChipModel:
    """NVIDIA H100 SXM defaults; every field overridable."""

    name: str = "nvidia_h100_sxm"
    peak_flops_f32: float = PEAK_OPS_S["f32"]    # FFMA, no TF32
    peak_flops_bf16: float = PEAK_OPS_S["bf16"]  # dense tensor cores
    hbm_gbps: float = HBM_BYTES_S
    link_gbps: float = 450e9  # NVLink 4, a direction (specification)
    mfu: float = 0.56         # K2's share of the FFMA peak, op shape


H100 = ChipModel()


def comms_bytes_per_device(
    strategy: str, n: int, K: int, F: int, itemsize: int = 4, halo: int = 1
) -> float:
    """Bytes RECEIVED per rank per SpMM call (send volume is equal)."""
    total_b = K * F * itemsize
    if n <= 1:
        return 0.0
    if strategy == "allgather":
        return (n - 1) / n * total_b
    if strategy == "ring":
        return (n - 1) / n * total_b  # n-1 steps of K/n rows each
    if strategy == "halo":
        return min(2 * halo, n - 1) / n * total_b
    raise ValueError(strategy)


def efficiency_model(
    strategy: str,
    n: int,
    nnzb: int,
    b: int,
    K: int,
    F: int,
    itemsize: int = 4,
    halo: int = 1,
    chip: ChipModel = H100,
    dtype_flops: str = "f32",
    overlap: bool = True,
) -> Dict:
    """Predicted scaling efficiency on real hardware.

    efficiency = T_comp / max(T_comp, T_comm) when the schedule overlaps
    communication with compute (ring and halo post their exchanges before
    their kernels), else T_comp / (T_comp + T_comm).

    Returns the full term breakdown so artifacts can record the model
    next to the measurement."""
    peak = (
        chip.peak_flops_bf16 if dtype_flops == "bf16" else chip.peak_flops_f32
    )
    t_comp = (2.0 * nnzb / max(n, 1) * b * b * F) / (peak * chip.mfu)
    bytes_dev = comms_bytes_per_device(strategy, n, K, F, itemsize, halo)
    t_comm = bytes_dev / chip.link_gbps
    if overlap:
        t_total = max(t_comp, t_comm)
    else:
        t_total = t_comp + t_comm
    eff = t_comp / t_total if t_total else 1.0
    return {
        "strategy": strategy,
        "n": n,
        "t_comp_us": t_comp * 1e6,
        "t_comm_us": t_comm * 1e6,
        "bytes_per_device": bytes_dev,
        "efficiency": eff,
        "chip": chip.name,
    }


def min_nnzb_for_efficiency(
    strategy: str,
    n: int,
    b: int,
    K: int,
    F: int,
    target: float = 0.8,
    itemsize: int = 4,
    halo: int = 1,
    chip: ChipModel = H100,
    dtype_flops: str = "f32",
) -> int:
    """Smallest total nnzb for which the model predicts >= target
    efficiency (with overlap, efficiency hits 1.0 exactly when
    T_comp >= T_comm; the target shapes the non-overlapped reserve)."""
    peak = (
        chip.peak_flops_bf16 if dtype_flops == "bf16" else chip.peak_flops_f32
    )
    bytes_dev = comms_bytes_per_device(strategy, n, K, F, itemsize, halo)
    t_comm = bytes_dev / chip.link_gbps
    # T_comp >= target * t_comm  (overlap model)
    need_flops_dev = t_comm * target * peak * chip.mfu
    nnzb_dev = need_flops_dev / (2.0 * b * b * F)
    return int(np.ceil(nnzb_dev * n)) if nnzb_dev else 0
