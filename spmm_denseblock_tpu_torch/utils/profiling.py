"""Profiling and the card's figures (twin of
``spmm_denseblock_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` run over the block (the host
  and, on a machine with a GPU, the card), exported as a Chrome trace
  into `logdir` (open it in Perfetto or chrome://tracing). Each kernel
  launch of ``ops/_kernels`` shows as a range named by its C entry
  (``sdb_...``) with the device kernel under it.
- ``annotate(name)``: a named range on that timeline
  (``torch.profiler.record_function``).
- ``device_info()``: the device's kind and memory for bench records.
- ``roofline(flops, bytes, secs)``: achieved rates and, given peaks,
  the fraction of the roofline; ``PEAK_OPS_S`` and ``HBM_BYTES_S`` are
  the H100's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from spmm_denseblock_tpu_torch.ops._device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM) published peaks, dense, at the 700 W power
# limit: device memory bytes/s, and operations/s by the operands' type
# ("high", bf16x3, counts three bf16 products on the bf16 tensor cores;
# exact f32 is FFMA: the 1e-4 gate rules out TF32). A card set below
# 700 W runs below them.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "high": 989e12, "bf16": 989e12, "int8": 1979e12}


@contextlib.contextmanager
def trace(logdir: str, host: bool = False):
    """Profile the block; on exit write ``trace_<pid>_<ns>.json`` into
    `logdir`. The card's activity is traced where torch sees a GPU.
    `host` is JAX's argument, unused there too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Scoped trace annotation (a named range on the trace timeline)."""
    return torch.profiler.record_function(name)


def device_info(device=None) -> Dict:
    """The JAX record's keys for `device` (None: the card): backend
    ("cuda" or "cpu"), n_devices, platform ("gpu" or "cpu"),
    device_kind, and on the card bytes_limit (its memory) and
    bytes_in_use (what torch holds there)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"backend": "cpu", "n_devices": 1, "platform": "cpu",
                "device_kind": "cpu"}
    return {
        "backend": "cuda",
        "n_devices": torch.cuda.device_count(),
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "bytes_in_use": torch.cuda.memory_allocated(dev),
    }


def roofline(
    flops: float,
    bytes_moved: float,
    secs: float,
    peak_flops: Optional[float] = None,
    peak_bw: Optional[float] = None,
) -> Dict:
    """Achieved rates + (optionally) fraction of the machine roofline."""
    out = {
        "gflops": flops / secs / 1e9,
        "gb_s": bytes_moved / secs / 1e9,
        "intensity_flop_per_byte": flops / max(bytes_moved, 1.0),
        "ms": secs * 1e3,
    }
    if peak_flops and peak_bw:
        ridge = peak_flops / peak_bw
        bound = "compute" if out["intensity_flop_per_byte"] >= ridge else "memory"
        attainable = min(peak_flops, peak_bw * out["intensity_flop_per_byte"])
        out.update(
            bound=bound,
            frac_of_roofline=(flops / secs) / attainable,
        )
    return out
