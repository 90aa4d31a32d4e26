"""Where a plan's arrays go: the card unless the caller asks for the CPU.

Every planner, ``spmm_plan`` and ``entry()`` take ``device=None`` and
resolve it here, at call time (never at import), so that a plan built
with no device on a machine with an NVIDIA GPU runs its CUDA kernels.
CPU callers, the tests among them, pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means "cuda". Raises RuntimeError when the result is a CUDA
    device and torch.cuda.is_available() is False, rather than fall back
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no NVIDIA GPU is available (torch.cuda.is_available() is False); "
            "plans run on the GPU unless the caller asks for the CPU: pass "
            "device=\"cpu\""
        )
    return dev
