"""Where a plan's arrays go: the card unless the caller asks for the CPU.

Every planner, ``spmm_plan`` and ``entry()`` take ``device=None`` and
resolve it here, at call time (never at import), so that a plan built
with no device on a machine with an NVIDIA GPU runs its CUDA kernels.
CPU callers, the tests among them, pass ``device="cpu"``. The kernel
wrappers' device facts and array checks live here too.
"""

from __future__ import annotations

import functools

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


def runs_f32_kernels(device, itemsize: int) -> bool:
    """Whether a plan on `device` (None: the card) with an operand of
    `itemsize` bytes runs the card's f32 kernels: a CUDA device, f32."""
    return torch.device("cuda" if device is None else device).type == "cuda" and itemsize == 4


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    """The card's L2 size (cudaDevAttrL2CacheSize, as torch reports it)."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def check_arrays(named) -> None:
    """Each (name, tensor, dtype) of `named` is of its dtype (TypeError;
    None checks no dtype), then each is contiguous (ValueError), as a
    CUDA kernel reads it."""
    for name, t, dtype in named:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got dtype {t.dtype}")
    for _, t, _ in named:
        if not t.is_contiguous():
            raise ValueError("CUDA kernel operands must be contiguous")
