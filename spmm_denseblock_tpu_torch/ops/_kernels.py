"""Build and bind the CUDA kernels of ``csrc/bsr_spmm.cu``.

The source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes, at first use and never at import: the
package imports on machines without a CUDA toolkit. The library goes to
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so an edit rebuilds and an unchanged tree reuses
it. The build writes a temporary file and renames it into place, so
processes that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "bsr_spmm.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # step_ptr, slot_cols, blocks, dense, out, n_block_rows, F, group, b,
    # is_bf16, stream
    "sdb_bsr_spmm_flat": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # group_ptr, win_ids, pos, lane_valid, slot_cols, blocks, dense, out,
    # n_lanes, F, R, gh, window, b, is_bf16, stream
    "sdb_bsr_spmm_sorted": [_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsdb_bsr_spmm_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for this source exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


class CudaKernel:
    """One kernel's launcher. ``launches`` counts the launches that CUDA
    accepted, and nothing else."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args) -> None:
        rc = getattr(load(), self.symbol)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: launch failed with cudaError_t {rc}"
            )
        self.launches += 1


bsr_spmm_flat = CudaKernel("sdb_bsr_spmm_flat")
bsr_spmm_sorted = CudaKernel("sdb_bsr_spmm_sorted")
KERNELS = (bsr_spmm_flat, bsr_spmm_sorted)
