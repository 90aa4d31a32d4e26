"""Build and bind the CUDA kernels of ``csrc/``.

Each source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes, at first use and never at import: the
package imports on machines without a CUDA toolkit. The libraries go to
``build/kernels/`` at the root of the checkout, each named by a hash of
its source, the headers of ``csrc/`` and the flags, so an edit of a
source or a header rebuilds and an unchanged tree reuses the library. The sources build in parallel, one nvcc each;
a build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "bsr_spmm.cu", _PKG / "csrc" / "bsr_spmm_int8.cu",
           _PKG / "csrc" / "csr_spmm.cu")
# the headers the sources include, on nvcc's include path: each library's
# name hashes them all
INCLUDE_DIR = _PKG / "csrc"
HEADERS = tuple(sorted(INCLUDE_DIR.glob("*.cuh")))
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# symbol -> (source stem, argument types)
_SIGNATURES = {
    # f32 K1: step_ptr, slot_cols, lane_order, blocks, dense, out,
    # n_block_rows, F, ld, group, b, bn, stream
    "sdb_bsr_spmm_flat": ("bsr_spmm", [_P] * 6 + [_I] * 6 + [_P]),
    # f32 K5: the same arguments, the operand viewed as (nbc, b, ld)
    "sdb_bsr_spmm_resident": ("bsr_spmm", [_P] * 6 + [_I] * 6 + [_P]),
    # bf16 K1 and K5: the same pointers, then n_block_rows, n_slots,
    # n_dense_rows, F, ld, group, b, bn, stream
    "sdb_bsr_spmm_flat_bf16": ("bsr_spmm", [_P] * 6 + [_I] * 8 + [_P]),
    "sdb_bsr_spmm_resident_bf16": ("bsr_spmm", [_P] * 6 + [_I] * 8 + [_P]),
    # K3 on K1's and K5's layouts: the same arguments, the blocks and the
    # operand as their two bf16 planes
    "sdb_bsr_spmm_flat_bf16x3": ("bsr_spmm", [_P] * 6 + [_I] * 8 + [_P]),
    "sdb_bsr_spmm_resident_bf16x3": ("bsr_spmm", [_P] * 6 + [_I] * 8 + [_P]),
    # f32 K2: group_ptr, win_ids, pos, lane_valid, slot_cols, lane_order,
    # blocks, dense, out, n_lanes, F, ld, R, gh, window, b, bn, stream
    "sdb_bsr_spmm_sorted": ("bsr_spmm", [_P] * 9 + [_I] * 8 + [_P]),
    # bf16 K2: the same pointers, then n_lanes, n_slots, n_dense_rows, F,
    # ld, R, gh, window, b, bn, stream
    "sdb_bsr_spmm_sorted_bf16": ("bsr_spmm", [_P] * 9 + [_I] * 10 + [_P]),
    # K3 on K2's layout: the same arguments, with the two planes
    "sdb_bsr_spmm_sorted_bf16x3": ("bsr_spmm", [_P] * 9 + [_I] * 10 + [_P]),
    # K3's operand split: x, out, N, F, ld, stream
    "sdb_split_bf16": ("bsr_spmm", [_P] * 2 + [_I] * 3 + [_P]),
    # f32 K4: group_ptr, slot_cols, lane_order, blocks, dense, out,
    # n_lanes, n_block_rows, F, ld, R, gh, b, bn, stream
    "sdb_bsr_spmm_rowgroup": ("bsr_spmm", [_P] * 6 + [_I] * 8 + [_P]),
    # bf16 K4: the same pointers, then n_lanes, n_block_rows, n_slots,
    # n_dense_rows, F, ld, R, gh, b, bn, stream
    "sdb_bsr_spmm_rowgroup_bf16": ("bsr_spmm", [_P] * 6 + [_I] * 10 + [_P]),
    # K6: step_ptr, slot_cols, lane_order (read at b = 16 and 32),
    # qblocks, scales, qdense_t (the transposed operand), cs, out,
    # n_block_rows, n_slots, n_dense_rows, F, group, b, bn, stream
    "sdb_bsr_spmm_int8_flat": ("bsr_spmm_int8", [_P] * 8 + [_I] * 7 + [_P]),
    # K9: the same arguments, the operand viewed as (nbc, b, F)
    "sdb_bsr_spmm_int8_resident": ("bsr_spmm_int8", [_P] * 8 + [_I] * 7 + [_P]),
    # K6-K9's operand: x, static_scale, absmax, q, col_scale, ldx, n_rows,
    # F, n_out, transposed, stream
    "sdb_quantize_int8": ("bsr_spmm_int8", [_P] * 5 + [_I] * 5 + [_P]),
    # K7: group_ptr, win_ids, pos, lane_valid, slot_cols, lane_order,
    # qblocks, scales, qdense_t, cs, out, n_lanes, n_slots, n_dense_rows,
    # F, R, gh, window, b, bn, group_scale, stream
    "sdb_bsr_spmm_int8_sorted": ("bsr_spmm_int8", [_P] * 11 + [_I] * 10 + [_P]),
    # K8: group_ptr, slot_cols, lane_order, qblocks, scales, qdense_t, cs,
    # out, n_lanes, n_block_rows, n_slots, n_dense_rows, F, R, gh, b, bn,
    # stream
    "sdb_bsr_spmm_int8_rowgroup": ("bsr_spmm_int8", [_P] * 8 + [_I] * 9 + [_P]),
    # seg_start, seg_end, seg_dest, cols, vals, dense, out, partial,
    # split_row, part_ptr, n_seg, n_split, F, W (strip width), stream
    "sdb_csr_spmm": ("csr_spmm", [_P] * 10 + [_I] * 4 + [_P]),
    # K10 at one bf16 pass: the same arguments, bf16 vals and dense
    "sdb_csr_spmm_bf16": ("csr_spmm", [_P] * 10 + [_I] * 4 + [_P]),
    # the f32 ELL tier on its flattened layout: seg_start, seg_end,
    # seg_dest, seg_delta (or null), cols, vals (null for a pattern-only
    # layout), dense, out, partial, split_row, part_ptr, n_seg, n_split, F,
    # W (strip width inside a head), heads, vstride (values a head), stream
    "sdb_ell_spmm": ("csr_spmm", [_P] * 11 + [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_libs = None


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


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsdb_{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> List[Path]:
    """Compile every source whose library is missing, one nvcc process
    per source, all started together; wait for all of them. Returns the
    libraries' paths in SOURCES order."""
    paths = [library_path(src) for src in SOURCES]
    jobs = []
    for src, path in zip(SOURCES, paths):
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, tmp, path, proc))
    failures = []
    for cmd, tmp, path, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                            f"{out}\n{err}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load() -> Dict[str, ctypes.CDLL]:
    """Build if needed, load each library once per process, declare the
    signatures. Returns {source stem: library}."""
    global _libs
    with _lock:
        if _libs is None:
            libs = {src.stem: ctypes.CDLL(str(path))
                    for src, path in zip(SOURCES, build())}
            for name, (stem, argtypes) in _SIGNATURES.items():
                fn = getattr(libs[stem], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs = libs
        return _libs


class CudaKernel:
    """One kernel's launcher. ``launches`` counts the launches that CUDA
    accepted, and nothing else."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.source = _SIGNATURES[symbol][0]
        self.launches = 0

    def __call__(self, *args) -> None:
        entry = getattr(load()[self.source], self.symbol)
        if torch.autograd._profiler_enabled():
            # under torch.profiler the launch is a range named by its entry
            with torch.profiler.record_function(self.symbol):
                rc = entry(*args)
        else:
            rc = entry(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: launch failed with cudaError_t {rc}"
            )
        self.launches += 1


bsr_spmm_flat = CudaKernel("sdb_bsr_spmm_flat")                # K1, f32
bsr_spmm_flat_bf16 = CudaKernel("sdb_bsr_spmm_flat_bf16")      # K1, bf16
bsr_spmm_sorted = CudaKernel("sdb_bsr_spmm_sorted")            # K2, f32
bsr_spmm_sorted_bf16 = CudaKernel("sdb_bsr_spmm_sorted_bf16")  # K2, bf16
# K3 (bf16x3) on K1's, K2's and K5's layouts
bsr_spmm_flat_bf16x3 = CudaKernel("sdb_bsr_spmm_flat_bf16x3")
bsr_spmm_sorted_bf16x3 = CudaKernel("sdb_bsr_spmm_sorted_bf16x3")
bsr_spmm_resident_bf16x3 = CudaKernel("sdb_bsr_spmm_resident_bf16x3")
split_bf16 = CudaKernel("sdb_split_bf16")  # K3's operand split
bsr_spmm_rowgroup = CudaKernel("sdb_bsr_spmm_rowgroup")        # K4, f32
bsr_spmm_rowgroup_bf16 = CudaKernel("sdb_bsr_spmm_rowgroup_bf16")  # K4, bf16
bsr_spmm_resident = CudaKernel("sdb_bsr_spmm_resident")        # K5, f32
bsr_spmm_resident_bf16 = CudaKernel("sdb_bsr_spmm_resident_bf16")  # K5, bf16
bsr_spmm_int8_flat = CudaKernel("sdb_bsr_spmm_int8_flat")      # K6
bsr_spmm_int8_sorted = CudaKernel("sdb_bsr_spmm_int8_sorted")  # K7
bsr_spmm_int8_rowgroup = CudaKernel("sdb_bsr_spmm_int8_rowgroup")  # K8
bsr_spmm_int8_resident = CudaKernel("sdb_bsr_spmm_int8_resident")  # K9
quantize_int8 = CudaKernel("sdb_quantize_int8")  # K6-K9's operand
csr_spmm = CudaKernel("sdb_csr_spmm")                           # K10
csr_spmm_bf16 = CudaKernel("sdb_csr_spmm_bf16")  # K10, one bf16 pass
ell_spmm = CudaKernel("sdb_ell_spmm")  # the f32 ELL tier (csr_ell)
KERNELS = (bsr_spmm_flat, bsr_spmm_flat_bf16, bsr_spmm_sorted,
           bsr_spmm_sorted_bf16, bsr_spmm_flat_bf16x3,
           bsr_spmm_sorted_bf16x3, bsr_spmm_resident_bf16x3, split_bf16,
           bsr_spmm_rowgroup, bsr_spmm_rowgroup_bf16, bsr_spmm_resident,
           bsr_spmm_resident_bf16, bsr_spmm_int8_flat, bsr_spmm_int8_sorted,
           bsr_spmm_int8_rowgroup, bsr_spmm_int8_resident, quantize_int8,
           csr_spmm, csr_spmm_bf16, ell_spmm)
