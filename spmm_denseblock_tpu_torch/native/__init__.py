"""ctypes loader of the native reorder engine (``src/reorder.cc``).

The port's own copy of the JAX package's engine, built with g++ at
first use, never at import, into ``build/native/`` at the root of the
checkout. One build, for any host of the architecture: serial (its
OpenMP pragmas are ignored; the answers do not depend on them) and with
no -march=native, so a library copied with the checkout to another
machine still runs there. It is named by a hash of the source, the
compiler, the flags and the machine architecture: an edit rebuilds, an
unchanged tree reuses the library. A build writes a temporary file and
renames it into place, so processes that build at once never load a
half-written library.

Every strategy with a native body takes ``impl``: "native" (the default)
runs the engine, "python" the numpy body it matches; so does
``unique_inverse``, the ELL tier's compaction pass. There is no silent
fallback: when the library cannot be built or loaded, "native" raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "src" / "reorder.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")
IMPLS = ("native", "python")

_I64 = ctypes.c_int64
_F64 = ctypes.c_double
_PI32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_PI64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

# symbol -> argument types (the strategies: n, indptr, indices, extra
# arguments..., out); each returns nothing but sdb_unique_inverse, which
# returns the unique count
_SIGNATURES = {
    "sdb_degree_sort": [_I64, _PI32, _PI32, _PI64],
    "sdb_bfs": [_I64, _PI32, _PI32, _PI64],
    "sdb_rcm_variant": [_I64, _PI32, _PI32, _PI64],
    "sdb_gorder": [_I64, _PI32, _PI32, _I64, _F64, _PI64],
    "sdb_rabbit": [_I64, _PI32, _PI32, _I64, _PI64],
    "sdb_greedy_closest": [_I64, _PI32, _PI32, _I64, _PI64],
    "sdb_permutate": [_I64, _PI32, _PI32, _PI64, _PI32, _PI32, _PI64],
    "sdb_unique_inverse": [_I64, _PI32, _I64, _PI32, _PI32],
}
_RESTYPES = {"sdb_unique_inverse": _I64}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_cxx(), *CXX_FLAGS, platform.machine())).encode())
    return BUILD_DIR / f"libsdb_reorder_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile with CXX_FLAGS; raise RuntimeError with what the compiler
    said when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native reorder engine: {' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native reorder engine: {' '.join(cmd)} exited "
                           f"{proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """Build if needed and load the library once per process; raise
    RuntimeError (with the compiler's output) when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name)
            _lib = lib
        return _lib


def selected(impl: str) -> bool:
    """True for impl="native", False for "python"; anything else raises."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "native"


def csr_args(csr):
    """(indptr, indices) as contiguous int32 arrays."""
    return (np.ascontiguousarray(csr.indptr, dtype=np.int32),
            np.ascontiguousarray(csr.indices, dtype=np.int32))


def run(name: str, csr, *extra) -> np.ndarray:
    """old2new of the native strategy `name` on a square CSR."""
    if csr.n_rows != csr.n_cols:
        raise ValueError(f"the native strategies take a square matrix, got {csr.shape}")
    lib = load()
    indptr, indices = csr_args(csr)
    out = np.empty(csr.n_rows, dtype=np.int64)
    getattr(lib, name)(csr.n_rows, indptr, indices, *extra, out)
    return out


def unique_inverse(seg, n_vals: int, impl: str = "native"):
    """np.unique(seg, return_inverse=True) of a stream of int32 values in
    [0, n_vals), as (sorted unique values, the inverse), both int32.
    "native" is the engine's dense-mark pass, O(n + n_vals) where numpy
    sorts; "python" is np.unique. Values out of range raise ValueError."""
    seg = np.ascontiguousarray(seg, dtype=np.int32)
    if seg.size and (int(seg.min()) < 0 or int(seg.max()) >= n_vals):
        raise ValueError(f"unique_inverse: values must lie in [0, {n_vals})")
    if not selected(impl):
        uniq, inv = np.unique(seg, return_inverse=True)
        return uniq.astype(np.int32), inv.reshape(-1).astype(np.int32)
    uniq = np.empty(int(min(seg.size, n_vals)), dtype=np.int32)
    inv = np.empty(seg.size, dtype=np.int32)
    u = load().sdb_unique_inverse(seg.size, seg, int(n_vals), uniq, inv)
    return uniq[:u].copy(), inv
