"""Graph file I/O on the ported path: the .npz graph cache and the
permutation text files (twin of ``spmm_denseblock_tpu/io/graph_io.py``,
same file formats, so a cache written by one package is read by the
other)."""

from __future__ import annotations

import os

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


def dump_permutation(old2new: np.ndarray, path: str) -> None:
    """One integer per line."""
    with open(path, "w") as f:
        np.savetxt(f, np.asarray(old2new), fmt="%d")


def load_permutation(path: str) -> np.ndarray:
    with open(path) as f:
        return np.fromstring(f.read(), dtype=np.int64, sep=" ").reshape(-1)


def save_npz(csr: CSR, path: str) -> None:
    np.savez_compressed(
        path,
        indptr=np.asarray(csr.indptr),
        indices=np.asarray(csr.indices),
        data=np.zeros(0) if csr.data is None else np.asarray(csr.data),
        shape=np.asarray(csr.shape),
    )


def load_npz(path: str) -> CSR:
    z = np.load(path)
    data = z["data"]
    return CSR(
        indptr=z["indptr"].astype(np.int32),
        indices=z["indices"].astype(np.int32),
        data=None if data.shape[0] == 0 else data.astype(np.float32),
        shape=tuple(int(x) for x in z["shape"]),
    )


def cached(cache_dir: str, name: str, make) -> CSR:
    """Build once, then reuse `<cache_dir>/<name>.npz`."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        return load_npz(path)
    csr = make()
    save_npz(csr, path)
    return csr
