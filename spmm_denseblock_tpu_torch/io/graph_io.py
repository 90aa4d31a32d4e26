"""Graph and matrix file I/O (twin of
``spmm_denseblock_tpu/io/graph_io.py``): the same file formats, byte for
byte, so a file written by one package is read by the other.

The reference's layers talk through text files:
- edge list: `n nnz` header, then one `src dst` per line
  (download_ogb.py:23-27, load_data.cc:167-184);
- CSR dumps `<prefix>_indptr.txt` / `<prefix>_indices.txt`: the element
  count, then one value per line (load_data.cc:125-165);
- permutations: one integer per line (rabbit_reorder.cc:10-19);
- METIS graphs (gen_adj.cpp:45-53);
and a binary .npz cache beside them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


def dump_edge_list(csr: CSR, path: str) -> None:
    rows = csr.row_ids()
    cols = np.asarray(csr.indices)
    with open(path, "w") as f:
        f.write(f"{csr.n_rows} {csr.nnz}\n")
        np.savetxt(f, np.stack([rows, cols], 1), fmt="%d")


def load_edge_list(path: str) -> CSR:
    """`n nnz` header and edge pairs; neighbors end up sorted."""
    with open(path) as f:
        n, nnz = map(int, f.readline().split())
        data = np.fromstring(f.read(), dtype=np.int64, sep=" ")
    data = data.reshape(-1, 2)
    if data.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} edges, got {data.shape[0]}")
    return CSR.from_edges(data, n_rows=n)


def dump_csr(csr: CSR, prefix: str) -> None:
    """Writes `<prefix>_indptr.txt` and `<prefix>_indices.txt` in the
    reference's count-header format."""
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    with open(prefix + "_indptr.txt", "w") as f:
        f.write(f"{indptr.shape[0]}\n")
        np.savetxt(f, indptr, fmt="%d")
    with open(prefix + "_indices.txt", "w") as f:
        f.write(f"{indices.shape[0]}\n")
        np.savetxt(f, indices, fmt="%d")


def load_csr(prefix: str, n_cols: Optional[int] = None) -> CSR:
    with open(prefix + "_indptr.txt") as f:
        cnt = int(f.readline())
        indptr = np.fromstring(f.read(), dtype=np.int64, sep=" ")[:cnt]
    with open(prefix + "_indices.txt") as f:
        cnt = int(f.readline())
        indices = np.fromstring(f.read(), dtype=np.int64, sep=" ")[:cnt]
    n = indptr.shape[0] - 1
    return CSR(
        indptr=indptr.astype(np.int32),
        indices=indices.astype(np.int32),
        data=None,
        shape=(n, n_cols if n_cols is not None else n),
    )


def dump_metis_graph(csr: CSR, path: str) -> None:
    """METIS graph format: header `n m` (m = undirected edge count, the
    input taken as symmetric), then each vertex's 1-indexed neighbor list,
    self-loops dropped. Feed it to an external ndmetis / gpmetis and read
    the results back with reorder.load_iperm / load_partition."""
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    n = csr.n_rows
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)])
    m = rows.shape[0] // 2
    with open(path, "w") as f:
        f.write(f"{n} {m}\n")
        for v in range(n):
            nb = cols[starts[v] : starts[v + 1]] + 1
            f.write(" ".join(map(str, nb)) + "\n")


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
