"""Greedy max-shared-neighbor ("closest") ordering; twin of
``spmm_denseblock_tpu/reorder/greedy.py``.

The reference's greedy_neighbor.cpp:39-53,96-127 (and its per-molecule
clone ogbg_molhiv.py:5-52): chain vertices so that each next vertex
shares the most neighbors with the previous one. impl="native" (the
default) runs sdb_greedy_closest; impl="python" the body below, one
sparse mat-vec a step (counts = A @ A[x]^T over the unvisited), which
the engine matches bit for bit. Quadratic: built for small graphs (the
reference's ~25-node molecules).
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch import native as _native
from spmm_denseblock_tpu_torch.formats.csr import CSR


def greedy_closest(csr: CSR, start: int = 0, impl: str = "native") -> np.ndarray:
    if csr.n_rows and not 0 <= start < csr.n_rows:
        raise ValueError(f"start={start} is not a vertex of {csr.n_rows}")
    if _native.selected(impl):
        return _native.run("sdb_greedy_closest", csr, int(start))
    n = csr.n_rows
    A = csr.to_scipy()
    A.data[:] = 1.0
    old2new = np.full(n, -1, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)

    x = start
    for i in range(n):
        old2new[x] = i
        visited[x] = True
        if i == n - 1:
            break
        # counts[v] = |N(x) ∩ N(v)| for all v: one SpMV on the indicator
        row = A.getrow(x)
        counts = np.asarray((A @ row.T).todense()).ravel()
        counts[visited] = -1
        best = int(np.argmax(counts))
        if counts[best] <= 0:
            # no shared-neighbor candidate: lowest unvisited id, like the
            # reference's fallback scan (greedy_neighbor.cpp:119-126)
            best = int(np.nonzero(~visited)[0][0])
        x = best
    return old2new
