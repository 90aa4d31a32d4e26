"""Rabbit Order: community aggregation, then a DFS of the dendrogram
(IPDPS'16); twin of ``spmm_denseblock_tpu/reorder/rabbit.py``.

Re-derived from the algorithm the reference vendors
(rabbit_order/rabbit_order.hpp): vertices merge in ascending-degree order
(:531-541) into the neighbor community with the best modularity gain
(incremental aggregation, :267-310); a DFS of the merge forest emits the
permutation (compute_perm :623-673), so each community's vertices land
contiguously, which is what densifies diagonal blocks.

impl="native" (the default) runs sdb_rabbit, whose community maps are
pruned to `cap` entries; impl="python" the sequential body below (no
cap). The two may break ties between equal gains differently.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch import native as _native
from spmm_denseblock_tpu_torch.formats.csr import CSR


def rabbit_order(csr: CSR, cap: int = 1024, impl: str = "native") -> np.ndarray:
    """Returns old2new. cap: the native engine's community-map cap (the
    JAX package's SDB_RABBIT_CAP; 0 is unlimited)."""
    if _native.selected(impl):
        return _native.run("sdb_rabbit", csr, int(cap))
    n = csr.n_rows
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices, dtype=np.int64)
    deg = np.diff(indptr).astype(np.float64)

    # edge weight 1 per stored entry; undirected modularity normalization
    two_m = float(indptr[-1])
    if two_m == 0:
        return np.arange(n, dtype=np.int64)

    # live community adjacency as dicts (community -> weight)
    nbrs = [None] * n  # lazily materialized
    strength = deg.copy()  # community weighted degree
    parent = np.full(n, -1, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    children: list[list[int]] = [[] for _ in range(n)]

    # union-find over merged vertices -> live community representative
    comm = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while comm[root] != root:
            root = comm[root]
        while comm[x] != root:
            comm[x], x = root, comm[x]
        return int(root)

    def get_nbrs(u: int) -> dict:
        d = nbrs[u]
        if d is None:
            d = {}
            for v in indices[indptr[u] : indptr[u + 1]]:
                v = int(v)
                if v != u:
                    d[v] = d.get(v, 0.0) + 1.0
            nbrs[u] = d
        return d

    order = np.argsort(deg, kind="stable")  # ascending degree, :531-541
    for u0 in order:
        u = int(u0)
        if not alive[u]:
            continue
        du = get_nbrs(u)
        # re-point keys at live representatives, combining weights
        best_v, best_gain = -1, 0.0
        combined: dict = {}
        for v, w in du.items():
            r = find(v)
            if r != u:
                combined[r] = combined.get(r, 0.0) + w
        for r, w in combined.items():
            # dQ = 2*(w/2m - s_u*s_r/(2m)^2); constant factor irrelevant
            gain = w / two_m - strength[u] * strength[r] / (two_m * two_m)
            if gain > best_gain:
                best_gain, best_v = gain, r
        if best_v < 0:
            nbrs[u] = combined  # keep compacted adjacency
            continue
        # merge u into best_v
        v = best_v
        parent[u] = v
        children[v].append(u)
        alive[u] = False
        comm[u] = v
        dv = get_nbrs(v)
        for r, w in combined.items():
            if r != v:
                dv[r] = dv.get(r, 0.0) + w
        dv.pop(u, None)
        strength[v] += strength[u]
        nbrs[u] = None  # free

    # DFS over the merge forest: parent first, then children in merge
    # order — each community contiguous (compute_perm :623-673).
    old2new = np.empty(n, dtype=np.int64)
    cnt = 0
    roots = [int(r) for r in np.nonzero(parent == -1)[0]]
    for root in roots:
        stack = [root]
        while stack:
            x = stack.pop()
            old2new[x] = cnt
            cnt += 1
            # push children reversed so the first-merged child is visited
            # first
            stack.extend(reversed(children[x]))
    assert cnt == n
    return old2new
