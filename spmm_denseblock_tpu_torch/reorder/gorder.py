"""Gorder: greedy window-locality ordering (SIGMOD'16, Wei et al.); twin
of ``spmm_denseblock_tpu/reorder/gorder.py``.

Vertices are placed one at a time; the next maximizes the locality score
sum_{u in the last-w window} S(u, v), S = #common in-neighbors +
adjacency (the reference's vendored Gorder/Graph.cpp:423 and
UnitHeap.h:50-117). Keys change by +-1 only, so the priority structure
is a bucket-list unit queue (a doubly-linked list per key value, head
insertion): O(1) key moves, O(1) amortized extract-max. Hub vertices
skip the common-neighbor propagation. Tie-break among equal keys: the
most recently moved wins (bucket head). The Python body is the
executable specification; sdb_gorder (native/src/reorder.cc) matches it
bit for bit and is what impl="native" (the default) runs.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch import native as _native
from spmm_denseblock_tpu_torch.formats.csr import CSR

# the hub-cut volume budget: 2*(nnz + sum_{deg_w <= cut} deg_w^2) queue
# events at most (the same constant as sdb_gorder's kGorderTouchBudget)
GORDER_TOUCH_BUDGET = 1_000_000_000


def gorder(csr: CSR, window: int = 5, floor: float = 64.0,
           impl: str = "native") -> np.ndarray:
    """Returns old2new. window=5 is the reference CLI's default
    (Gorder/main.cpp). The hub cut is the largest degree under sqrt(n)
    whose propagation volume fits GORDER_TOUCH_BUDGET, but never below
    `floor` (the JAX package's SDB_GORDER_FLOOR), so degree-dense graphs
    keep the common-neighbor signal. The scan is sequential: like the
    reference, run it once offline and cache the permutation
    (reorder_cached)."""
    if _native.selected(impl):
        return _native.run("sdb_gorder", csr, int(window), float(floor))
    n = csr.n_rows
    if n == 0:
        return np.empty(0, dtype=np.int64)
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices, dtype=np.int64)
    deg = np.diff(indptr)
    hub_cut = max(1.0, np.sqrt(n))
    # volume-budgeted hub cut, as sdb_gorder computes it
    s = np.sort(deg.astype(np.int64))
    s = s[s <= hub_cut]
    cum = 2 * (int(csr.nnz) + np.cumsum(s * s))
    fits = np.nonzero(cum <= GORDER_TOUCH_BUDGET)[0]
    cut_b = int(s[fits[-1]]) if fits.size else 0
    hub_cut = min(hub_cut, max(floor, float(cut_b)))

    def out_neighbors(v):
        return indices[indptr[v] : indptr[v + 1]]

    # undirected adjacency: in-neighbors == out-neighbors. For directed
    # inputs callers should symmetrize first (the reference's graphs are
    # symmetrized edge dumps, download_ogb.py:23-27).
    #
    # Bucket-list unit queue (the spec sdb_gorder matches move for
    # move): key[v] buckets as doubly-linked lists with head insertion;
    # per-propagate deltas are batched to one list move per touched
    # vertex, in first-touch order.
    key = [0] * n
    prv = [-1] * n
    nxt = [-1] * n
    bhead = [-1]
    maxkey = 0
    placed = np.zeros(n, dtype=bool)

    def unlink(u):
        if prv[u] >= 0:
            nxt[prv[u]] = nxt[u]
        else:
            bhead[key[u]] = nxt[u]
        if nxt[u] >= 0:
            prv[nxt[u]] = prv[u]

    def push_front(u, k):
        nonlocal maxkey
        if len(bhead) <= k:
            bhead.extend([-1] * (k + 1 - len(bhead)))
        prv[u] = -1
        nxt[u] = bhead[k]
        if nxt[u] >= 0:
            prv[nxt[u]] = u
        bhead[k] = u
        key[u] = k
        if k > maxkey:
            maxkey = k

    # ids inserted descending so the initial bucket-0 head is id 0
    for u in range(n - 1, -1, -1):
        push_front(u, 0)

    delta = [0] * n
    touched: list = []

    def propagate(ve, d):
        """ve enters (+1) or leaves (-1) the window. Single adjacency
        scan, touch order interleaved (identical to sdb_gorder)."""
        touched.clear()
        for w in out_neighbors(ve):
            if not placed[w]:  # S_n adjacency term
                if delta[w] == 0:
                    touched.append(w)
                delta[w] += d
            if deg[w] > hub_cut:
                continue  # hub skip
            for u in out_neighbors(w):
                if not placed[u]:  # S_s common-in-neighbor term via w
                    if delta[u] == 0:
                        touched.append(u)
                    delta[u] += d
        for u in touched:  # one O(1) move per touched vertex
            nk = key[u] + delta[u]
            delta[u] = 0
            unlink(u)
            push_front(u, nk)

    start = int(np.argmax(deg)) if n else 0
    order = np.empty(n, dtype=np.int64)
    window_buf: list = []

    v = start
    scan = 0
    for i in range(n):
        unlink(v)  # v leaves the queue on placement
        placed[v] = True
        order[i] = v
        window_buf.append(v)
        propagate(v, +1)
        if len(window_buf) > window:
            propagate(window_buf.pop(0), -1)
        if i == n - 1:
            break
        # extract-max: highest non-empty bucket with key >= 1 (a key-0
        # candidate has no window affinity -> lowest-unvisited restart)
        while maxkey > 0 and bhead[maxkey] < 0:
            maxkey -= 1
        v = bhead[maxkey] if maxkey > 0 else -1
        if v < 0:
            while scan < n and placed[scan]:
                scan += 1
            v = scan

    old2new = np.empty(n, dtype=np.int64)
    old2new[order] = np.arange(n)
    return old2new
