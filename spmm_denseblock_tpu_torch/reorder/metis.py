"""METIS-based reorderings; twin of ``spmm_denseblock_tpu/reorder/metis.py``.

The reference drives external `ndmetis` / `gpmetis` binaries and applies
their output files (metis_reorder.cpp:116-141, gpmetis_rcmk.cpp:119-199).
This module keeps the same two file adapters, so permutations computed
anywhere can be applied, a first-party nested dissection, and an
in-process partition through pymetis where it can be imported; without
it, partition_rcm runs on BFS-order buckets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.reorder.base import invert_permutation
from spmm_denseblock_tpu_torch.reorder.simple import (
    _bfs_order,
    _ragged_arange,
    _sort_adjacency_by,
    bfs,
)


def load_iperm(path: str, n: int) -> np.ndarray:
    """Read an ndmetis `.iperm` file (one integer per line: the inverse
    permutation, new2old... metis emits iperm[old]=new) and return
    old2new — metis_reorder.cpp:116-141 semantics."""
    vals = np.loadtxt(path, dtype=np.int64).reshape(-1)
    if vals.shape[0] != n:
        raise ValueError(f"iperm has {vals.shape[0]} entries, expected {n}")
    return vals


def load_partition(path: str, n: int) -> np.ndarray:
    """Read a gpmetis partition file (one part id per vertex line)."""
    parts = np.loadtxt(path, dtype=np.int64).reshape(-1)
    if parts.shape[0] != n:
        raise ValueError(f"partition has {parts.shape[0]} entries, expected {n}")
    return parts


def partition_rcm(csr: CSR, parts: np.ndarray) -> np.ndarray:
    """gpmetis_rcmk: number partitions contiguously; inside each
    partition, ascending-degree-sorted adjacency + BFS restricted to
    intra-partition edges (gpmetis_rcmk.cpp:119-178)."""
    n = csr.n_rows
    deg = csr.degrees()
    indptr, indices = _sort_adjacency_by(csr, deg)  # ascending degree

    # mask inter-partition edges: rebuild a CSR keeping only edges whose
    # endpoints share a partition
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = parts[rows] == parts[indices]
    rows_k, cols_k = rows[keep], indices[keep]
    counts = np.bincount(rows_k, minlength=n)
    intra_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=intra_indptr[1:])

    # global numbering: partitions in ascending part id, vertices inside a
    # partition in intra-BFS order
    old2new = np.full(n, -1, dtype=np.int64)
    cnt = 0
    for p in np.unique(parts):
        members = np.nonzero(parts == p)[0]
        # local BFS over the intra-partition subgraph: reuse the global
        # BFS but seed/restrict to members via a relabeled subgraph
        local_id = np.full(n, -1, dtype=np.int64)
        local_id[members] = np.arange(members.size)
        sub_counts = counts[members]
        sub_indptr = np.zeros(members.size + 1, dtype=np.int64)
        np.cumsum(sub_counts, out=sub_indptr[1:])
        gather = np.concatenate(
            [
                cols_k[intra_indptr[m] : intra_indptr[m + 1]]
                for m in members
            ]
        ) if members.size else np.zeros(0, np.int64)
        sub_indices = local_id[gather]
        local_order = _bfs_order(sub_indptr, sub_indices, members.size)
        old2new[members] = cnt + local_order
        cnt += members.size
    assert cnt == n
    return old2new


def _subgraph(indptr, indices, members):
    """CSR of the induced subgraph on `members` (global ids, any order).
    Returns (sub_indptr, sub_indices) with local vertex ids."""
    n = indptr.shape[0] - 1
    local = np.full(n, -1, dtype=np.int64)
    local[members] = np.arange(members.size)
    starts = indptr[members]
    counts = (indptr[members + 1] - starts).astype(np.int64)
    gather = indices[np.repeat(starts, counts) + _ragged_arange(counts)]
    mapped = local[gather]
    keep = mapped >= 0
    rows = np.repeat(np.arange(members.size, dtype=np.int64), counts)[keep]
    cols = mapped[keep]
    sub_counts = np.bincount(rows, minlength=members.size)
    sub_indptr = np.zeros(members.size + 1, dtype=np.int64)
    np.cumsum(sub_counts, out=sub_indptr[1:])
    return sub_indptr, cols


def _bfs_levels(indptr, indices, n, start):
    """BFS level of every vertex reachable from start; -1 = unreachable."""
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        starts, ends = indptr[frontier], indptr[frontier + 1]
        if int(np.sum(ends - starts)) == 0:
            break
        idx = np.repeat(starts, ends - starts) + _ragged_arange(ends - starts)
        neigh = np.unique(indices[idx].astype(np.int64))
        neigh = neigh[level[neigh] == -1]
        level[neigh] = d
        frontier = neigh
    return level


def nested_dissection(csr: CSR, leaf_size: int = 64) -> np.ndarray:
    """First-party in-process nested dissection (old2new).

    Recursive bisection with BFS level-structure vertex separators — the
    same scheme METIS's `ndmetis` applies (the reference consumes its
    .iperm files, metis_reorder.cpp:116-141): split each
    subgraph at the median BFS level from a pseudo-peripheral seed, peel
    the boundary of the lower half into a separator, number part A, then
    part B, then the separator LAST (classic ND fill/locality property),
    recursing until `leaf_size` where a local BFS orders the leaf.
    Disconnected pieces split with an empty separator."""
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices, dtype=np.int64)
    n = csr.n_rows
    old2new = np.full(n, -1, dtype=np.int64)

    # explicit stack of (members: global ids, base offset in new order)
    stack = [(np.arange(n, dtype=np.int64), 0)]
    while stack:
        members, base = stack.pop()
        m = members.size
        if m == 0:
            continue
        sub_indptr, sub_indices = _subgraph(indptr, indices, members)
        if m <= leaf_size:
            local = _bfs_order(sub_indptr, sub_indices, m)
            old2new[members] = base + local
            continue
        # pseudo-peripheral seed: BFS from the min-degree vertex, then
        # re-BFS from a farthest vertex (two-sweep heuristic)
        deg = np.diff(sub_indptr)
        seed = int(np.argmin(deg))
        lv = _bfs_levels(sub_indptr, sub_indices, m, seed)
        reached = lv >= 0
        if not np.all(reached):
            # disconnected: component vs rest, no separator needed
            a_loc = np.nonzero(reached)[0]
            b_loc = np.nonzero(~reached)[0]
            stack.append((members[a_loc], base))
            stack.append((members[b_loc], base + a_loc.size))
            continue
        far = int(np.argmax(lv))
        lv = _bfs_levels(sub_indptr, sub_indices, m, far)
        depth = int(lv.max())
        if depth < 2:
            # no level structure to cut (clique-like): leaf-order it
            local = _bfs_order(sub_indptr, sub_indices, m)
            old2new[members] = base + local
            continue
        # cut at the median level; separator = level-L vertices with a
        # neighbor strictly below (so A = {<L} u {L w/o back-edges}? no:
        # classic vertex separator = the level-L set itself, but we trim
        # level-L vertices with no neighbor in {<L} into part B.
        counts = np.bincount(lv, minlength=depth + 1)
        cum = np.cumsum(counts)
        cut = int(np.searchsorted(cum, m // 2))
        cut = min(max(cut, 1), depth - 1)
        sep_mask = lv == cut
        # trim: separator members need a neighbor on the A side
        sep_loc = np.nonzero(sep_mask)[0]
        s_starts = sub_indptr[sep_loc]
        s_counts = sub_indptr[sep_loc + 1] - s_starts
        nb = sub_indices[np.repeat(s_starts, s_counts) + _ragged_arange(s_counts)]
        below = (lv[nb] < cut).astype(np.int64)
        rows = np.repeat(np.arange(sep_loc.size), s_counts)
        has_a_neigh = np.bincount(rows, weights=below, minlength=sep_loc.size) > 0
        sep_loc = sep_loc[has_a_neigh]
        sep_set = np.zeros(m, dtype=bool)
        sep_set[sep_loc] = True
        a_loc = np.nonzero((lv < cut) & ~sep_set)[0]
        b_loc = np.nonzero((lv >= cut) & ~sep_set)[0]
        if a_loc.size == 0 or b_loc.size == 0:
            local = _bfs_order(sub_indptr, sub_indices, m)
            old2new[members] = base + local
            continue
        # numbering: A, then B, then separator last
        stack.append((members[a_loc], base))
        stack.append((members[b_loc], base + a_loc.size))
        sep_members = members[sep_loc]
        old2new[sep_members] = base + a_loc.size + b_loc.size + np.arange(
            sep_loc.size
        )
    assert np.all(old2new >= 0)
    return old2new


def metis_nd(csr: CSR, iperm_path: Optional[str] = None) -> np.ndarray:
    """Nested-dissection ordering: from an `.iperm` file if given
    (the reference's external-`ndmetis` path), else computed in-process
    by the first-party `nested_dissection` above."""
    if iperm_path is not None:
        return load_iperm(iperm_path, csr.n_rows)
    return nested_dissection(csr)


def metis_partition_rcm(
    csr: CSR, n_parts: int = 8192, partition_path: Optional[str] = None,
    impl: str = "native",
) -> np.ndarray:
    """gpmetis<k>_rcmk pipeline. With a partition file, applies it
    directly; else partitions with pymetis where it can be imported, and
    without it on buckets of ~n/n_parts vertices in BFS order (the BFS by
    `impl`), so the pipeline runs without the external binary."""
    if partition_path is not None:
        parts = load_partition(partition_path, csr.n_rows)
    else:
        try:
            import pymetis

            indptr = np.asarray(csr.indptr)
            indices = np.asarray(csr.indices)
            _, membership = pymetis.part_graph(
                min(n_parts, max(2, csr.n_rows // 2)),
                xadj=indptr.tolist(),
                adjncy=indices.tolist(),
            )
            parts = np.asarray(membership, dtype=np.int64)
        except ImportError:
            # graceful degradation: BFS-order buckets of ~n/n_parts
            # vertices approximate a spatial partition
            order = invert_permutation(bfs(csr, impl=impl))
            size = max(1, csr.n_rows // max(1, n_parts))
            parts = np.empty(csr.n_rows, dtype=np.int64)
            parts[order] = np.arange(csr.n_rows) // size
    return partition_rcm(csr, parts)
