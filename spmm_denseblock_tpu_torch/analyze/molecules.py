"""Per-molecule reorder and the block-utilization study over a batch of
small graphs (twin of ``spmm_denseblock_tpu/analyze/molecules.py``).

The reference's ogbg-code / ogbg-molhiv studies reorder each small graph
on its own and report the average block utilization over the first 100
graphs (ogbg_code_rcmk.py:60-76, ogbg_molhiv.py:5-52). Here the batch is
one block-diagonal adjacency (io.datasets.synthetic_molecules), so the
per-graph permutations compose into one global permutation.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from spmm_denseblock_tpu_torch.analyze.metrics import block_metrics
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.reorder import STRATEGIES, permutate


def _subgraph(csr: CSR, lo: int, hi: int) -> CSR:
    """Rows/cols [lo, hi) of a block-diagonal CSR (every edge of these
    rows stays inside the range by construction)."""
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    s, e = int(indptr[lo]), int(indptr[hi])
    sub_indptr = (indptr[lo : hi + 1] - indptr[lo]).astype(np.int32)
    sub_indices = (indices[s:e] - lo).astype(np.int32)
    if sub_indices.min(initial=0) < 0 or sub_indices.max(initial=0) >= hi - lo:
        raise ValueError("adjacency is not block-diagonal at this graph boundary")
    data = None if csr.data is None else np.asarray(csr.data)[s:e]
    return CSR(sub_indptr, sub_indices, data, (hi - lo, hi - lo))


def per_graph_reorder(
    csr: CSR, graph_ids: np.ndarray, strategy: str = "rcmk", **kw
) -> np.ndarray:
    """Reorder every graph of a block-diagonal batch independently;
    returns ONE global old2new permutation (each graph's vertices stay
    inside its own range, so graph_ids are unchanged under it)."""
    graph_ids = np.asarray(graph_ids)
    n = csr.n_rows
    if graph_ids.shape != (n,):
        raise ValueError(f"graph_ids of shape {graph_ids.shape}, expected ({n},)")
    # graphs are contiguous ranges (synthetic_molecules contract)
    boundaries = np.concatenate(
        [[0], np.nonzero(np.diff(graph_ids))[0] + 1, [n]]
    )
    fn = STRATEGIES[strategy]
    old2new = np.empty(n, dtype=np.int64)
    for g in range(boundaries.size - 1):
        lo, hi = int(boundaries[g]), int(boundaries[g + 1])
        sub = _subgraph(csr, lo, hi)
        old2new[lo:hi] = fn(sub, **kw) + lo
    return old2new


def molecule_utilization_study(
    csr: CSR,
    graph_ids: np.ndarray,
    strategies: Sequence[str] = ("original", "rcmk", "closest"),
    block_sizes: Sequence[int] = (2, 4, 8, 16, 32),
    n_graphs: int = 100,
) -> Dict[str, Dict[int, Dict[str, float]]]:
    """The reference's 100-graph average-utilization table
    (ogbg_code_rcmk.py:60-76): for each strategy, reorder each of the
    first `n_graphs` graphs independently and average block
    density/utilization over the graphs (unweighted mean over graphs,
    like the reference's running sum / count)."""
    graph_ids = np.asarray(graph_ids)
    boundaries = np.concatenate(
        [[0], np.nonzero(np.diff(graph_ids))[0] + 1, [csr.n_rows]]
    )
    n_graphs = min(n_graphs, boundaries.size - 1)
    out: Dict[str, Dict[int, Dict[str, float]]] = {}
    for strat in strategies:
        sums = {b: {"density": 0.0, "utilization": 0.0} for b in block_sizes}
        counted = {b: 0 for b in block_sizes}
        for g in range(n_graphs):
            lo, hi = int(boundaries[g]), int(boundaries[g + 1])
            sub = _subgraph(csr, lo, hi)
            if sub.nnz == 0:
                continue
            if strat != "original":
                sub = permutate(STRATEGIES[strat](sub), sub)
            m = block_metrics(sub, block_sizes)
            for b in block_sizes:
                sums[b]["density"] += m[b]["density"]
                sums[b]["utilization"] += m[b]["utilization"]
                counted[b] += 1
        out[strat] = {
            b: {
                "density": sums[b]["density"] / max(counted[b], 1),
                "utilization": sums[b]["utilization"] / max(counted[b], 1),
                "n_graphs": counted[b],
            }
            for b in block_sizes
        }
    return out
