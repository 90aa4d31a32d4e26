"""Strategy registry and the reorder entry points (twin of
``spmm_denseblock_tpu/reorder/registry.py``). The sweep names are the
reference's benchmark grid ('original', 'rcmk', 'rabbit') plus the
offline tools it drives."""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.io.graph_io import dump_permutation, load_permutation
from spmm_denseblock_tpu_torch.reorder.base import check_permutation, identity, permutate
from spmm_denseblock_tpu_torch.reorder.gorder import gorder
from spmm_denseblock_tpu_torch.reorder.greedy import greedy_closest
from spmm_denseblock_tpu_torch.reorder.metis import metis_partition_rcm, nested_dissection
from spmm_denseblock_tpu_torch.reorder.rabbit import rabbit_order
from spmm_denseblock_tpu_torch.reorder.simple import (
    bfs,
    max_degree_sort,
    rcm_classic,
    rcm_variant,
)

STRATEGIES: Dict[str, Callable[[CSR], np.ndarray]] = {
    "original": identity,
    "degree": max_degree_sort,
    "bfs": bfs,
    "rcmk": rcm_variant,  # descending-degree BFS variant
    "rcm": rcm_classic,
    "gorder": gorder,
    "rabbit": rabbit_order,
    "closest": greedy_closest,
    "gpmetis_rcmk": metis_partition_rcm,
    "ndmetis": nested_dissection,  # in-process nested dissection
}


def reorder(csr: CSR, strategy: str = "rcmk", **kw):
    """Compute old2new for `strategy` and apply it. Returns
    (reordered_csr, old2new)."""
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; have {sorted(STRATEGIES)}")
    old2new = STRATEGIES[strategy](csr, **kw)
    check_permutation(old2new, csr.n_rows)
    return permutate(old2new, csr), old2new


def reorder_cached(
    csr: CSR, strategy: str, cache_dir: str = "tmp", tag: str = "graph", **kw
):
    """reorder() that keeps old2new in `<cache_dir>/<tag>_<strategy>.txt`
    and reuses it on the next call. Returns (reordered_csr, old2new)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{tag}_{strategy}.txt")
    if os.path.exists(path):
        old2new = load_permutation(path)
        check_permutation(old2new, csr.n_rows)
        return permutate(old2new, csr), old2new
    reordered, old2new = reorder(csr, strategy, **kw)
    dump_permutation(old2new, path)
    return reordered, old2new
