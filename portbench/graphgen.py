"""The stand-in graph, frozen inside the benchmark.

A copy of ``synthetic_powerlaw`` from ``spmm_denseblock_tpu_torch/io/
datasets.py`` at commit a9b8f82 (the generator the port and the JAX
package share), returning the raw symmetric edge list instead of a CSR:
hub endpoints with Zipf-like weights, a share of short-range community
edges, node ids scrambled at the end, both directions of every edge,
self-loops dropped and duplicate edges kept. The graph stands for a
fixed OGB graph, so it depends on the configuration's seed and never on
a run's ``--seed``.

The edge list is cached in ``portbench/cache/graphs/`` under a name made
of the configuration's numbers, so only a checkout's first run pays the
generation.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / "cache" / "graphs"


def synthetic_powerlaw_edges(n: int, nnz: int, seed: int = 1234,
                             clustering: float = 0.5, triadic: float = 0.0,
                             lattice: float = 0.0) -> np.ndarray:
    """(E, 2) int64 directed edges, both directions of each, no self-loops.
    The source's ``clique`` knob is left out: no configuration sets it."""
    rng = np.random.default_rng(seed)
    m = nnz // 2
    alpha = 3.0
    src = (n * rng.random(m) ** alpha).astype(np.int64) % n
    n_lat = int(m * lattice)
    n_local = int(m * clustering * (1.0 - lattice))
    local_src = rng.integers(0, n, size=n_local, dtype=np.int64)
    local_dst = (local_src + rng.integers(-64, 65, size=n_local)) % n
    far_dst = (n * rng.random(m - n_lat - n_local) ** alpha).astype(np.int64) % n
    dst = np.concatenate([local_dst, far_dst])
    src = np.concatenate([local_src, src[: m - n_lat - n_local]])
    if n_lat:
        k = max(1, -(-n_lat // n))
        base = np.arange(n, dtype=np.int64)
        lat_src = np.tile(base, k)[:n_lat]
        lat_dst = (lat_src + np.repeat(np.arange(1, k + 1, dtype=np.int64), n)[:n_lat]) % n
        src = np.concatenate([lat_src, src])
        dst = np.concatenate([lat_dst, dst])
    if triadic > 0:
        k = int(m * triadic) // 2
        if k:
            sac = rng.choice(m, size=k, replace=False)
            wedge = rng.integers(0, m, size=k)
            order = np.argsort(src, kind="stable")
            pos = np.minimum(np.searchsorted(src[order], dst[wedge]), m - 1)
            w = dst[order][pos]
            u = src[wedge].copy()
            valid = (src[order][pos] == dst[wedge]) & (w != u)
            src[sac] = np.where(valid, u, src[sac])
            dst[sac] = np.where(valid, w, dst[sac])
    scramble = rng.permutation(n)
    src, dst = scramble[src], scramble[dst]
    edges = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])], 1)
    return edges[edges[:, 0] != edges[:, 1]]


def graph_size(graph: dict, scale: float = 1.0):
    """(n, nnz) of the configuration's graph; `scale` < 1 only in the
    CPU dry run, with the source's floors of 16 nodes and 64 edges."""
    if scale == 1.0:
        return int(graph["n"]), int(graph["nnz"])
    return max(16, int(graph["n"] * scale)), max(64, int(graph["nnz"] * scale))


def load_edges(graph: dict, scale: float = 1.0, cache: Path = CACHE):
    """(n, edges): the configuration's stand-in graph, from the cache or
    generated and cached. edges is (E, 2) int64."""
    n, nnz = graph_size(graph, scale)
    seed = int(graph["seed"])
    knobs = graph.get("knobs", {})
    tag = "-".join([graph["dataset"], f"n{n}", f"nnz{nnz}", f"seed{seed}"]
                   + [f"{k}{v}" for k, v in sorted(knobs.items())])
    path = cache / f"{tag}.npy"
    if path.exists():
        return n, np.load(path)
    edges = synthetic_powerlaw_edges(n, nnz, seed=seed, **knobs)
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
    np.save(tmp, edges)
    os.replace(tmp, path)
    return n, edges
