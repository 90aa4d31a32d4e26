"""The GAT (Veličković et al., arXiv:1710.10903) of a configuration, as the
yardstick sees it: its weights drawn from the seed, its plain reference
and its work. It imports nothing of the program;
``portbench/systems/graph_attention.py`` is the program's side.

Each layer, for each head h of d columns: hw = h W, a score per node
s_src = hw_h . a_src[h] and s_dst = hw_h . a_dst[h], a score per edge
e_ij = leaky_relu_0.2(s_src[i] + s_dst[j]), alpha the softmax of each
row's scores, out_i = sum_j alpha_ij hw_h[j], plus h_i res where the
configuration has ``residual`` (DGL's bias-free residual projection,
res the shape of W); the heads concatenated with ELU between layers,
the last layer's heads averaged.

Configuration keys: ``dims`` ([in, per-head widths...]), ``heads``,
``residual``, ``graph`` and ``attention`` (the pattern's entries, ``nnz``, which the
work figures count). The files are named ``graph_attention``, not
``gat``: the benchmark's spec tests use "gat" as their example of a
model that has no files.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from portbench import work

# edges a block of the aggregation: rows come in order, so a block is a
# band of rows, and no whole (edges, heads, d) tensor is made (in float64
# at the configuration's size it would be 14.7 GB; a block at d = 250 and
# 3 heads is 393 MB)
EDGE_BLOCK = 1 << 16


def init_params(config: dict, generator: torch.Generator, device) -> List[dict]:
    """Glorot-normal projections w (d_in, heads x d), attention vectors
    a_src, a_dst (heads, d) and, with ``residual``, residual projections
    res of w's shape, drawn on the device in one call."""
    dims, heads = config["dims"], config["heads"]
    names = ("w", "a_src", "a_dst") + (("res",) if config.get("residual") else ())
    shapes = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        d_in = a * (heads if i else 1)
        w = ((d_in, heads * b), math.sqrt(2.0 / (d_in + heads * b)))
        shapes += [w] + [((heads, b), math.sqrt(2.0 / (1 + b)))] * 2
        shapes += [w] * (len(names) - 3)
    flat = torch.randn(sum(s[0] * s[1] for s, _ in shapes), generator=generator,
                       device=device)
    tensors, off = [], 0
    for (r, c), std in shapes:
        tensors.append(flat[off: off + r * c].view(r, c) * std)
        off += r * c
    k = len(names)
    return [dict(zip(names, tensors[i: i + k])) for i in range(0, len(tensors), k)]


def leaves(params: List[dict]) -> List[torch.Tensor]:
    """(w, a_src, a_dst[, res]) layer by layer: the order every per-leaf
    number uses."""
    return [t for p in params for t in p.values()]


def adjacency(edges, n: int, dtype, device) -> dict:
    """The attention pattern from the raw edge list: each edge both ways,
    duplicates merged, self-loops dropped, then one self-loop on every
    node; rows and columns of its entries, in row order. Values come
    with each forward, so `dtype` is not used."""
    e = torch.as_tensor(edges, device=device).long()
    e = e[e[:, 0] != e[:, 1]]
    loops = torch.arange(n, device=device)
    key = torch.unique(torch.cat([e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0],
                                  loops * (n + 1)]))
    return {"rows": key // n, "cols": key % n, "n": n}


def forward(adj: dict, params: List[dict], x: torch.Tensor, prec,
            edge_block: int = EDGE_BLOCK) -> torch.Tensor:
    """The GAT's output (n, dims[-1]); the projections through
    prec.matmul, the aggregation in blocks of `edge_block` edges."""
    rows, cols, n = adj["rows"], adj["cols"], adj["n"]
    h = x
    for i, p in enumerate(params):
        last = i == len(params) - 1
        heads, d = p["a_src"].shape
        hw = prec.matmul(h, p["w"]).view(n, heads, d)
        s_src = (hw * p["a_src"]).sum(-1)  # (n, heads)
        s_dst = (hw * p["a_dst"]).sum(-1)
        e = F.leaky_relu(s_src[rows] + s_dst[cols], negative_slope=0.2)
        idx = rows[:, None].expand(-1, heads)
        e_max = torch.full((n, heads), -math.inf, dtype=e.dtype, device=e.device)
        e_max = e_max.scatter_reduce(0, idx, e, "amax")
        w = torch.exp(e - e_max[rows])
        alpha = w / torch.zeros_like(e_max).index_add(0, rows, w)[rows]
        out = torch.zeros(n, heads, d, dtype=hw.dtype, device=hw.device)
        for b0 in range(0, rows.numel(), edge_block):
            r, c = rows[b0: b0 + edge_block], cols[b0: b0 + edge_block]
            out = out.index_add(0, r, alpha[b0: b0 + edge_block, :, None] * hw[c])
        if "res" in p:
            out = out + prec.matmul(h, p["res"]).view(n, heads, d)
        h = out.mean(1) if last else F.elu(out.reshape(n, heads * d))
    return h


def _entries(config: dict, n: int, nnz: int) -> int:
    """The attention pattern's entries: the configuration's figure at its
    size (the harness's len(edges) + n counts reciprocal and duplicate
    edges apart), else, in the CPU dry run's cut graph, `nnz`."""
    return config["attention"]["nnz"] if n == config["graph"]["n"] else nnz


def _widths(config: dict):
    """(F_in, F) of each layer's projection: F = heads x d is also the
    width of its aggregation."""
    dims, heads = config["dims"], config["heads"]
    return [(a * (heads if i else 1), heads * b)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def flops(config: dict, n: int, nnz: int, train: bool) -> int:
    """Model FLOPs of one request: per layer the projection 2·n·F_in·F
    (twice with the residual projection), the two node scores 4·n·F and the aggregation 2·E·F (E the pattern's
    entries); the edge softmax's elementwise work is not counted. A
    training step would add each layer's weight gradient, the input
    gradient of layers 2.., and the aggregation's two backward products
    (over alpha, and over hw) at 2·E·F each."""
    E = _entries(config, n, nnz)
    total = 0
    for i, (f_in, f) in enumerate(_widths(config)):
        dense = 2 * n * f_in * f * (2 if config.get("residual") else 1)
        total += dense + 4 * n * f + 2 * E * f
        if train:
            total += dense * (2 if i else 1) + 4 * E * f
    return total


def spmm_bound_s(config: dict, n: int, nnz: int, train: bool,
                 precision: str) -> float:
    """The least time an H100 could take for the edge attention's
    aggregations of a request: per layer the CSR bound at F = heads x d
    with heads f32 values an entry (work.csr_spmm_bytes, value_bytes =
    4·heads), against the FLOPs at the precision's peak. A training step
    would run each twice (forward, and the transposed backward). The
    scores and the softmax are not counted, though the adapter's pb.spmm
    span times them too: spmm_roofline reads the aggregations' bound over
    the whole edge attention's time."""
    E, heads = _entries(config, n, nnz), config["heads"]
    one = sum(max(work.csr_spmm_ops(E, f) / work.PEAK_OPS_S[precision],
                  work.csr_spmm_bytes(E, n, n, f, value_bytes=4 * heads)
                  / work.HBM_BYTES_S)
              for _, f in _widths(config))
    return one * (2 if train else 1)
