"""The GCN (Kipf and Welling) of a configuration, as the yardstick sees it:
its weights drawn from the seed, its plain reference and its work. It
imports nothing of the program; ``portbench/systems/gcn.py`` is the
program's side.

Configuration keys: ``dims`` ([in, hidden..., out]), ``lr``,
``train_nodes`` and ``graph``.
"""

from __future__ import annotations

import math
from typing import List

import torch

from portbench import reference, work

adjacency = reference.sym_norm


def init_params(config: dict, generator: torch.Generator, device) -> List[dict]:
    """Glorot-normal weights and zero biases, drawn on the device in one
    call."""
    dims = config["dims"]
    shapes = list(zip(dims[:-1], dims[1:]))
    flat = torch.randn(sum(a * b for a, b in shapes), generator=generator,
                       device=device)
    params, off = [], 0
    for a, b in shapes:
        w = flat[off: off + a * b].view(a, b) * math.sqrt(2.0 / (a + b))
        params.append({"w": w, "b": torch.zeros(b, device=device)})
        off += a * b
    return params


def leaves(params: List[dict]) -> List[torch.Tensor]:
    """(w, b) layer by layer: the order every per-leaf number uses."""
    return [p[k] for p in params for k in ("w", "b")]


def forward(adj, params: List[dict], x: torch.Tensor, prec) -> torch.Tensor:
    """h <- relu(A h W + b) per layer, no relu after the last."""
    h = x
    for i, p in enumerate(params):
        h = prec.matmul(reference.spmm(adj, h), p["w"]) + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def flops(config: dict, n: int, nnz: int, train: bool) -> int:
    return work.gcn_flops(nnz, n, config["dims"], train)


def spmm_bound_s(config: dict, n: int, nnz: int, train: bool,
                 precision: str) -> float:
    return work.gcn_spmm_bound_s(nnz, n, config["dims"], train, precision)
