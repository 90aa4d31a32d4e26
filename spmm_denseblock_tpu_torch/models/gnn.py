"""GCN over an injected SpMM (twin of the GCN in
``spmm_denseblock_tpu/models/gnn.py``).

The sparse aggregation is any callable C = A @ H, normally a plan from
``ops.dispatch.spmm_plan`` built on ``sym_norm_adjacency``. Weights are
stored (d_in, d_out) so that a layer is ``x @ w + b`` as in the JAX
package; the dense transform stays ``torch.matmul``, as the JAX package
leaves it to XLA. On a GPU, run with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) to keep the f32
1e-4 gate.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
from torch import nn

SpMM = Callable[[torch.Tensor], torch.Tensor]


def _glorot(shape, generator=None, device=None) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (scale * w).to(device)


def init_linear(d_in: int, d_out: int, generator=None, device=None) -> dict:
    return {
        "w": _glorot((d_in, d_out), generator, device),
        "b": torch.zeros(d_out, dtype=torch.float32, device=device),
    }


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def init_gcn(dims: Sequence[int], generator=None, device=None) -> List[dict]:
    """dims = [in, hidden..., out]; Glorot-normal weights drawn from
    `generator` (a torch.Generator), zero biases."""
    return [
        init_linear(a, b, generator, device) for a, b in zip(dims[:-1], dims[1:])
    ]


def gcn_apply(params: List[dict], spmm: SpMM, x: torch.Tensor) -> torch.Tensor:
    """h <- relu(A h W + b) per layer, no relu after the last."""
    h = x
    for i, p in enumerate(params):
        h = linear(p, spmm(h))
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def gcn_params_from_jax(params, device=None) -> List[dict]:
    """The JAX package's init_gcn output (a list of {"w", "b"}, as numpy
    arrays) as this port's parameters."""
    return [
        {
            k: torch.tensor(np.asarray(p[k], dtype=np.float32), device=device)
            for k in ("w", "b")
        }
        for p in params
    ]


class GCN(nn.Module):
    """Kipf-Welling GCN; forward(spmm, x) as gcn_apply(params, spmm, x)."""

    def __init__(self, dims: Sequence[int], generator=None, device=None):
        super().__init__()
        self.dims = list(dims)
        params = init_gcn(self.dims, generator, device)
        self.weights = nn.ParameterList(nn.Parameter(p["w"]) for p in params)
        self.biases = nn.ParameterList(nn.Parameter(p["b"]) for p in params)

    def params(self) -> List[dict]:
        return [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)]

    @torch.no_grad()
    def load_params(self, params: List[dict]) -> "GCN":
        """Copy a list of {"w", "b"} (numpy arrays or tensors) in."""
        for mine, theirs in zip(self.params(), params):
            for k in ("w", "b"):
                mine[k].copy_(torch.as_tensor(theirs[k]))
        return self

    def forward(self, spmm: SpMM, x: torch.Tensor) -> torch.Tensor:
        return gcn_apply(self.params(), spmm, x)
