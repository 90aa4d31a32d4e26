"""The GNN model family over an injected SpMM: GCN (Kipf-Welling),
GraphSAGE (mean), GIN and the GIN graph classifier (twin of
``spmm_denseblock_tpu/models/gnn.py``).

The sparse aggregation is any callable C = A @ H, normally a plan from
``ops.dispatch.spmm_plan``: built on ``sym_norm_adjacency`` for GCN, on
``mean_adjacency`` for SAGE and on the raw adjacency for GIN. Parameters
are nested lists and dicts of tensors, as the JAX package's pytrees, and
weights are stored (d_in, d_out) so that a layer is ``x @ w + b``; the
dense transforms stay ``torch.matmul``, as the JAX package leaves them
to XLA. On a GPU, run with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``) to keep the f32
1e-4 gate. Every init draws from the given ``torch.Generator``; the
parameters land on ``device`` (None: torch's default, the CPU).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spmm_denseblock_tpu_torch.models.checkpoint import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

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


def gcn_apply(params: List[dict], spmm: SpMM, x: torch.Tensor,
              remat: bool = False, dense=linear) -> torch.Tensor:
    """h <- relu(A h W + b) per layer, no relu after the last. remat=True
    recomputes each layer's activations in the backward pass instead of
    storing them (torch.utils.checkpoint, JAX's jax.checkpoint). dense:
    the layer's x @ w + b (the distributed step passes its own, which
    gathers the feature slices first; parallel/train.py)."""

    def layer(p, h, act):
        h = dense(p, spmm(h))
        return torch.relu(h) if act else h

    h = x
    for i, p in enumerate(params):
        act = i < len(params) - 1
        h = (checkpoint(layer, p, h, act, use_reentrant=False) if remat
             else layer(p, h, act))
    return h


# -- GraphSAGE (mean aggregator) --------------------------------------------


def init_sage(dims: Sequence[int], generator=None, device=None) -> List[dict]:
    """dims = [in, hidden..., out]; expects spmm built from
    mean_adjacency. Per layer a self and a neighbour linear."""
    return [
        {"self": init_linear(a, b, generator, device),
         "neigh": init_linear(a, b, generator, device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def sage_apply(params: List[dict], spmm: SpMM, x: torch.Tensor,
               dense=linear) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = dense(p["self"], h) + dense(p["neigh"], spmm(h))
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


# -- GIN ---------------------------------------------------------------------


def init_gin(dims: Sequence[int], mlp_hidden: int = 0, generator=None,
             device=None) -> List[dict]:
    """Expects spmm built from the raw adjacency (sum aggregator). Per
    layer a trainable 0-d eps and a two-layer MLP of hidden width
    mlp_hidden (0: the layer's output width)."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        hid = mlp_hidden or b
        layers.append({
            "eps": torch.zeros((), dtype=torch.float32, device=device),
            "mlp1": init_linear(a, hid, generator, device),
            "mlp2": init_linear(hid, b, generator, device),
        })
    return layers


def gin_apply(params: List[dict], spmm: SpMM, x: torch.Tensor,
              dense=linear) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = (1.0 + p["eps"]) * h + spmm(h)
        h = dense(p["mlp2"], torch.relu(dense(p["mlp1"], h)))
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


MODELS = {
    "gcn": (init_gcn, gcn_apply),
    "sage": (init_sage, sage_apply),
    "gin": (init_gin, gin_apply),
}


# -- graph-level readout (ogbg-style classification) -------------------------


def init_graph_classifier(dims: Sequence[int], n_graph_classes: int,
                          generator=None, device=None) -> dict:
    """GIN trunk + mean-pool readout + linear head, for batched
    block-diagonal molecule graphs (io/datasets.synthetic_molecules)."""
    return {
        "gin": init_gin(dims, generator=generator, device=device),
        "head": init_linear(dims[-1], n_graph_classes, generator, device),
    }


def graph_classifier_apply(params: dict, spmm: SpMM, x: torch.Tensor,
                           graph_ids, n_graphs: int) -> torch.Tensor:
    """(n_graphs, n_classes) logits. Mean pooling by two segment sums
    (sum / count, counts clamped at 1) over sorted graph_ids; ids at or
    past n_graphs are dropped, as JAX's segment_sum drops them.
    torch.segment_reduce sums each graph's rows in order, so two runs on
    the card give the same bits."""
    h = gin_apply(params["gin"], spmm, x)
    graph_ids = torch.as_tensor(graph_ids, device=h.device).long()
    lengths = torch.bincount(graph_ids, minlength=n_graphs)
    sums = torch.segment_reduce(h, "sum", lengths=lengths, axis=0)[:n_graphs]
    counts = lengths[:n_graphs].to(h.dtype).clamp(min=1.0)[:, None]
    return linear(params["head"], sums / counts)


def params_from_jax(tree, device=None):
    """A JAX init's output (any nested list/dict of numpy arrays) as
    tensors of the same structure and dtypes."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


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


class TreeModule(nn.Module):
    """Holds a parameter tree (nested lists and dicts of tensors) as
    nn.Parameters, registered as p0, p1, ... in JAX's leaf order;
    params() gives the tree back, its leaves the parameters themselves."""

    def __init__(self, tree):
        super().__init__()
        self._skeleton = tree_map(lambda _: 0, tree)
        for i, leaf in enumerate(tree_leaves(tree)):
            self.register_parameter(f"p{i}", nn.Parameter(leaf))

    def params(self):
        return tree_unflatten(self._skeleton, list(self.parameters()))

    @torch.no_grad()
    def load_params(self, tree) -> "TreeModule":
        """Copy a tree of the same structure (numpy arrays or tensors) in."""
        for mine, theirs in zip(self.parameters(), tree_leaves(tree)):
            mine.copy_(theirs if torch.is_tensor(theirs) else torch.from_numpy(
                np.array(theirs)))
        return self


class GCN(TreeModule):
    """Kipf-Welling GCN; forward(spmm, x) as gcn_apply(params, spmm, x)."""

    def __init__(self, dims: Sequence[int], generator=None, device=None):
        super().__init__(init_gcn(dims, generator, device))
        self.dims = list(dims)

    def forward(self, spmm: SpMM, x: torch.Tensor) -> torch.Tensor:
        return gcn_apply(self.params(), spmm, x)


class SAGE(TreeModule):
    """GraphSAGE (mean); forward(spmm, x) as sage_apply(params, spmm, x)."""

    def __init__(self, dims: Sequence[int], generator=None, device=None):
        super().__init__(init_sage(dims, generator, device))
        self.dims = list(dims)

    def forward(self, spmm: SpMM, x: torch.Tensor) -> torch.Tensor:
        return sage_apply(self.params(), spmm, x)


class GIN(TreeModule):
    """GIN; forward(spmm, x) as gin_apply(params, spmm, x)."""

    def __init__(self, dims: Sequence[int], mlp_hidden: int = 0, generator=None,
                 device=None):
        super().__init__(init_gin(dims, mlp_hidden, generator, device))
        self.dims = list(dims)

    def forward(self, spmm: SpMM, x: torch.Tensor) -> torch.Tensor:
        return gin_apply(self.params(), spmm, x)


class GraphClassifier(TreeModule):
    """GIN trunk, mean pooling, linear head; forward(spmm, x, graph_ids,
    n_graphs) as graph_classifier_apply."""

    def __init__(self, dims: Sequence[int], n_graph_classes: int, generator=None,
                 device=None):
        super().__init__(init_graph_classifier(dims, n_graph_classes, generator,
                                               device))
        self.dims = list(dims)

    def forward(self, spmm: SpMM, x: torch.Tensor, graph_ids,
                n_graphs: int) -> torch.Tensor:
        return graph_classifier_apply(self.params(), spmm, x, graph_ids, n_graphs)
