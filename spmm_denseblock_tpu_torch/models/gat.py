"""Graph attention network (twin of ``spmm_denseblock_tpu/models/gat.py``):
per-edge scores computed fresh every forward, a softmax over each row's
edges, then the weighted aggregation of the neighbours' projections.

``make_gat_apply`` prepares the edge index vectors and each row's edge
count once; ``apply(params, x)`` then runs, per layer, the projection,
the source and destination scores (``einsum("nhd,hd->nh")``),
leaky_relu(0.2) of their sum on each edge, the row's max (0 where the row
is empty), exp, the row's sum, the divide by max(sum, 1e-16), and the
sum of alpha * hw[col] over the row: concatenated heads with ELU between
layers, the mean over heads after the last. The row reductions are
``torch.segment_reduce`` over the (sorted) rows' edge counts: each row is
summed in edge order, so two runs on the card give the same bits. An
empty row gives 0. There is no residual, norm or dropout (the JAX GAT
has none).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.models.gnn import TreeModule, _glorot
from spmm_denseblock_tpu_torch.ops._device import resolve_device


def init_gat(dims: Sequence[int], heads: int = 2, generator=None,
             device=None) -> List[dict]:
    """dims = [in, hidden..., out] per-head widths; layer i projects
    dims[i] (times heads for i > 0, concatenated) to heads * dims[i+1]."""
    layers = []
    for i in range(len(dims) - 1):
        d_in = dims[i] * (heads if i > 0 else 1)
        d_out = dims[i + 1]
        layers.append({
            "w": _glorot((d_in, heads * d_out), generator, device),
            "a_src": (0.1 * torch.randn((heads, d_out), generator=generator)).to(device),
            "a_dst": (0.1 * torch.randn((heads, d_out), generator=generator)).to(device),
        })
    return layers


class GATApply(nn.Module):
    """apply(params, x) -> (n, dims[-1]) for one graph; holds its edge
    index vectors and row lengths as buffers."""

    def __init__(self, csr: CSR, heads: int, device):
        super().__init__()
        self.heads = heads
        self.register_buffer("row_ids", torch.as_tensor(
            csr.row_ids().astype(np.int64), device=device))
        self.register_buffer("col_ids", torch.as_tensor(
            np.asarray(csr.indices, dtype=np.int64), device=device))
        self.register_buffer("lengths", torch.as_tensor(
            np.diff(np.asarray(csr.indptr, dtype=np.int64)), device=device))

    def _rows(self, v: torch.Tensor, reduce: str) -> torch.Tensor:
        return torch.segment_reduce(v, reduce, lengths=self.lengths, axis=0)

    def layer(self, p: dict, h: torch.Tensor, concat: bool) -> torch.Tensor:
        n, heads = h.shape[0], self.heads
        d_out = p["a_src"].shape[1]
        hw = torch.matmul(h, p["w"]).reshape(n, heads, d_out)  # (n, H, d)
        s_src = torch.einsum("nhd,hd->nh", hw, p["a_src"])  # (n, H)
        s_dst = torch.einsum("nhd,hd->nh", hw, p["a_dst"])
        e = F.leaky_relu(s_src.index_select(0, self.row_ids)
                         + s_dst.index_select(0, self.col_ids),
                         negative_slope=0.2)  # (nnz, H)
        e_max = self._rows(e, "max")
        e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
        w = torch.exp(e - e_max.index_select(0, self.row_ids))
        denom = self._rows(w, "sum")
        alpha = w / torch.clamp(denom.index_select(0, self.row_ids), min=1e-16)
        contrib = alpha[:, :, None] * hw.index_select(0, self.col_ids)
        out = self._rows(contrib, "sum")  # (n, H, d)
        return out.reshape(n, heads * d_out) if concat else out.mean(dim=1)

    def forward(self, params: List[dict], x) -> torch.Tensor:
        h = torch.as_tensor(x, device=self.row_ids.device)
        for i, p in enumerate(params):
            last = i == len(params) - 1
            h = self.layer(p, h, concat=not last)
            if not last:
                h = F.elu(h)
        return h


def make_gat_apply(csr: CSR, heads: int = 2, device=None) -> GATApply:
    """Prepare the edge indices once -> apply(params, x) -> (n, d_last)
    (the last layer averages its heads). device: None is the card."""
    return GATApply(csr, heads, resolve_device(device))


class GAT(TreeModule):
    """GAT parameters; forward(apply, x) as apply(params, x) with apply
    from make_gat_apply."""

    def __init__(self, dims: Sequence[int], heads: int = 2, generator=None,
                 device=None):
        super().__init__(init_gat(dims, heads, generator, device))
        self.dims, self.heads = list(dims), heads

    def forward(self, apply: GATApply, x) -> torch.Tensor:
        return apply(self.params(), x)
