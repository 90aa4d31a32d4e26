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
empty row gives 0. There is no norm or dropout (the JAX GAT has none),
and the residual is an option (below).

Two routes for the weighted aggregation, chosen with each call. A call
that needs no gradient, on f32 features, multiplies by a pattern plan of
the graph built once with ``spmm_plan(csr, values="call")``
(``ops/plan``): ``plan(hw, values=alpha)`` with alpha (H, nnz) in the
graph's entry order, so no (nnz, H, d) tensor exists. Any other call
(training, a float64 reference) takes the JAX twin's route: it gathers
hw[col] into an (nnz, H, d) tensor, multiplies it by alpha and sums each
row with segment_reduce. The scores and the softmax are the same ops on
both routes; each row reduction runs in pieces of ROW_PIECE entries,
then the pieces, with no wait for the device. Each layer's scores and
softmax run in the span ``sdb.gat_scores`` while program tracing is on
(``utils/profiling``).

``init_gat(..., residual=True)`` adds DGL's residual projection: each
layer's input times ``res`` (d_in, H·d), bias-free, added to its output
before the heads are joined.
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
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan
from spmm_denseblock_tpu_torch.utils import profiling

# entries of a row reduced in one piece: the row reductions run in two
# levels, pieces then rows, so that no thread of segment_reduce walks a
# hub row alone
ROW_PIECE = 256


def init_gat(dims: Sequence[int], heads: int = 2, generator=None,
             device=None, residual: bool = False) -> List[dict]:
    """dims = [in, hidden..., out] per-head widths; layer i projects
    dims[i] (times heads for i > 0, concatenated) to heads * dims[i+1].
    residual: each layer also holds res, the same shape as w, drawn after
    every layer's w, a_src and a_dst (the JAX twin has none)."""
    layers = []
    for i in range(len(dims) - 1):
        d_in = dims[i] * (heads if i > 0 else 1)
        d_out = dims[i + 1]
        layers.append({
            "w": _glorot((d_in, heads * d_out), generator, device),
            "a_src": (0.1 * torch.randn((heads, d_out), generator=generator)).to(device),
            "a_dst": (0.1 * torch.randn((heads, d_out), generator=generator)).to(device),
        })
    if residual:
        for p in layers:
            p["res"] = _glorot(tuple(p["w"].shape), generator, device)
    return layers


class GATApply(nn.Module):
    """apply(params, x) -> (n, dims[-1]) for one graph; holds its edge
    index vectors, its row and piece lengths as buffers, and its pattern
    plan."""

    def __init__(self, csr: CSR, heads: int, device, plan=None, **plan_kw):
        super().__init__()
        self.heads = heads
        deg = np.diff(np.asarray(csr.indptr, dtype=np.int64))
        self.register_buffer("row_ids", torch.as_tensor(
            csr.row_ids().astype(np.int64), device=device))
        self.register_buffer("col_ids", torch.as_tensor(
            np.asarray(csr.indices, dtype=np.int64), device=device))
        pieces = np.maximum(1, -(-deg // ROW_PIECE))
        rank = (np.arange(int(pieces.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(pieces) - pieces, pieces))
        self.register_buffer("piece_lengths", torch.as_tensor(
            np.minimum(ROW_PIECE, np.repeat(deg, pieces) - rank * ROW_PIECE),
            device=device))
        self.register_buffer("row_pieces", torch.as_tensor(pieces, device=device))
        self.plan = plan if plan is not None else spmm_plan(
            csr, values="call", device=device, **plan_kw)

    def _rows(self, v: torch.Tensor, reduce: str) -> torch.Tensor:
        # the lengths come from a CSR: unsafe skips their checks, each a
        # wait for the device
        part = torch.segment_reduce(v, reduce, lengths=self.piece_lengths, axis=0,
                                    unsafe=True)
        return torch.segment_reduce(part, reduce, lengths=self.row_pieces, axis=0,
                                    unsafe=True)

    def scores(self, p: dict, hw: torch.Tensor) -> torch.Tensor:
        """alpha (nnz, H): each row's softmax of its edges' scores."""
        hw = hw.reshape(hw.shape[0], self.heads, -1)  # (n, H, d)
        s_src = torch.einsum("nhd,hd->nh", hw, p["a_src"])  # (n, H)
        s_dst = torch.einsum("nhd,hd->nh", hw, p["a_dst"])
        e = F.leaky_relu(s_src.index_select(0, self.row_ids)
                         + s_dst.index_select(0, self.col_ids),
                         negative_slope=0.2)  # (nnz, H)
        e_max = self._rows(e, "max")
        e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
        w = torch.exp(e - e_max.index_select(0, self.row_ids))
        denom = self._rows(w, "sum")
        return w / torch.clamp(denom.index_select(0, self.row_ids), min=1e-16)

    def attend(self, p: dict, hw: torch.Tensor, route_plan: bool) -> torch.Tensor:
        """A layer's edge attention: (n, H·d) projections -> (n, H·d), each
        row the alpha-weighted sum of its neighbours' projections, through
        the pattern plan where route_plan."""
        with profiling.span("sdb.gat_scores"):
            alpha = self.scores(p, hw)
        if route_plan:
            return self.plan(hw, values=alpha.T.contiguous())
        n = hw.shape[0]
        contrib = (alpha[:, :, None]
                   * hw.reshape(n, self.heads, -1).index_select(0, self.col_ids))
        return self._rows(contrib, "sum").reshape(n, -1)  # (n, H·d)

    def layer(self, p: dict, h: torch.Tensor, concat: bool,
              route_plan: bool) -> torch.Tensor:
        out = self.attend(p, torch.matmul(h, p["w"]), route_plan)  # (n, H·d)
        if "res" in p:
            out = out + torch.matmul(h, p["res"])
        return out if concat else out.reshape(h.shape[0], self.heads, -1).mean(dim=1)

    def forward(self, params: List[dict], x) -> torch.Tensor:
        h = torch.as_tensor(x, device=self.row_ids.device)
        # the plan gives no gradient and computes in f32
        route_plan = h.dtype == torch.float32 and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, *(v for p in params for v in p.values()))))
        for i, p in enumerate(params):
            last = i == len(params) - 1
            h = self.layer(p, h, not last, route_plan)
            if not last:
                h = F.elu(h)
        return h


def make_gat_apply(csr: CSR, heads: int = 2, device=None, plan=None,
                   **plan_kw) -> GATApply:
    """Prepare the edge indices and the pattern plan once -> apply(params,
    x) -> (n, d_last) (the last layer averages its heads). device: None is
    the card. The plan is spmm_plan(csr, values="call", device=device,
    **plan_kw), or `plan`, one built so beforehand (or any callable
    plan(hw, values=alpha) that computes what it computes); a call takes
    it where it needs no gradient (module docstring)."""
    return GATApply(csr, heads, resolve_device(device), plan, **plan_kw)


class GAT(TreeModule):
    """GAT parameters; forward(apply, x) as apply(params, x) with apply
    from make_gat_apply."""

    def __init__(self, dims: Sequence[int], heads: int = 2, generator=None,
                 device=None, residual: bool = False):
        super().__init__(init_gat(dims, heads, generator, device, residual))
        self.dims, self.heads = list(dims), heads

    def forward(self, apply: GATApply, x) -> torch.Tensor:
        return apply(self.params(), x)
