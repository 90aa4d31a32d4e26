"""The plain reference: a configuration's model in plain PyTorch.

It works from the benchmark's own raw edge list, weights and inputs, and
takes nothing from the program under test: no ordering, plan or
normalised matrix. It imports torch and numpy only. Run in float64 it
is the answer a run is judged by; run in float32 with TF32 matmuls it is
the control that has to come out as not correct.

The model is a module of ``portbench/models/`` with ``adjacency(edges,
n, dtype, device)``, ``forward(adj, params, x, prec)`` and
``leaves(params)``; this file holds what every model shares:

- ``sym_norm``: D^-1/2 (A + I) D^-1/2 from the edges (Kipf and Welling),
  duplicate edges summed, as a CSR tensor and its transpose;
- ``spmm``: A x with Aᵀ g as its backward;
- ``serve``: the model's output on each feature matrix;
- ``train``: full-batch steps of masked softmax cross-entropy (the sum
  over the mask divided by its count) under ``torch.optim.Adam``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), kept float32:
    what a TF32 matmul reads, for the control on a device without TF32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = (tf32_round(t) for t in ctx.saved_tensors)
        g = tf32_round(g)
        return g @ b.T, a.T @ g


class _Precision:
    """float64 (the reference) or float32 with TF32 matmuls (the control)."""

    def __init__(self, control: bool):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def matmul(self, a, b):
        if self.control and a.device.type != "cuda":
            return _TF32MatMul.apply(a, b)
        return a @ b

    @contextlib.contextmanager
    def scope(self):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def sym_norm(edges: np.ndarray, n: int, dtype, device):
    """(A, Aᵀ) as sparse CSR tensors: the symmetric normalisation of the
    raw edges with a self-loop on every node."""
    e = torch.as_tensor(np.asarray(edges), device=device).long()
    loops = torch.arange(n, device=device)
    rows = torch.cat([e[:, 0], loops])
    cols = torch.cat([e[:, 1], loops])
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    vals = (dinv[rows] * dinv[cols]).to(dtype)
    with warnings.catch_warnings():  # sparse tensors are "in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                    check_invariants=False).coalesce()
        at = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals, (n, n),
                                     check_invariants=False).coalesce()
        return a.to_sparse_csr(), at.to_sparse_csr()


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, at):
        ctx.at = at
        return a @ x

    @staticmethod
    def backward(ctx, g):
        return ctx.at @ g, None, None


def spmm(adj, x):
    """A x, with Aᵀ g as its backward; adj = (A, Aᵀ)."""
    return _SpMM.apply(x, *adj)


def masked_cross_entropy(logits, labels, mask):
    logp = torch.log_softmax(logits, dim=-1)
    per_node = -logp.gather(1, labels.long()[:, None])[:, 0]
    w = mask.to(logits.dtype)
    return (per_node * w).sum() / w.sum().clamp(min=1.0)


def cast_params(params: List[dict], dtype) -> List[dict]:
    return [{k: v.detach().to(dtype).clone() for k, v in p.items()} for p in params]


def serve(model, edges, n, params, xs, control: bool = False):
    """The model's output on each feature matrix of `xs`."""
    prec = _Precision(control)
    with prec.scope(), torch.no_grad():
        adj = model.adjacency(edges, n, prec.dtype, xs[0].device)
        ps = cast_params(params, prec.dtype)
        return [model.forward(adj, ps, x.to(prec.dtype), prec) for x in xs]


def train(model, edges, n, params, x, labels, mask, lr: float, steps: int,
          control: bool = False):
    """`steps` Adam steps from `params`. Returns (losses, the first
    step's gradient by leaf, the parameters after the last step by leaf),
    leaves in the order of ``model.leaves(params)``."""
    prec = _Precision(control)
    with prec.scope():
        adj = model.adjacency(edges, n, prec.dtype, x.device)
        ps = cast_params(params, prec.dtype)
        leaves = model.leaves(ps)
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=lr)
        xr = x.to(prec.dtype)
        losses, grads = [], None
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = masked_cross_entropy(model.forward(adj, ps, xr, prec), labels,
                                        mask)
            loss.backward()
            if i == 0:
                grads = [t.grad.detach().clone() for t in leaves]
            opt.step()
            losses.append(float(loss.detach()))
        return losses, grads, [t.detach().clone() for t in leaves]
