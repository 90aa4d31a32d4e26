"""Training loop pieces: masked node-classification loss and the step
(twin of ``spmm_denseblock_tpu/models/train.py``).

The JAX package jits one pure function of (params, opt_state, batch).
Here the step runs eagerly: forward through the SpMM plan (a
``grad_plan`` runs Aᵀ's kernel in the backward), masked cross-entropy,
``backward()``, then a ``torch.optim`` update of the parameters in place.

optax -> torch.optim, as ``make_train_step``'s ``optimizer`` argument:

    optax.adam(lr)  ->  functools.partial(torch.optim.Adam, lr=lr)
    optax.sgd(lr)   ->  functools.partial(torch.optim.SGD, lr=lr)

Both use the same update rules and defaults (Adam: b1=0.9, b2=0.999,
eps=1e-8 outside the square root).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from spmm_denseblock_tpu_torch.models.checkpoint import tree_leaves
from spmm_denseblock_tpu_torch.models.gnn import SpMM

Params = List[Dict[str, torch.Tensor]]


def masked_cross_entropy(logits, labels, mask) -> torch.Tensor:
    """Softmax cross-entropy summed over mask weights, divided by
    max(sum(mask), 1) (not F.cross_entropy's mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_node = -logp.gather(-1, labels.long()[:, None])[:, 0]
    w = mask.to(logits.dtype)
    return (per_node * w).sum() / torch.clamp(w.sum(), min=1.0)


def accuracy(logits, labels, mask) -> torch.Tensor:
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
    w = mask.to(torch.float32)
    return (hit * w).sum() / torch.clamp(w.sum(), min=1.0)


def _batch(params: Params, x, y, mask):
    """x, y, mask as tensors on the parameters' device."""
    dev = tree_leaves(params)[0].device
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(mask, device=dev))


def make_train_step(apply_fn: Callable, spmm: SpMM,
                    optimizer: Callable[..., torch.optim.Optimizer]):
    """Returns (step, init_state), as the JAX package does.

    optimizer: a torch.optim class or factory taking the parameter list,
    e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)`` for
    ``optax.adam(1e-2)``. init_state(params) marks the parameter tensors
    as requiring gradients and returns the optimizer over them (the
    counterpart of optax's state). step(params, opt_state, x, y, mask)
    updates params in place and returns (params, opt_state, {"loss",
    "acc"}), the metrics taken before the update."""

    def init_state(params: Params) -> torch.optim.Optimizer:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return optimizer(leaves)

    def step(params: Params, opt_state: torch.optim.Optimizer, x, y, mask):
        x, y, mask = _batch(params, x, y, mask)
        opt_state.zero_grad(set_to_none=True)
        logits = apply_fn(params, spmm, x)
        loss = masked_cross_entropy(logits, y, mask)
        loss.backward()
        opt_state.step()
        with torch.no_grad():
            acc = accuracy(logits, y, mask)
        return params, opt_state, {"loss": loss.detach(), "acc": acc}

    return step, init_state


def make_eval_step(apply_fn: Callable, spmm: SpMM):
    """Inference metrics: (params, x, y, mask) -> {loss, acc}, no
    gradients."""

    @torch.no_grad()
    def evaluate(params: Params, x, y, mask):
        x, y, mask = _batch(params, x, y, mask)
        logits = apply_fn(params, spmm, x)
        return {
            "loss": masked_cross_entropy(logits, y, mask),
            "acc": accuracy(logits, y, mask),
        }

    return evaluate
