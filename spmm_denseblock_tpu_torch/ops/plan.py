"""Plan: an executor that owns its packed arrays (twin of
``spmm_denseblock_tpu/ops/plan.py``).

The JAX plan is a pytree so that jit sees its arrays as parameters. Here
a plan is an ``nn.Module`` that holds its index and block arrays as
buffers, so ``plan.to(device)`` moves them and ``plan(dense)`` runs the
apply function on them. Plans nest: ``sum_plan``, ``grad_plan`` and
``transb_plan`` hold sub-plans as child modules.

Every apply function also takes ``plain=True``: a kernel plan's runs
the kernels' plain PyTorch versions instead (``run(plan, x,
plain=True)``), the nesting plans pass it on to their sub-plans, and a
plan with no kernel (``bsr_xla``, ``bsr_int8``, ``dense``) runs the same
ops either way.

A leaf plan carries the ``PLANNERS`` key of the planner that built it
(``name``) and two figures its planner computed on the host: ``nnz``,
the stored nonzeros of A it covers (a CSR's stored entries, duplicates
included; a BSR's nonzero block entries, where duplicates have summed),
and ``positions``, the element positions its layout computes a call
(the planner's docstring says which). While program tracing is on
(``utils/profiling``), each call of a leaf opens the span ``sdb.<name>``
and adds them to the counters ``sdb.nnz/<name>`` and
``sdb.positions/<name>``; ``sum_plan`` opens ``sdb.sum`` and a grad
plan's backward ``sdb.backward``. Off, a call pays one flag check.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from spmm_denseblock_tpu_torch.utils import profiling


class Plan(nn.Module):
    """Callable executor: apply_fn(statics, arrays, dense).

    arrays: a sequence of numpy arrays or tensors (registered as buffers,
    in order, on `device`), or a sequence of sub-plans. name, nnz,
    positions: a leaf plan's planner key and work figures (module
    docstring); a plan without a name opens no span of its own."""

    def __init__(
        self,
        arrays: Sequence,
        apply_fn: Callable,
        statics: Tuple = (),
        device=None,
        name: Optional[str] = None,
        nnz: int = 0,
        positions: int = 0,
    ):
        super().__init__()
        self.apply_fn = apply_fn
        self.statics = statics
        self.name, self.nnz, self.positions = name, int(nnz), int(positions)
        self.subplans = None
        self._n_arrays = 0
        if arrays and all(isinstance(a, Plan) for a in arrays):
            self.subplans = nn.ModuleList(arrays)
            return
        for i, a in enumerate(arrays):
            self.register_buffer(f"a{i}", torch.as_tensor(a, device=device))
        self._n_arrays = len(arrays)

    @property
    def arrays(self) -> tuple:
        if self.subplans is not None:
            return tuple(self.subplans)
        return tuple(getattr(self, f"a{i}") for i in range(self._n_arrays))

    def forward(self, dense):
        if self.name is None or not profiling.enabled():
            return self.apply_fn(self.statics, self.arrays, dense)
        profiling.count("sdb.nnz/" + self.name, self.nnz)
        profiling.count("sdb.positions/" + self.name, self.positions)
        with profiling.span("sdb." + self.name):
            return self.apply_fn(self.statics, self.arrays, dense)

    def extra_repr(self) -> str:
        name = getattr(self.apply_fn, "__name__", "apply")
        return f"{name}, statics={self.statics!r}"


def run(plan: Plan, dense, plain: bool = False):
    """plan(dense), or with plain=True the same answer through the
    kernels' plain PyTorch versions."""
    if plain:
        return plan.apply_fn(plan.statics, plan.arrays, dense, plain=True)
    return plan(dense)


def _sum_apply(statics, plans, dense, plain: bool = False):
    """Sum of sub-plan outputs (partial row sums add)."""
    with profiling.span("sdb.sum"):
        out = run(plans[0], dense, plain)
        for p in plans[1:]:
            out = out + run(p, dense, plain)
        return out


def sum_plan(plans) -> Plan:
    return Plan(tuple(plans), _sum_apply)


class _PlanVJP(torch.autograd.Function):
    """C = fwd(B); dB = bwd(dC), cast to B's dtype and device (the JAX
    package's _vjp_bwd). The plans' buffers are constants: no gradient."""

    @staticmethod
    def forward(ctx, dense, fwd_plan, bwd_plan, plain):
        ctx.bwd_plan, ctx.plain = bwd_plan, plain
        ctx.dtype, ctx.device = dense.dtype, dense.device
        return run(fwd_plan, dense, plain)

    @staticmethod
    def backward(ctx, g):
        with profiling.span("sdb.backward"):
            # autograd's cotangent may be a strided view
            dense_grad = run(ctx.bwd_plan, g.contiguous(), ctx.plain)
            dense_grad = dense_grad.to(device=ctx.device, dtype=ctx.dtype)
        return dense_grad, None, None, None


def _grad_apply(statics, plans, dense, plain: bool = False):
    fwd_plan, bwd_plan = plans
    if not torch.is_tensor(dense):
        dense = torch.as_tensor(dense)
    return _PlanVJP.apply(dense, fwd_plan, bwd_plan, plain)


def grad_plan(fwd_plan: Plan, bwd_plan: Plan) -> Plan:
    """Differentiable plan: dC/dB flows as A^T @ g through bwd_plan
    (the same kernel family on the transposed layout)."""
    return Plan((fwd_plan, bwd_plan), _grad_apply)


def _transb_apply(statics, plans, dense_t, plain: bool = False):
    (inner,) = plans
    if not torch.is_tensor(dense_t):
        dense_t = torch.as_tensor(dense_t)
    return run(inner, dense_t.T, plain)


def transb_plan(inner: Plan) -> Plan:
    """Column-major operand entry: the returned plan takes B^T of shape
    (F, K) and computes the same C = A @ B. The inner plan makes the
    transposed view contiguous where it casts and pads the operand.
    Autograd flows through (the gradient of B^T is the transposed
    gradient of B)."""
    return Plan((inner,), _transb_apply)
