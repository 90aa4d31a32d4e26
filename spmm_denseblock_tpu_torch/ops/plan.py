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

A plan built with ``values="call"`` (``call_values``) takes A's values
with each call, ``plan(dense, values=v)``: v is (nnz,) or (H, nnz) in the
entry order of the pattern it was built from, and row h multiplies
column block h of dense. The nesting plans pass the values on; such a
leaf also adds v's nnz·H to ``sdb.call_values/<name>``. It has no
gradient: a call under autograd whose values or operand require one
raises, and ``grad_plan`` refuses it.
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
    docstring); a plan without a name opens no span of its own.
    call_values: a leaf whose apply_fn takes values= with each call (a
    nesting plan takes them where all of its sub-plans do)."""

    def __init__(
        self,
        arrays: Sequence,
        apply_fn: Callable,
        statics: Tuple = (),
        device=None,
        name: Optional[str] = None,
        nnz: int = 0,
        positions: int = 0,
        call_values: bool = False,
    ):
        super().__init__()
        self.apply_fn = apply_fn
        self.statics = statics
        self.name, self.nnz, self.positions = name, int(nnz), int(positions)
        self.call_values = bool(call_values)
        self.subplans = None
        self._n_arrays = 0
        if arrays and all(isinstance(a, Plan) for a in arrays):
            self.subplans = nn.ModuleList(arrays)
            self.call_values = all(p.call_values for p in arrays)
            return
        for i, a in enumerate(arrays):
            self.register_buffer(f"a{i}", torch.as_tensor(a, device=device))
        self._n_arrays = len(arrays)

    @property
    def arrays(self) -> tuple:
        if self.subplans is not None:
            return tuple(self.subplans)
        return tuple(getattr(self, f"a{i}") for i in range(self._n_arrays))

    def forward(self, dense, values=None):
        kw = {}
        if values is not None or self.call_values:
            self.check_call(dense, values)
            kw["values"] = values = torch.as_tensor(values)
        if self.name is None or not profiling.enabled():
            return self.apply_fn(self.statics, self.arrays, dense, **kw)
        profiling.count("sdb.nnz/" + self.name, self.nnz)
        profiling.count("sdb.positions/" + self.name, self.positions)
        if values is not None:
            profiling.count("sdb.call_values/" + self.name, values.numel())
        with profiling.span("sdb." + self.name):
            return self.apply_fn(self.statics, self.arrays, dense, **kw)

    def check_call(self, dense, values) -> None:
        """ValueError where a call's values do not fit the plan (given to a
        plan with fixed values, or missing on a values="call" plan), and
        RuntimeError where the call would need a gradient, which a
        values="call" plan does not give."""
        if values is None:
            raise ValueError("this plan takes A's values with each call: "
                             "plan(dense, values=v), v (nnz,) or (heads, nnz)")
        if not self.call_values:
            raise ValueError("this plan's values are fixed at build; build it with "
                             "spmm_plan(..., values='call') to pass them per call")
        if torch.is_grad_enabled() and any(
                getattr(t, "requires_grad", False) for t in (dense, values)):
            raise RuntimeError("a values='call' plan has no gradient, for its values "
                               "or its operand: call it under torch.no_grad(), on "
                               "tensors that require none")

    def extra_repr(self) -> str:
        name = getattr(self.apply_fn, "__name__", "apply")
        return f"{name}, statics={self.statics!r}"


def run(plan: Plan, dense, plain: bool = False, values=None):
    """plan(dense), or with plain=True the same answer through the
    kernels' plain PyTorch versions; values: a values="call" plan's."""
    kw = {}
    if values is not None or plan.call_values:
        kw["values"] = values
    if plain:
        if kw:
            plan.check_call(dense, values)
        return plan.apply_fn(plan.statics, plan.arrays, dense, plain=True, **kw)
    return plan(dense, **kw)


def _sum_apply(statics, plans, dense, plain: bool = False, values=None):
    """Sum of sub-plan outputs (partial row sums add)."""
    with profiling.span("sdb.sum"):
        out = run(plans[0], dense, plain, values)
        for p in plans[1:]:
            out = out + run(p, dense, plain, values)
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
    (the same kernel family on the transposed layout). A values="call"
    plan has no backward: ValueError."""
    if fwd_plan.call_values or bwd_plan.call_values:
        raise ValueError("a values='call' plan has no backward: build it with "
                         "grad=False")
    return Plan((fwd_plan, bwd_plan), _grad_apply)


def _transb_apply(statics, plans, dense_t, plain: bool = False, values=None):
    (inner,) = plans
    if not torch.is_tensor(dense_t):
        dense_t = torch.as_tensor(dense_t)
    return run(inner, dense_t.T, plain, values)


def transb_plan(inner: Plan) -> Plan:
    """Column-major operand entry: the returned plan takes B^T of shape
    (F, K) and computes the same C = A @ B. The inner plan makes the
    transposed view contiguous where it casts and pads the operand.
    Autograd flows through (the gradient of B^T is the transposed
    gradient of B)."""
    return Plan((inner,), _transb_apply)
