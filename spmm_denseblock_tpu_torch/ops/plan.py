"""Plan: an executor that owns its packed arrays (twin of
``spmm_denseblock_tpu/ops/plan.py``).

The JAX plan is a pytree so that jit sees its arrays as parameters. Here
a plan is an ``nn.Module`` that holds its index and block arrays as
buffers, so ``plan.to(device)`` moves them and ``plan(dense)`` runs the
apply function on them. Plans nest: ``sum_plan`` holds sub-plans as
child modules and adds their outputs.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn


class Plan(nn.Module):
    """Callable executor: apply_fn(statics, arrays, dense).

    arrays: a sequence of numpy arrays or tensors (registered as buffers,
    in order, on `device`), or a sequence of sub-plans."""

    def __init__(
        self,
        arrays: Sequence,
        apply_fn: Callable,
        statics: Tuple = (),
        device=None,
    ):
        super().__init__()
        self.apply_fn = apply_fn
        self.statics = statics
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
        return self.apply_fn(self.statics, self.arrays, dense)

    def extra_repr(self) -> str:
        name = getattr(self.apply_fn, "__name__", "apply")
        return f"{name}, statics={self.statics!r}"


def _sum_apply(statics, plans, dense):
    """Sum of sub-plan outputs (partial row sums add)."""
    out = plans[0](dense)
    for p in plans[1:]:
        out = out + p(dense)
    return out


def sum_plan(plans) -> Plan:
    return Plan(tuple(plans), _sum_apply)
