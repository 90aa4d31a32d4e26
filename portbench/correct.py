"""The numbers that decide ``correct``, each against its limit.

serve: ``request_err``, the largest over the sampled requests of
max |y - ref| / max |ref|, ref the float64 reference's output for the
same feature matrix.

train: over the first steps, against the float64 reference from the same
weights and data,
- ``loss1_gap``: the first step's |loss - ref| / |ref|;
- ``out_grad_gap``: over the output layer's leaves (the weights after the
  last ReLU), the worst gap between the norm of the first step's
  gradient (the program's as its optimizer took it) and the reference's,
  against the larger of that leaf's reference norm and the median leaf's;
- ``median_grad_gap``: the same gap, the median over every leaf: the
  hidden layers' gradients are the ones that pass through the backward
  SpMM (Aᵀ g), which no other number sees scaled;
- ``change_gap``: the same over every leaf for the norm of its change
  over the steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

The later steps' losses and the hidden layers' worst leaf are not
compared: a pre-activation within rounding of zero flips its ReLU between
the program and the reference, which moves one hidden leaf's gradient by
up to 1e-5 on some seeds, and Adam then steps an element whose gradient
is nought to rounding by up to lr either way (PERF.md, §6).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.to(torch.float64)
    diff = (got.to(torch.float64) - ref).abs().max()
    scale = ref.abs().max().clamp(min=1e-300)
    value = float(diff / scale)
    return value if math.isfinite(value) else math.inf


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(t.to(torch.float64).norm()) for t in leaves]


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    k = len(s) // 2
    return s[k] if len(s) % 2 else 0.5 * (s[k - 1] + s[k])


def norm_gap(got: Sequence[float], ref: Sequence[float], keep=None,
             over=max) -> float:
    """`over` (max, or _median) the kept leaves of
    |got - ref| / max(ref, median ref)."""
    med = _median(ref)
    gaps = [abs(g - r) / max(r, med, 1e-300)
            for i, (g, r) in enumerate(zip(got, ref)) if keep is None or keep[i]]
    value = over(gaps) if gaps else 0.0
    return value if math.isfinite(value) else math.inf


def train_numbers(losses, grads, change, ref_losses, ref_grads, ref_change) -> Dict:
    """losses: the first steps' losses; grads: the first step's gradient
    by leaf, leaves (w, b) layer by layer; change: each leaf's change over
    the steps; ref_*: the reference's."""
    loss_gap = abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-300)
    g, g_ref = _norms(grads), _norms(ref_grads)
    floor = 1e-3 * _median(g_ref)
    return {
        "loss1_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
        # the output layer's two leaves, w and b
        "out_grad_gap": norm_gap(g, g_ref,
                                 keep=[i >= len(g_ref) - 2 for i in range(len(g_ref))]),
        "median_grad_gap": norm_gap(g, g_ref, over=_median),
        "change_gap": norm_gap(_norms(change), _norms(ref_change),
                               keep=[g >= floor for g in g_ref]),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [{name, value, limit}]): every number at or under its
    limit. A number without a limit is an error of the mix file."""
    checks = [{"name": k, "value": v, "limit": limits[k]} for k, v in numbers.items()]
    return all(c["value"] <= c["limit"] for c in checks), checks
