"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a patch(system) applied after set-up, before the warm-up.
Each kind of ``portbench/kinds/`` names the ones its cells can have, as
its ``FAULTS``. A one-card cell has no exchange between chips to leave
out.

serve: ``answer`` (one value of every answer altered where it is
produced), ``half`` (half of every answer's rows never written).
train: ``frozen`` (a step that returns its state unchanged),
``half_batch`` (half of the batch left out, the mean over the rest),
``backward_scaled`` (the SpMM's backward, Aᵀ g, off by the factor
1 + 1e-3, its forward as it was: Adam's step, m / (sqrt(v) + eps), does
not see a gradient's scale, so only the gradient itself can show it).
"""

from __future__ import annotations

import torch


def answer(system):
    request = system.request

    def altered(x):
        y = request(x)
        y[0, 0] += y.abs().max()
        return y

    system.request = altered


def half(system):
    request = system.request

    def halved(x):
        y = request(x)
        y[y.shape[0] // 2:] = 0.0
        return y

    system.request = halved


def frozen(system):
    load = system.load_training

    def unchanged(*args, **kw):
        load(*args, **kw)
        system.opt.step = lambda closure=None: None

    system.load_training = unchanged


def half_batch(system):
    load = system.load_training

    def halved(*args, **kw):
        load(*args, **kw)
        x, y, mask = system.batch
        mask = mask.clone()
        mask[mask.nonzero()[::2, 0]] = 0.0
        system.batch = (x, y, mask)

    system.load_training = halved


class _ScaleBackward(torch.autograd.Function):
    factor = 1.0 + 1e-3

    @staticmethod
    def forward(ctx, h):
        return h.clone()

    @staticmethod
    def backward(ctx, g):
        return g * _ScaleBackward.factor


def backward_scaled(system):
    plan = system.plan

    def scaled(h):
        return plan(_ScaleBackward.apply(h))

    system.plan = scaled
