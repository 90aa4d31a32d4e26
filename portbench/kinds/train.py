"""The ``train`` kind: full-batch training steps back to back under Adam,
masked softmax cross-entropy. The first ``CHECKED_STEPS`` steps run in
set-up, through the window's own call, and are the ones checked; the
window then goes on with the same model and optimizer.

Mix keys: ``precision``, ``plan``, and ``limits`` for the numbers of
``correct.train_numbers``. The configuration gives ``lr`` and
``train_nodes`` (the training mask's size at the graph's full size).
"""

from __future__ import annotations

import time

import torch

from portbench import correct, faults, reference
from portbench.harness import SLICE_S, sync

CHECKED_STEPS = 3   # training steps the reference follows

# faults planted under the timed path, which `correct` has to catch
FAULTS = {"frozen": faults.frozen, "half_batch": faults.half_batch,
          "backward_scaled": faults.backward_scaled}


def data(config: dict, mix: dict, n: int, generator, device) -> dict:
    x = torch.randn(n, config["dims"][0], generator=generator, device=device)
    labels = torch.randint(0, config["dims"][-1], (n,), generator=generator,
                           device=device)
    k = min(n, round(config["train_nodes"] * n / config["graph"]["n"]))
    mask = torch.zeros(n, device=device)
    mask[torch.randperm(n, generator=generator, device=device)[:k]] = 1.0
    return {"x": x, "labels": labels, "mask": mask}


def run(cell, system, inputs, args, device, t_start, traced):
    system.load_training(inputs["params"], inputs["x"], inputs["labels"],
                         inputs["mask"], cell.config["lr"])
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append(float(system.step()))
        if i == 0:
            grads = [g.detach().clone() for g in system.first_gradient()]
    change = [(p.detach() - p0).clone()
              for p, p0 in zip(system.leaves(), inputs["leaves"])]
    sync(device)

    out = {"setup_s": time.perf_counter() - t_start, "losses": losses,
           "grads": grads, "change": change, "attempted": CHECKED_STEPS}

    def steps(seconds):
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < seconds:
            with system.span("pb.step"):
                system.step()
            done += 1
        sync(device)
        out["attempted"] += done
        return done, time.perf_counter() - t0

    if args.trace:
        done, secs = steps(max(args.seconds - SLICE_S, SLICE_S))
        out["units_per_s"] = done / secs
        out["trace"] = traced(steps, "pb.step")
    else:
        done, secs = steps(args.seconds)
        out["train_step_ms"] = 1e3 * secs / done
    return out


def _train(cell, model, inputs, edges, n, control=False):
    """The reference's (losses, first gradient, change by leaf)."""
    losses, grads, after = reference.train(
        model, edges, n, inputs["params"], inputs["x"], inputs["labels"],
        inputs["mask"], cell.config["lr"], CHECKED_STEPS, control=control)
    return losses, grads, [a.double() - p0.double()
                           for a, p0 in zip(after, inputs["leaves"])]


def check(cell, model, out, inputs, edges, n):
    numbers = correct.train_numbers(out["losses"], out["grads"], out["change"],
                                    *_train(cell, model, inputs, edges, n))
    ok, checks = correct.judge(numbers, cell.mix["limits"])
    return ok, sum(c["value"] > c["limit"] for c in checks), checks


def control(cell, model, inputs, edges, n):
    """The numbers of the reference at TF32 in the program's place."""
    return correct.train_numbers(*_train(cell, model, inputs, edges, n, control=True),
                                 *_train(cell, model, inputs, edges, n))
