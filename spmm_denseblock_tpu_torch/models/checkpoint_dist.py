"""Sharded (multi-rank) training-state checkpoints on
``torch.distributed.checkpoint`` (twin of
``spmm_denseblock_tpu/models/checkpoint_dist.py``, which uses orbax).

models/checkpoint.py keeps the one-file restart for single-card state.
This module is its multi-rank counterpart: every rank writes only its
own shards (no gather onto one rank), replicated tensors are written
once, and a restore reads each shard into the template's placement, so
a resumed run continues with the layout its step was built for.

    mgr = make_manager("/ckpts/run1", max_to_keep=3)
    save_dist_checkpoint(mgr, step, state)
    state, step = restore_dist_checkpoint(mgr, like_state=template)

A state is a nested dict/list whose leaves are DTensors (a rank's shard
and its placements on the mesh; parallel/train.DistTrainStep.state
makes them over the live parameters), plain tensors (replicated), and
torch.optim optimizers: an Adam (amsgrad off) is written in optax's
layout, count (int32) then mu and nu in its parameters' order, each mu
and nu leaf with the placements of its parameter's DTensor in the same
state (a parameter with none: replicated); an SGD without momentum
has no state. Each step is a directory ``<directory>/<step>`` that DCP
completes with its ``.metadata`` file; a step without one is not a
checkpoint. Restores are in place: like_state's DTensors and tensors
(and so the parameters they view) and its optimizers get the saved
values, and like_state is returned.

The files are DCP's, not orbax's: neither package reads the other's
sharded checkpoints. The parity is of behaviour (steps, retention,
latest step, a missing step raising, a bit-exact resume), not of format.
Every rank calls every function here, in the same order.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from spmm_denseblock_tpu_torch.models.checkpoint import _optimizer_kind, tree_leaves


class CheckpointManager:
    """Step directories under `directory`, the newest max_to_keep kept.
    Its own gloo group carries DCP's coordination, apart from the
    training's collectives (an async save coordinates from a thread)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self.group = dist.new_group(backend="gloo")
        self._pending = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list:
        """The complete steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, ".metadata")):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Wait for an async save, then apply the retention."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        dist.barrier(group=self.group)
        if dist.get_rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)
        dist.barrier(group=self.group)


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    """A CheckpointManager over `directory` with step retention."""
    return CheckpointManager(directory, max_to_keep)


def _adam_parts(opt: torch.optim.Optimizer, placed: dict, restore: bool) -> dict:
    """The Adam state as {"count", "mu": [...], "nu": [...]}, mu and nu
    as DTensors where their parameter has one in `placed` (keyed by the
    data pointer of its local tensor). With restore, missing state
    entries are made (zeros) to load into."""
    from torch.distributed.tensor import DTensor

    params = [p for g in opt.param_groups for p in g["params"]]
    states = [opt.state.get(p, {}) for p in params]
    count = next((int(s["step"]) for s in states if "step" in s), 0)
    out = {"count": torch.tensor(count, dtype=torch.int32), "mu": [], "nu": []}
    for p, s in zip(params, states):
        if restore and not s:
            s = opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.zeros_like(p)}
        like = placed.get(p.data_ptr())
        for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = s[name] if s else torch.zeros_like(p)
            if like is not None:
                t = DTensor.from_local(t, like.device_mesh, like.placements,
                                       run_check=False)
            out[key].append(t)
    return out


def _flat(state: Any, restore: bool = False) -> Tuple[dict, list]:
    """(DCP's flat state dict keyed by tree path, the optimizers found
    with their "count" tensors)."""
    from torch.distributed.tensor import DTensor

    placed = {leaf.to_local().data_ptr(): leaf for leaf in tree_leaves(state)
              if isinstance(leaf, DTensor)}
    flat, opts = {}, []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, sub in enumerate(t):
                walk(sub, f"{path}/{i}")
        elif isinstance(t, torch.optim.Optimizer):
            if _optimizer_kind(t) == "adam":
                parts = _adam_parts(t, placed, restore)
                opts.append((t, parts["count"]))
                walk(parts, path)
        elif t is not None:
            flat[path] = t

    with torch.no_grad():
        walk(state, "")
    return flat, opts


def save_dist_checkpoint(mgr: CheckpointManager, step: int, state: Any,
                         wait: bool = True) -> None:
    """Save `state` at `step`: each rank writes its own shards. wait=False
    returns once the state is staged on the host and writes it in the
    background (dcp.async_save); call mgr.wait_until_finished() before
    relying on it, as the next save and every restore do."""
    import torch.distributed.checkpoint as dcp

    mgr.wait_until_finished()
    flat, _ = _flat(state)
    path = mgr.step_dir(step)
    if wait:
        dcp.save(flat, checkpoint_id=path, process_group=mgr.group)
        mgr.wait_until_finished()
    else:
        mgr._pending = dcp.async_save(flat, checkpoint_id=path, process_group=mgr.group)


def restore_dist_checkpoint(mgr: CheckpointManager, like_state: Any,
                            step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into like_state in place (its DTensors, tensors and
    optimizers; each shard into the template's placement). step=None
    restores the latest complete step; no step raises
    FileNotFoundError. Returns (like_state, step)."""
    import torch.distributed.checkpoint as dcp

    mgr.wait_until_finished()
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {mgr.directory}")
    path = mgr.step_dir(step)
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise FileNotFoundError(f"no checkpoint at step {step} under {mgr.directory}")
    flat, opts = _flat(like_state, restore=True)
    dcp.load(flat, checkpoint_id=path, process_group=mgr.group)
    for opt, count in opts:
        for g in opt.param_groups:
            on_device = g.get("capturable") or g.get("fused")
            for p in g["params"]:
                opt.state[p]["step"] = torch.tensor(
                    float(count), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
    return like_state, int(step)
