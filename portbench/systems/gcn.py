"""The system under test: the GCN of ``spmm_denseblock_tpu_torch``.

The modules of ``portbench/systems/`` are the only ones of the benchmark
that import the port. It hands
the port the benchmark's raw edge list, weights and inputs, and takes
back what the port computes. The graph is relabelled by the port's
ordering, so a request's features are permuted into the program's order
on the way in and its answers back on the way out; answers and losses
are in the benchmark's node ids.

Spans (``torch.profiler.record_function``) are opened only while the
harness traces: ``pb.spmm`` around every SpMM call that ``gcn_apply``
makes, ``pb.request`` / ``pb.step`` around one request's or step's
enqueue.
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import numpy as np
import torch

import spmm_denseblock_tpu_torch
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.models.gnn import gcn_apply
from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency
from spmm_denseblock_tpu_torch.models.train import make_train_step
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan
from spmm_denseblock_tpu_torch.reorder import invert_permutation, reorder

# where the program was imported from: the harness refuses one from
# outside its checkout
PROGRAM = Path(spmm_denseblock_tpu_torch.__file__).resolve()
# the mix's "dtype" names, as spmm_plan takes them
_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


class System:
    """Graph prep and plan once a process (``prep_s``, ``plan_s``); then
    ``load`` a seed's weights (and, in training, its data and optimizer)
    as often as asked."""

    def __init__(self, config: dict, mix: dict, n: int, edges: np.ndarray,
                 device, t_load: float):
        self.device = torch.device(device)
        self.dims = list(config["dims"])
        self.kind = mix["kind"]
        self.tracing = False
        t0 = time.perf_counter()
        csr = CSR.from_edges(edges, n_rows=n)
        reordered, old2new = reorder(csr, config["ordering"])
        adj = sym_norm_adjacency(reordered)
        self.prep_s = t_load + time.perf_counter() - t0
        new2old = invert_permutation(np.asarray(old2new, dtype=np.int64))
        self.old2new = torch.as_tensor(old2new, device=self.device).long()
        self.new2old = torch.as_tensor(new2old, device=self.device).long()
        kw = dict(mix.get("plan", {}))
        if "dtype" in kw:
            kw["dtype"] = _DTYPES[kw["dtype"]]
        t0 = time.perf_counter()
        self.plan = spmm_plan(adj, feat_dim=self.dims[0],
                              grad=self.kind == "train", device=self.device, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.plan_s = time.perf_counter() - t0
        self.params = self.opt = None

    def span(self, name: str):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def spmm(self, h):
        with self.span("pb.spmm"):
            return self.plan(h)

    # -- serving -----------------------------------------------------------

    def load_serving(self, params):
        self.params = [{k: v.clone() for k, v in p.items()} for p in params]

    def request(self, x):
        """One request: the GCN's output for features x (benchmark order)."""
        y = gcn_apply(self.params, self.spmm, x.index_select(0, self.new2old))
        return y.index_select(0, self.old2new)

    # -- training ----------------------------------------------------------

    def load_training(self, params, x, labels, mask, lr: float):
        """The program's own copy of the weights and an Adam over them;
        the batch permuted once into the program's order."""
        self.params = [{k: v.clone() for k, v in p.items()} for p in params]
        self._step, init_state = make_train_step(
            gcn_apply, self.spmm, functools.partial(torch.optim.Adam, lr=lr))
        self.opt = init_state(self.params)
        self.batch = tuple(t.index_select(0, self.new2old)
                           for t in (x, labels, mask))

    def step(self):
        """One training step; returns its loss (a device scalar)."""
        self.params, self.opt, metrics = self._step(self.params, self.opt,
                                                    *self.batch)
        return metrics["loss"]

    def leaves(self):
        return [p[k] for p in self.params for k in ("w", "b")]

    def first_gradient(self):
        """Each leaf's gradient as Adam took it, worked out from its
        state after one step: exp_avg = (1 - beta1) g."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        state = [self.opt.state.get(t, {}).get("exp_avg") for t in self.leaves()]
        # a leaf the optimizer never stepped has no state: no gradient
        return [torch.zeros_like(t) if m is None else m / (1.0 - beta1)
                for t, m in zip(self.leaves(), state)]
