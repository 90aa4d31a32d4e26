"""The system under test: the GAT of ``spmm_denseblock_tpu_torch``, served
through the port's SpMM plans.

Set-up is the port's own: the attention pattern of the raw edge list
(``models.graph.gat_pattern``) and its ordering (``prep_s``), then one
pattern plan through ``spmm_plan(..., values="call")`` and the GAT on
it, ``make_gat_apply(..., plan=...)`` (``plan_s``); a request needs no
gradient, so the GAT takes its plan route. A request's
features are permuted into the program's order on the way in and its
answers back on the way out; answers are in the benchmark's node ids.

Spans (``torch.profiler.record_function``) are opened only while the
harness traces: ``pb.spmm`` around each layer's whole edge attention
(node and edge scores, the softmax and the valued aggregation), so a
later kernel that fuses them moves no boundary of the metric, and
``pb.request`` around one request's enqueue. Serving only: the plan
route has no gradient.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

import spmm_denseblock_tpu_torch
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.models.gat import make_gat_apply
from spmm_denseblock_tpu_torch.models.graph import gat_pattern
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan
from spmm_denseblock_tpu_torch.reorder import invert_permutation, reorder

# where the program was imported from: the harness refuses one from
# outside its checkout
PROGRAM = Path(spmm_denseblock_tpu_torch.__file__).resolve()


class System:
    """Graph prep and plan once a process (``prep_s``, ``plan_s``); then
    ``load_serving`` a seed's weights as often as asked."""

    def __init__(self, config: dict, mix: dict, n: int, edges: np.ndarray,
                 device, t_load: float):
        if mix["kind"] != "serve":
            raise ValueError("the port's GAT serves through its plans only "
                             f"(no gradient), not {mix['kind']!r}")
        self.device = torch.device(device)
        self.tracing = False
        t0 = time.perf_counter()
        pattern = gat_pattern(CSR.from_edges(edges, n_rows=n))
        reordered, old2new = reorder(pattern, config["ordering"])
        self.prep_s = t_load + time.perf_counter() - t0
        new2old = invert_permutation(np.asarray(old2new, dtype=np.int64))
        self.old2new = torch.as_tensor(old2new, device=self.device).long()
        self.new2old = torch.as_tensor(new2old, device=self.device).long()
        t0 = time.perf_counter()
        plan = spmm_plan(reordered, values="call", device=self.device,
                         **mix.get("plan", {}))
        self.apply = make_gat_apply(reordered, config["heads"], self.device,
                                    plan=self._spmm)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.plan_s = time.perf_counter() - t0
        # self.plan(h): one valued SpMM, with the values that the layer's
        # softmax has just made; one argument, as every adapter's plan
        self._values = None
        self.plan = lambda h: plan(h, values=self._values)
        attend = self.apply.attend

        def attention(p, hw, route_plan):
            with self.span("pb.spmm"):
                return attend(p, hw, route_plan)

        self.apply.attend = attention
        self.params = None

    def _spmm(self, hw, values):
        """The GAT's aggregation: self.plan on hw with these values."""
        self._values = values
        try:
            return self.plan(hw)
        finally:
            self._values = None

    def span(self, name: str):
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def load_serving(self, params):
        self.params = [{k: v.clone() for k, v in p.items()} for p in params]

    def request(self, x):
        """One request: the GAT's output for features x (benchmark order)."""
        with torch.no_grad():
            y = self.apply(self.params, x.index_select(0, self.new2old))
            return y.index_select(0, self.old2new)
