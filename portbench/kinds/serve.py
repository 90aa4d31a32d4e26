"""The ``serve`` kind: a closed loop of ``clients`` callers, each resending
as soon as the host sees its reply's completion event, so up to
``clients`` requests are queued on one stream while the host enqueues the
next. Request k is one full-graph forward on feature matrix k mod
``pool`` of a seeded pool held on the device. Latency runs from the
submit to the host seeing the completion.

Mix keys: ``clients``, ``pool``, ``precision``, ``plan``, and ``limits``
for ``request_err``: the largest over the sampled answers of
max |y - ref| / max |ref|, ref the float64 reference's output for the
same feature matrix.
"""

from __future__ import annotations

import collections
import math
import time
from typing import List

import numpy as np
import torch

from portbench import correct, faults, reference
from portbench.harness import SLICE_S

SAMPLE = 8          # answers of a window kept for the check
WARM_ROUNDS = 2     # warm-up requests per client

# faults planted under the timed path, which `correct` has to catch
FAULTS = {"answer": faults.answer, "half": faults.half}


def data(config: dict, mix: dict, n: int, generator, device) -> dict:
    pool = torch.randn(mix["pool"], n, config["dims"][0], generator=generator,
                       device=device)
    return {"pool": list(pool.unbind(0))}


class Sample:
    """A seeded uniform sample of `k` answers (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.k, self.seen, self.items = k, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


class _Done:
    """The CPU's completion event: the work is done when enqueued."""

    def synchronize(self):
        pass


class ServeLoop:
    def __init__(self, system, pool, clients: int, sample: Sample, device):
        self.system, self.pool, self.clients = system, pool, clients
        self.sample, self.device = sample, device
        self.inflight = collections.deque()
        self.submitted = 0
        self.latencies: List[float] = []
        self.enqueue: List[float] = []

    def _event(self):
        if self.device != "cuda":
            return _Done()
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def submit(self):
        """Enqueue the next request; its latency runs from now."""
        k = self.submitted
        t = time.perf_counter()
        with self.system.span("pb.request"):
            y = self.system.request(self.pool[k % len(self.pool)])
        ev = self._event()
        self.enqueue.append(time.perf_counter() - t)
        self.inflight.append((k, t, ev, y))
        self.submitted += 1

    def run(self, seconds: float = math.inf, count: int = 0, record: bool = True):
        """Serve until `seconds` have passed (or `count` replies came).
        Returns (replies, seconds from the start to the last reply)."""
        while len(self.inflight) < self.clients:
            self.submit()
        t0 = time.perf_counter()
        done = 0
        while True:
            k, t, ev, y = self.inflight.popleft()
            ev.synchronize()
            now = time.perf_counter()
            done += 1
            if record:
                self.latencies.append(now - t)
                self.sample.offer((k, y))
            if now - t0 >= seconds or done == count:
                return done, now - t0
            self.submit()

    def drain(self):
        """Wait for the replies still in flight; they join the sample."""
        while self.inflight:
            k, _, ev, y = self.inflight.popleft()
            ev.synchronize()
            self.sample.offer((k, y))


def run(cell, system, inputs, args, device, t_start, traced):
    mix = cell.mix
    clients = mix["clients"]
    system.load_serving(inputs["params"])
    loop = ServeLoop(system, inputs["pool"], clients, Sample(SAMPLE, args.seed), device)
    loop.run(count=WARM_ROUNDS * max(clients, len(inputs["pool"])), record=False)
    loop.enqueue.clear()
    first = loop.submitted - len(loop.inflight)
    out = {"setup_s": time.perf_counter() - t_start}
    if args.trace:
        done, secs = loop.run(max(args.seconds - SLICE_S, SLICE_S))
        out["enqueue_ms"] = 1e3 * float(np.mean(loop.enqueue))
        out["units_per_s"] = done / secs
        out["trace"] = traced(loop.run, "pb.request")
    else:
        done, secs = loop.run(args.seconds)
        out["requests_per_s"] = done / secs
        out["request_ms_p95"] = 1e3 * float(np.percentile(loop.latencies, 95))
    loop.drain()
    out["attempted"] = loop.submitted - first
    out["answers"] = sorted(loop.sample.items, key=lambda kv: kv[0])
    return out


def check(cell, model, out, inputs, edges, n):
    pool = inputs["pool"]
    refs = reference.serve(model, edges, n, inputs["params"], pool)
    errs = [correct.rel_err(y, refs[k % len(pool)]) for k, y in out["answers"]]
    ok, checks = correct.judge({"request_err": max(errs)}, cell.mix["limits"])
    failed = sum(e > cell.mix["limits"]["request_err"] for e in errs)
    return ok, failed, checks


def control(cell, model, inputs, edges, n):
    """The numbers of the reference at TF32 in the program's place."""
    args = (model, edges, n, inputs["params"], inputs["pool"])
    refs = reference.serve(*args)
    ctrl = reference.serve(*args, control=True)
    return {"request_err": max(correct.rel_err(c, r) for c, r in zip(ctrl, refs))}
