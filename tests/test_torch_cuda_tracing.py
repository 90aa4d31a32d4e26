"""Program spans on the card's timeline: under ``utils.trace`` on the
card, every runtime call that a bsr_pallas plan's kernel entry
(``sdb_bsr_spmm_*``) made falls, after conversion through the trace's
baseTimeNanoseconds, inside that plan's ``sdb.bsr_pallas`` span on the
same thread; in a grad plan's step the backward's launches fall inside
``sdb.backward``, on the thread that autograd ran it on. So the
program's ``time.time_ns()`` spans and the CUDA activity share one
clock. CUDA kernels have no CPU mode, so these tests skip without a
GPU; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda_tracing.py -q
"""

import json
import threading

import pytest
import torch

from spmm_denseblock_tpu_torch.formats.bsr import random_bsr
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import bsr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.utils import trace

# a string condition is evaluated when the test runs, not at import
pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: the CUDA kernels have no CPU mode",
)

RUNTIME = ("cuda_runtime", "cuda_driver")


def _traced(tmp_path, fn):
    with trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("trace_*.json")
    return json.loads(path.read_text())["traceEvents"]


def _holds(outer, e) -> bool:
    return (outer["tid"] == e["tid"] and outer["ts"] <= e["ts"]
            and e["ts"] + e.get("dur", 0.0) <= outer["ts"] + outer["dur"])


def _kernel_launches(events):
    """The runtime calls made inside a kernel entry's launcher range."""
    entries = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"].startswith("sdb_bsr_spmm")]
    calls = [e for e in events if e.get("cat") in RUNTIME and e.get("ph") == "X"
             and "Launch" in e["name"]]
    return [c for c in calls if any(_holds(r, c) for r in entries)]


def _spans(events, name):
    return [e for e in events if e.get("cat") == "sdb" and e["name"] == name]


def test_launches_inside_the_leaf_span(tmp_path):
    bsr = random_bsr(0.8, 16, 16, block_size=128, seed=1)
    plan = bsr_spmm_pallas_plan(bsr, grad=False, device="cuda")
    x = torch.ones(bsr.shape[1], 64, device="cuda")
    plan(x)  # built and warm outside the trace
    events = _traced(tmp_path, lambda: (plan(x), plan(x)))
    leaves = _spans(events, "sdb.bsr_pallas")
    launches = _kernel_launches(events)
    assert len(leaves) == 2 and len(launches) >= 2
    assert {e["tid"] for e in leaves} == {threading.get_native_id()}
    for c in launches:
        assert sum(_holds(s, c) for s in leaves) == 1


def test_backward_launches_inside_the_backward_span(tmp_path):
    bsr = random_bsr(0.8, 16, 16, block_size=128, seed=2)
    plan = bsr_spmm_pallas_plan(bsr, grad=True, device="cuda")
    x = torch.ones(bsr.shape[1], 64, device="cuda", requires_grad=True)
    plan(x).sum().backward()  # warm

    def step():
        plan(x).square().sum().backward()
        torch.cuda.synchronize()

    events = _traced(tmp_path, step)
    (back,) = _spans(events, "sdb.backward")
    leaves = _spans(events, "sdb.bsr_pallas")
    (fwd,) = [s for s in leaves if s["args"]["parent"] == -1]
    (bwd,) = [s for s in leaves if s["args"]["parent"] == back["args"]["index"]]
    # autograd runs a CUDA backward on its own device thread
    assert fwd["tid"] == threading.get_native_id() != back["tid"] == bwd["tid"]
    launches = _kernel_launches(events)
    inside = [c for c in launches if _holds(back, c)]
    assert inside and all(_holds(bwd, c) for c in inside)
    assert all(_holds(fwd, c) for c in launches if not _holds(back, c))
