"""The port's program tracing (``utils/profiling.enable``) stays off
through a ``--trace 0`` run of every cell: the dry run's timed path finds
it off at each SpMM call, and the program records nothing."""

import json

import pytest

from portbench import harness, spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_off_in_a_trace0_window(cell):
    from spmm_denseblock_tpu_torch.utils import profiling

    seen = []

    def watch(system):  # after set-up: every call of the window
        plan = system.plan

        def watched(h):
            seen.append(profiling.enabled())
            return plan(h)

        system.plan = watched

    profiling.take()
    hook = harness.Hook(patch=watch)
    argv = ["--workload", cell, "--seed", "7", "--seconds", "0.3", "--trace", "0"]
    assert harness.main(argv, hook=hook) == 0
    assert hook.result["correct"] is True
    assert seen and not any(seen)
    assert profiling.take() == {"spans": [], "counts": {}, "dropped": 0}
