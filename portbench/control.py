"""Readings that set the limits of ``correct`` (not run by the benchmark's
own runs):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --mode program
    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --mode control
    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --mode fault:<name>

``program``: the cell's timed path (the serve loop for ``--seconds``, or
the checked training steps) on each seed, the graph and plan built once
in the process; the lower readings. ``control``: the plain reference in
the program's place, in float32 with TF32 matmuls, the step below the
configuration's exact float32; it has to come out as not correct.
``fault:<name>``: the program with a fault of its kind's ``FAULTS``
(``portbench/faults.py``) planted. Prints one JSON line per seed with each number and its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import correct, graphgen, harness, spec  # noqa: E402


def readings(workload, seeds, mode, seconds=1.0, device="cuda", scale=1.0,
             root=spec.ROOT):
    """[(seed, {number: value}, correct)] for each seed."""
    import torch

    cell = spec.load_cell(workload, root)
    model = spec.model(cell.config["model"], root)
    kind = spec.kind(cell.mix["kind"], root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, edges = graphgen.load_edges(cell.config["graph"], scale)
    system = None
    if mode != "control":
        adapter = spec.system(cell.config["model"], root)
        system = adapter.System(cell.config, cell.mix, n, edges, device, 0.0)
        if mode.startswith("fault:"):
            kind.FAULTS[mode.split(":", 1)[1]](system)
    out_rows = []
    for seed in seeds:
        inputs = harness.make_inputs(cell.config, cell.mix, n, seed, device, model,
                                     kind)
        if mode == "control":
            ok, checks = correct.judge(kind.control(cell, model, inputs, edges, n),
                                       cell.mix["limits"])
        else:
            args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
            out = kind.run(cell, system, inputs, args, device, time.perf_counter(),
                           None)
            ok, _, checks = kind.check(cell, model, out, inputs, edges, n)
            del out
        out_rows.append((seed, {c["name"]: c["value"] for c in checks}, ok))
        if device == "cuda":
            torch.cuda.empty_cache()
    return out_rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    for seed, numbers, ok in readings(a.workload, seeds, a.mode, a.seconds):
        print(json.dumps({"workload": a.workload, "mode": a.mode, "seed": seed,
                          "correct": ok, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
